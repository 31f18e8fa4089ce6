"""Interleaved-lane rANS over a (T, L) grid, in plain PyTorch, plus the
container packing of its streams.

Counterpart of hesic_tpu/codecs/device_rans.py.  Coder: rANS with 32-bit
state, 16-bit probability resolution and u16 word renormalization; state
invariant x in [2^16, 2^32), at most one word per symbol.  Each of the L
lanes encodes its T slots in reverse and the decoder replays them forward,
reading its word stream backward.

The interleaved coder of a flat symbol sequence (symbol i on lane i % L,
slot i // L): ``rans_encode_interleaved`` and ``rans_decode_interleaved``
run kernels 2 and 3 (codecs/grid_rans.py) on CUDA tensors and these twins
on CPU tensors; ``quantize_pmf_device``, ``grid_from_flat``,
``gather_intervals`` and ``intervals_from_freq`` are their plain helpers,
on the device of their input.

The state lives in int64: PyTorch's CPU uint32 lacks ``>>``, ``//`` and
``>=``, and every intermediate of the transition fits 33 bits.  These
loops are the plain twins of the CUDA kernels (codecs/grid_rans.py); they
run one PyTorch operator per element-wise step, so they are slow on the
card and serve the CPU and the comparisons.

Stream format (per tensor): u16 L | delta-coded per-lane word counts |
u32 final states[L] | concatenated per-lane u16 words, lane-major.
"""

from __future__ import annotations

import numpy as np
import torch

PROB_BITS = 16
RANS_L = 1 << 16
TOTAL = 1 << PROB_BITS
_U16 = 0xFFFF


def freq_to_cdf(freq: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Frequency rows -> CDF rows with a leading zero along `dim`."""
    c = torch.cumsum(freq, dim=dim, dtype=freq.dtype)
    zshape = list(c.shape)
    zshape[dim] = 1
    return torch.cat([torch.zeros(zshape, dtype=c.dtype, device=c.device),
                      c], dim=dim)


def quantize_pmf_device(pmf: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Float PMF rows (need not be normalized, the symbol axis at `dim`)
    -> int32 frequency rows summing to 2^16 with every bin >= 1: floor of
    the scaled PMF, clamped to 1, the deficit added to the first largest
    bin.  The total sums the bins in ascending order, so the rows do not
    depend on the device; XLA:CPU sums rows longer than 17 bins in
    another order, which can move a bin by a count where the scaled PMF
    sits at an integer."""
    pmf = torch.clamp_min(pmf.float(), 0.0)
    dim = dim % pmf.ndim
    total = pmf.narrow(dim, 0, 1)
    for k in range(1, pmf.shape[dim]):
        total = total + pmf.narrow(dim, k, 1)
    ideal = pmf / torch.clamp_min(total, 1e-30) * TOTAL
    freq = torch.clamp_min(torch.floor(ideal), 1).to(torch.int32)
    deficit = (TOTAL - freq.sum(dim=dim, keepdim=True)).to(torch.int32)
    return freq.scatter_add(dim, torch.argmax(freq, dim=dim, keepdim=True),
                            deficit)


def compact_words(words_t: torch.Tensor, need_t: torch.Tensor):
    """Per-step emissions (T, L) -> per-lane buffers (L, T+2) in emission
    order (decreasing t), plus per-lane counts."""
    t_steps, lanes = words_t.shape
    need_i = need_t.to(torch.int64)
    counts = need_i.sum(dim=0)
    pos = counts[None, :] - torch.cumsum(need_i, dim=0)
    buf = torch.zeros((lanes, t_steps + 2), dtype=torch.int32,
                      device=words_t.device)
    ti, li = need_t.nonzero(as_tuple=True)
    buf[li, pos[ti, li]] = words_t[ti, li].to(torch.int32)
    return buf, counts.to(torch.int32)


def rans_encode_grid(starts, freqs, valid):
    """Encode a (T, L) grid of intervals; all L lanes advance in lockstep.

    starts/freqs: (T, L) integer tensors; valid: (T, L) bool (False slots
    skipped).  Returns (words (L, T+2) int32 [u16 values], counts (L,)
    int32, states (L,) int64 [u32 values])."""
    t_steps, lanes = starts.shape
    x = torch.full((lanes,), RANS_L, dtype=torch.int64, device=starts.device)
    words_t = torch.empty((t_steps, lanes), dtype=torch.int64,
                          device=starts.device)
    need_t = torch.empty((t_steps, lanes), dtype=torch.bool,
                         device=starts.device)
    for t in reversed(range(t_steps)):
        s = starts[t].to(torch.int64)
        f = freqs[t].to(torch.int64)
        v = valid[t]
        need = v & (x >= (f << PROB_BITS))
        words_t[t] = x & _U16
        need_t[t] = need
        x = torch.where(need, x >> PROB_BITS, x)
        q = x // f
        r = x - q * f
        x = torch.where(v, (q << PROB_BITS) + r + s, x)
    buf, counts = compact_words(words_t, need_t)
    return buf, counts, x


def rans_decode_grid(words, counts, states, rows, valid):
    """Decode a (T, L) grid from per-lane word buffers.

    words: (L, C) u16 values; counts/states: (L,); rows: (T, S+1, L) CDF
    rows; valid: (T, L).  Returns symbols (T, L) int32.  A word read past
    the buffer clamps to its last column (never hit by a valid stream)."""
    t_steps, lanes = valid.shape
    cap = words.shape[1]
    lane_ids = torch.arange(lanes, device=words.device)
    words = words.to(torch.int64)
    x = states.to(torch.int64)
    p = counts.to(torch.int64)
    syms = torch.empty((t_steps, lanes), dtype=torch.int32,
                       device=words.device)
    for t in range(t_steps):
        row = rows[t].to(torch.int64)
        v = valid[t]
        cf = x & _U16
        le = row <= cf[None, :]
        sym = le[1:].sum(dim=0)
        start = (row * le).amax(dim=0)
        nxt = torch.where(le, TOTAL, row).amin(dim=0)
        x_new = (nxt - start) * (x >> PROB_BITS) + cf - start
        need = v & (x_new < RANS_L)
        p_read = torch.clamp(p - 1, 0, cap - 1)
        word = words[lane_ids, p_read]
        x_new = torch.where(need, (x_new << PROB_BITS) | word, x_new)
        p = torch.where(need, p - 1, p)
        x = torch.where(v, x_new, x)
        syms[t] = torch.where(v, sym, 0).to(torch.int32)
    return syms


def grid_from_flat(arr: torch.Tensor, lanes: int, fill):
    """(n,) -> ((T, L), valid (T, L) bool), T = ceil(n / L): element i at
    slot i // L of lane i % L, the padding slots `fill` and invalid."""
    n = arr.shape[0]
    t_steps = -(-n // lanes)
    pad = torch.full((t_steps * lanes - n,), fill, dtype=arr.dtype,
                     device=arr.device)
    valid = torch.arange(t_steps * lanes, device=arr.device) < n
    return (torch.cat([arr, pad]).reshape(t_steps, lanes),
            valid.reshape(t_steps, lanes))


def rans_encode_interleaved(starts: torch.Tensor, freqs: torch.Tensor,
                            lanes: int):
    """Encode n symbols given their (start, freq) intervals ((n,) integer
    tensors, freq >= 1, start + freq <= 2^16) on L = `lanes` interleaved
    lanes.  Returns (words (L, T+2) int32 [u16 values, emission order,
    zero past each lane's count], counts (L,) int32, states (L,) int64
    [u32 values]), T = ceil(n / L).  On CUDA tensors kernel 2 codes each
    interval as symbol 1 of the row (start, freq, 2^16 - start - freq):
    once for the lanes that hold T symbols and once for those that hold
    T - 1, as a launch has no invalid slots."""
    if starts.is_cuda:
        from .grid_rans import encode_intervals_cuda
        return encode_intervals_cuda(starts, freqs, lanes)
    s_grid, valid = grid_from_flat(starts.to(torch.int64), lanes, 0)
    f_grid, _ = grid_from_flat(freqs.to(torch.int64), lanes, 1)
    return rans_encode_grid(s_grid, f_grid, valid)


def rans_decode_interleaved(words, counts, states, cdf_rows, n: int,
                            lanes: int) -> torch.Tensor:
    """Decode n symbols of rans_encode_interleaved's streams: words (L, C)
    u16 values, counts (L,), states (L,) u32 values, cdf_rows (>= n, S+1)
    integer CDF rows ending at 2^16 (row i is symbol i's).  Returns (n,)
    int32.  On CUDA tensors kernel 3 decodes the (T, L) grid, row i's
    frequencies at slot i // L of lane i % L; a padding slot decodes
    after every symbol of its lane, so its output is dropped."""
    t_steps = -(-n // lanes)
    rows = cdf_rows[:n]
    rows = torch.cat([rows, rows[:1].expand(t_steps * lanes - n, -1)])
    if cdf_rows.is_cuda:
        from .grid_rans import decode_rows_cuda
        return decode_rows_cuda(words, counts, states, rows,
                                lanes).reshape(-1)[:n]
    valid = (torch.arange(t_steps * lanes, device=rows.device)
             < n).reshape(t_steps, lanes)
    grid = rows.reshape(t_steps, lanes, -1).permute(0, 2, 1)
    return rans_decode_grid(words, counts, states, grid,
                            valid).reshape(-1)[:n]


def gather_intervals(cdf_rows: torch.Tensor, symbols: torch.Tensor):
    """Per-symbol (start, freq) from CDF rows (n, S+1) and symbols (n,) in
    [0, S): a gather."""
    sym = symbols.to(torch.int64)[:, None]
    start = torch.gather(cdf_rows, 1, sym)[:, 0]
    return start, torch.gather(cdf_rows, 1, sym + 1)[:, 0] - start


def intervals_from_freq(freq: torch.Tensor, symbols: torch.Tensor):
    """Per-symbol (start, freq) from frequency rows (..., S) and symbols
    (...,): start is the sum of the frequencies below the symbol."""
    iota = torch.arange(freq.shape[-1], device=freq.device)
    sym = symbols[..., None]
    return ((freq * (iota < sym)).sum(dim=-1, dtype=freq.dtype),
            (freq * (iota == sym)).sum(dim=-1, dtype=freq.dtype))


# ---------------------------------------------------------------------------
# container packing (host, numpy)
# ---------------------------------------------------------------------------

def pack_counts(counts) -> bytes:
    """Per-lane word counts, delta-coded: u8 mode | mode 1: u16 base + u8
    deltas[L] | mode 0 fallback: u16 counts[L]."""
    counts = np.asarray(counts, np.int64)
    base = int(counts.min())
    if counts.size and int(counts.max()) - base < 256 and base <= 0xFFFF:
        return (b"\x01" + np.uint16(base).tobytes()
                + (counts - base).astype(np.uint8).tobytes())
    return b"\x00" + counts.astype(np.uint16).tobytes()


def unpack_counts(blob: bytes, offset: int, lanes: int):
    mode = blob[offset]
    offset += 1
    if mode == 1:
        base = int(np.frombuffer(blob, np.uint16, 1, offset)[0])
        offset += 2
        counts = base + np.frombuffer(blob, np.uint8, lanes,
                                      offset).astype(np.int32)
        offset += lanes
    else:
        counts = np.frombuffer(blob, np.uint16, lanes,
                               offset).astype(np.int32)
        offset += 2 * lanes
    return counts, offset


def pack_stream_dense(flat, counts, states) -> bytes:
    """Serialize one stream from its exact-dense payload (each lane's
    words in lane order)."""
    counts = np.asarray(counts, np.int64)
    states = np.asarray(states, np.uint32)
    total = int(counts.sum())
    payload = np.asarray(flat[:total], np.uint16).tobytes()
    return (np.uint16(counts.shape[0]).tobytes() + pack_counts(counts)
            + states.tobytes() + payload)


def pack_stream(words, counts, states) -> bytes:
    """Serialize one stream from its padded word buffer (L, C): each
    lane's first count words, lane-major; the inverse of
    unpack_stream."""
    words = np.asarray(words)
    counts = np.asarray(counts, np.int64)
    keep = np.arange(words.shape[1])[None, :] < counts[:, None]
    return pack_stream_dense(words[keep], counts, states)


def unpack_stream_dense(blob: bytes, offset: int = 0):
    """Inverse of pack_stream_dense, without padding.  Returns (flat u16
    words in lane order, counts, states, next_offset)."""
    lanes = int(np.frombuffer(blob, np.uint16, 1, offset)[0])
    offset += 2
    counts, offset = unpack_counts(blob, offset, lanes)
    states = np.frombuffer(blob, np.uint32, lanes, offset).copy()
    offset += 4 * lanes
    total = int(counts.sum())
    flat = np.frombuffer(blob, np.uint16, total, offset)
    return flat, counts, states, offset + 2 * total


def unpack_stream(blob: bytes, offset: int = 0):
    """Inverse of pack_stream (and of pack_stream_dense).  Returns (words
    (L, C) int32, counts, states, next_offset); words padded to the
    longest lane."""
    flat, counts, states, offset = unpack_stream_dense(blob, offset)
    cap = max(int(counts.max()), 1)
    words = np.zeros((counts.shape[0], cap), np.int32)
    words[np.arange(cap) < counts[:, None]] = flat
    return words, counts, states, offset
