"""Grid rANS encode/decode over frequency rows: CUDA kernels 2 and 3 and
their plain PyTorch twins.

Counterpart of hesic_tpu/codecs/pallas_rans.py (rans_encode_grid_pallas,
rans_decode_grid_pallas).  Layout contract (as hesic_tpu_torch's fast
codec uses it):

  freq   (B, M, S, hw) int32  quantized frequency rows, positions minor
  sym    (M, B, hw)    int32  grid symbols in [0, S)
  words  (B, CAP, ls)  int32  per-lane u16 words in emission order
  counts (B, ls) int32, states (B, ls) int64 (u32 values), ls = hw // ppl

Lane l of pair b codes positions j*ls + l for j = 0..ppl-1 as micro-steps
of each channel step.  With ppl > 1, ``cap`` is a word budget: counts
beyond it mean the words were truncated and the caller retries with a
larger cap.

``rans_encode_grid_rows``/``rans_decode_grid_rows`` dispatch on the
device of their input: a CPU tensor runs the plain twin, a CUDA tensor
launches the kernel (csrc/grid_rans.cu) or raises.  ``encode_intervals_cuda``
and ``decode_rows_cuda`` run the interleaved coder of device_rans
(``rans_encode_interleaved``/``rans_decode_interleaved``) through the
same kernels.  ``rans_plan`` picks
each launch's lane groups, shared-memory ring and search from the
layout and the card's SM count.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build
from .build import LANE_GROUP, SM_COUNT, SMEM_BLOCK, SMEM_SM, WARPS_SM
from .device_rans import (RANS_L, TOTAL, freq_to_cdf, rans_decode_grid,
                          rans_encode_grid)

_ENC = "grid_rans_encode"
_DEC = "grid_rans_decode"

HELPER_WARPS = 8        # staging warps per block, beside the chain warp
MAX_STAGES = 32         # ring depth D, in steps
MAX_AHEAD = 4           # own steps each helper keeps loading ahead
SPLIT_ENTRIES = (4, 8, 16)      # CDF entries per thread the kernel takes
# the widest rows the decoder searches by split count: on the H100 it beat
# the binary search at mm 4-16 (S <= 33) and lost at mm 32 (PERF.md)
SPLIT_MAX_S = 33
WORD_RING_BYTES = 4 * 32 * 32   # the decoder's per-thread word slots

RansPlan = collections.namedtuple(
    "RansPlan", "lg d helpers ahead vec search blocks threads smem")


def stage_ints(s: int, lg: int, encode: bool) -> int:
    """int32 per ring stage: S rows of LG lanes, then the LG symbols; the
    encoder's also hold LG (start, f, 1/f) intervals."""
    return (s + 4) * lg if encode else (s + 1) * lg


def split_entries(s: int) -> int:
    """CDF entries per thread of the split search (a lane's first S-1
    entries over its 4 threads; the helpers' segments are one row longer),
    0 when S is too wide for it (the kernels then loop)."""
    return next((n for n in SPLIT_ENTRIES if 4 * n >= s - 1), 0)


def rans_plan(b: int, s: int, hw: int, ppl: int, encode: bool = False,
              sm_count: int = SM_COUNT) -> RansPlan:
    """The launch plan of kernel 2 (``encode``) or 3 for (B, S, hw, ppl).

    LG = LANE_GROUP lanes of one pair per block (each staged row segment
    is one 32-byte sector), B * ceil(ls / LG) blocks of H helper warps
    and one chain warp (H = HELPER_WARPS, fewer when the blocks each of
    the card's ``sm_count`` SMs must hold would exceed its warps).  A
    ring of D stages (even, <= MAX_STAGES), the deepest with which the
    blocks that share an SM fit its shared memory (at least 2H); each
    helper keeps ``ahead`` =
    min(MAX_AHEAD, D/H - 1) of its own steps loading.  Copies of 16
    bytes when every row segment is 16-byte aligned (hw and ls multiples
    of 4), else of 4.  The decoder's search: ``split`` (4 threads a
    lane, each counting its CDF entries held in registers) up to S =
    SPLIT_MAX_S, else ``binary``.  A plan whose ring exceeds SMEM_BLOCK
    is refused by the kernel's entry point.
    """
    ls = hw // ppl
    lg = LANE_GROUP
    blocks = b * -(-ls // lg)
    per_sm = -(-blocks // sm_count)
    stage = 4 * stage_ints(s, lg, encode) + 24       # + three mbarriers
    extra = 0 if encode else WORD_RING_BYTES
    h = max(2, min(HELPER_WARPS, WARPS_SM // per_sm - 1))
    for d in range(MAX_STAGES, 2 * h - 1, -2):
        smem = d * stage + extra
        if smem <= SMEM_BLOCK and per_sm * (smem + 1024) <= SMEM_SM:
            break
    ahead = max(1, min(MAX_AHEAD, d // h - 1))
    search = "split" if s <= SPLIT_MAX_S else "binary"
    vec = 4 if hw % 4 == 0 and ls % 4 == 0 else 1
    return RansPlan(lg, d, h, ahead, vec, search, blocks, 32 * (h + 1),
                    smem)


def default_cap(m: int, ppl: int) -> int:
    """The guaranteed per-lane word bound: one word per micro-step + 2."""
    return m * ppl + 2


def _grid_layout(t: torch.Tensor, ppl: int) -> torch.Tensor:
    """(B, M, hw) -> (M*ppl, B*ls): slot (m, j), lane (b, l)."""
    b, m, hw = t.shape
    ls = hw // ppl
    return t.reshape(b, m, ppl, ls).permute(1, 2, 0, 3).reshape(
        m * ppl, b * ls)


def rans_encode_grid_plain(freq, sym_mbl, ppl: int = 1, cap: int = None):
    """Plain twin of kernel 2: masked-sum intervals + the lockstep grid
    coder of device_rans, words fitted to ``cap`` (truncated past it)."""
    b, m, s, hw = freq.shape
    ls = hw // ppl
    cap = default_cap(m, ppl) if cap is None else cap
    sym = sym_mbl.permute(1, 0, 2).reshape(b, m, 1, hw).to(torch.int64)
    iota = torch.arange(s, device=freq.device).view(1, 1, s, 1)
    start = (freq * (iota < sym)).sum(dim=2)
    frs = torch.gather(freq, 2, sym).squeeze(2)
    valid = torch.ones((m * ppl, b * ls), dtype=torch.bool,
                       device=freq.device)
    buf, counts, states = rans_encode_grid(
        _grid_layout(start, ppl), _grid_layout(frs, ppl), valid)
    words = buf.reshape(b, ls, -1).permute(0, 2, 1)
    if cap <= words.shape[1]:
        words = words[:, :cap]
    else:
        words = torch.nn.functional.pad(words,
                                        (0, 0, 0, cap - words.shape[1]))
    return (words.contiguous(), counts.reshape(b, ls),
            states.reshape(b, ls))


def rans_decode_grid_plain(freq, words, counts, states, ppl: int = 1):
    """Plain twin of kernel 3: CDF rows + the lockstep grid decoder of
    device_rans.  Returns syms (M, B, hw) int32."""
    b, m, s, hw = freq.shape
    ls = hw // ppl
    cap = words.shape[1]
    rows = freq_to_cdf(freq, dim=2).reshape(b, m, s + 1, ppl, ls)
    rows = rows.permute(1, 3, 2, 0, 4).reshape(m * ppl, s + 1, b * ls)
    valid = torch.ones((m * ppl, b * ls), dtype=torch.bool,
                       device=freq.device)
    syms = rans_decode_grid(
        words.permute(0, 2, 1).reshape(b * ls, cap), counts.reshape(-1),
        states.reshape(-1), rows, valid)
    return syms.reshape(m, ppl, b, ls).permute(0, 2, 1, 3).reshape(m, b, hw)


def _lib():
    lib = build.load("grid_rans")
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_grid_rans_encode.restype = ci
        lib.hesic_grid_rans_encode.argtypes = [vp] * 5 + [ci] * 12 + [vp]
        lib.hesic_grid_rans_decode.restype = ci
        lib.hesic_grid_rans_decode.argtypes = [vp] * 5 + [ci] * 13 + [vp]
        lib._hesic_typed = True
    return lib


def _check_layout(s, hw, ppl):
    if ppl < 1 or hw % ppl:
        raise ValueError(f"ppl={ppl} must divide hw={hw}")
    if s < 2 or s > (1 << 16):
        raise ValueError(f"row length S={s} out of range")


def _launch_plan(ppl: int, encode: bool, *staged) -> RansPlan:
    """rans_plan for the layout of staged[0] (freq) on its card, with
    4-byte copies unless every staged tensor starts 16-byte aligned."""
    b, _, s, hw = staged[0].shape
    sms = torch.cuda.get_device_properties(
        staged[0].device).multi_processor_count
    plan = rans_plan(b, s, hw, ppl, encode, sms)
    if any(t.data_ptr() % 16 for t in staged):
        plan = plan._replace(vec=1)
    return plan


def _limits(plan: RansPlan, s: int) -> str:
    return (f"S={s}, D={plan.d}, H={plan.helpers}, ahead={plan.ahead}: "
            f"the ring's {plan.smem} bytes must fit {SMEM_BLOCK}, S >= 2, "
            f"D >= (ahead + 1) * H, H <= 15")


def rans_encode_grid_cuda(freq, sym_mbl, ppl: int = 1, cap: int = None):
    """Kernel 2 on the card; same contract as rans_encode_grid_plain."""
    b, m, s, hw = freq.shape
    _check_layout(s, hw, ppl)
    ls = hw // ppl
    cap = default_cap(m, ppl) if cap is None else cap
    build.check_cuda_tensor(freq, "freq", torch.int32)
    build.check_cuda_tensor(sym_mbl, "sym", torch.int32, (m, b, hw))
    plan = _launch_plan(ppl, True, freq, sym_mbl)
    words = torch.empty((b, cap, ls), dtype=torch.int32, device=freq.device)
    counts = torch.empty((b, ls), dtype=torch.int32, device=freq.device)
    states = torch.empty((b, ls), dtype=torch.int64, device=freq.device)
    stream = torch.cuda.current_stream(freq.device).cuda_stream
    rc = _lib().hesic_grid_rans_encode(
        freq.data_ptr(), sym_mbl.data_ptr(), words.data_ptr(),
        counts.data_ptr(), states.data_ptr(), b, m, s, hw, ppl, cap,
        plan.d, plan.helpers, plan.ahead, plan.vec, split_entries(s),
        plan.smem, stream)
    build.check_status(rc, _ENC, _limits(plan, s))
    build.count_launch(_ENC)
    return words, counts, states


def rans_decode_grid_cuda(freq, words, counts, states, ppl: int = 1):
    """Kernel 3 on the card; same contract as rans_decode_grid_plain."""
    b, m, s, hw = freq.shape
    _check_layout(s, hw, ppl)
    ls = hw // ppl
    cap = words.shape[1]
    build.check_cuda_tensor(freq, "freq", torch.int32)
    build.check_cuda_tensor(words, "words", torch.int32, (b, cap, ls))
    build.check_cuda_tensor(counts, "counts", torch.int32, (b, ls))
    build.check_cuda_tensor(states, "states", torch.int64, (b, ls))
    if cap < 1:
        raise ValueError("words must hold at least one column")
    syms = _launch_decode(_launch_plan(ppl, False, freq), freq, words,
                         counts, states, ppl)
    build.count_launch(_DEC)
    return syms


def _launch_decode(plan: RansPlan, freq, words, counts, states, ppl: int):
    """Kernel 3 under `plan` on checked arguments; counts no launch."""
    b, m, s, hw = freq.shape
    syms = torch.empty((m, b, hw), dtype=torch.int32, device=freq.device)
    stream = torch.cuda.current_stream(freq.device).cuda_stream
    rc = _lib().hesic_grid_rans_decode(
        freq.data_ptr(), words.data_ptr(), counts.data_ptr(),
        states.data_ptr(), syms.data_ptr(), b, m, s, hw, ppl,
        words.shape[1], plan.d, plan.helpers, plan.ahead, plan.vec,
        split_entries(s), int(plan.search == "split"), plan.smem, stream)
    build.check_status(rc, _DEC, _limits(plan, s))
    return syms


def rans_encode_grid_rows(freq, sym_mbl, ppl: int = 1, cap: int = None):
    """Encode: the kernel for CUDA tensors, the plain twin on the CPU."""
    if freq.is_cuda:
        return rans_encode_grid_cuda(freq, sym_mbl, ppl, cap)
    return rans_encode_grid_plain(freq, sym_mbl, ppl, cap)


def rans_decode_grid_rows(freq, words, counts, states, ppl: int = 1):
    """Decode: the kernel for CUDA tensors, the plain twin on the CPU."""
    if freq.is_cuda:
        return rans_decode_grid_cuda(freq, words, counts, states, ppl)
    return rans_decode_grid_plain(freq, words, counts, states, ppl)


def encode_intervals_cuda(starts, freqs, lanes: int):
    """device_rans.rans_encode_interleaved on the card: kernel 2 codes the
    (T, L) grid of the n intervals, each as symbol 1 of the row (start,
    freq, 2^16 - start - freq), in one launch for the lanes that hold T
    symbols and one for those that hold T - 1 (a launch codes every slot
    of its lanes).  Same contract as the twin: (words (L, T+2) int32, zero
    past each lane's count, counts (L,) int32, states (L,) int64)."""
    n = starts.shape[0]
    dev = starts.device
    t_steps = -(-n // lanes)
    pad = t_steps * lanes - n
    s = torch.cat([starts.to(torch.int32),
                   starts.new_zeros(pad, dtype=torch.int32)])
    f = torch.cat([freqs.to(torch.int32),
                   freqs.new_ones(pad, dtype=torch.int32)])
    rows = torch.stack([s, f, TOTAL - s - f], 1).reshape(t_steps, lanes, 3)
    words = torch.zeros((lanes, t_steps + 2), dtype=torch.int32, device=dev)
    counts = torch.zeros(lanes, dtype=torch.int32, device=dev)
    states = torch.full((lanes,), RANS_L, dtype=torch.int64, device=dev)
    full = n - (t_steps - 1) * lanes        # lanes that hold T symbols
    for lo, hi, t in ((0, full, t_steps), (full, lanes, t_steps - 1)):
        if hi == lo or t == 0:
            continue
        freq = rows[:t, lo:hi].permute(0, 2, 1)[None].contiguous()
        sym = torch.ones((t, 1, hi - lo), dtype=torch.int32, device=dev)
        w, c, st = rans_encode_grid_cuda(freq, sym, 1, t_steps + 2)
        words[lo:hi] = w[0].t()
        counts[lo:hi] = c[0]
        states[lo:hi] = st[0]
    keep = (torch.arange(t_steps + 2, device=dev)[None, :]
            < counts[:, None])
    return torch.where(keep, words, 0), counts, states


def decode_rows_cuda(words, counts, states, rows, lanes: int):
    """device_rans.rans_decode_interleaved's grid on the card: kernel 3
    over `rows` (T*L, S+1) CDF rows, row t*L + l at slot t of lane l;
    words (L, C), counts (L,), states (L,).  Returns the (T*L,) int32
    symbols, every slot decoded."""
    t_steps = rows.shape[0] // lanes
    freq = torch.diff(rows.to(torch.int32), dim=1).reshape(
        t_steps, lanes, -1).permute(0, 2, 1)[None].contiguous()
    syms = rans_decode_grid_cuda(
        freq, words.to(torch.int32).t()[None].contiguous(),
        counts.to(torch.int32).reshape(1, lanes),
        states.to(torch.int64).reshape(1, lanes))
    return syms.reshape(-1)
