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
launches the kernel (csrc/grid_rans.cu) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .device_rans import freq_to_cdf, rans_decode_grid, rans_encode_grid

_ENC = "grid_rans_encode"
_DEC = "grid_rans_decode"


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
        lib.hesic_grid_rans_encode.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.hesic_grid_rans_decode.restype = ci
        lib.hesic_grid_rans_decode.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib._hesic_typed = True
    return lib


def _check_layout(s, hw, ppl):
    if ppl < 1 or hw % ppl:
        raise ValueError(f"ppl={ppl} must divide hw={hw}")
    if s < 2 or s > (1 << 16):
        raise ValueError(f"row length S={s} out of range")


def rans_encode_grid_cuda(freq, sym_mbl, ppl: int = 1, cap: int = None):
    """Kernel 2 on the card; same contract as rans_encode_grid_plain."""
    b, m, s, hw = freq.shape
    _check_layout(s, hw, ppl)
    ls = hw // ppl
    cap = default_cap(m, ppl) if cap is None else cap
    build.check_cuda_tensor(freq, "freq", torch.int32)
    build.check_cuda_tensor(sym_mbl, "sym", torch.int32, (m, b, hw))
    words = torch.empty((b, cap, ls), dtype=torch.int32, device=freq.device)
    counts = torch.empty((b, ls), dtype=torch.int32, device=freq.device)
    states = torch.empty((b, ls), dtype=torch.int64, device=freq.device)
    stream = torch.cuda.current_stream(freq.device).cuda_stream
    rc = _lib().hesic_grid_rans_encode(
        freq.data_ptr(), sym_mbl.data_ptr(), words.data_ptr(),
        counts.data_ptr(), states.data_ptr(), b, m, s, hw, ppl, cap, stream)
    build.check_status(rc, _ENC)
    build.launch_counts[_ENC] += 1
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
    syms = torch.empty((m, b, hw), dtype=torch.int32, device=freq.device)
    stream = torch.cuda.current_stream(freq.device).cuda_stream
    rc = _lib().hesic_grid_rans_decode(
        freq.data_ptr(), words.data_ptr(), counts.data_ptr(),
        states.data_ptr(), syms.data_ptr(), b, m, s, hw, ppl, cap, stream)
    build.check_status(rc, _DEC)
    build.launch_counts[_DEC] += 1
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
