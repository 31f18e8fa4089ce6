"""Slot-stream rANS encode of precomputed (start, freq) intervals: CUDA
kernel 4 and its plain PyTorch twin.

Counterpart of hesic_tpu/codecs/pallas_rans.py (rans_encode_pairs_pallas):
the encoder of the wavefront autoregressive codec, whose teacher pass
emits one interval per (slot, lane).

  starts, freqs  (T, L) int32  intervals (u32 values)
  valid          (T, L) bool   False slots are skipped
  -> words (L, cap) int32 [u16 values, emission order; entries past a
     lane's count are unspecified], counts (L,) int32, states (L,) int64
     [u32 values]

``cap`` is a word budget per lane: words past it are not written, but
``counts`` still reports the true count, and the caller retries with a
larger cap.  The plain twin is the port's lockstep grid coder
(device_rans.rans_encode_grid) fitted to ``cap``; the kernel
(csrc/pairs_rans.cu) is bit-equal to it in words within counts, counts
and states.  ``rans_encode_pairs`` dispatches on the device of its input:
a CPU tensor runs the twin, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .device_rans import rans_encode_grid

_NAME = "pairs_rans_encode"


def rans_encode_pairs_plain(starts, freqs, valid, cap: int):
    """Plain twin of kernel 4."""
    # skipped slots never divide; their freq may be 0 (as the TPU
    # kernel's f_safe, clamp so the lockstep twin's division is defined)
    buf, counts, states = rans_encode_grid(
        starts, torch.clamp_min(freqs, 1), valid)
    if cap <= buf.shape[1]:
        words = buf[:, :cap]
    else:
        words = torch.nn.functional.pad(buf, (0, cap - buf.shape[1]))
    return words.contiguous(), counts, states


def _lib():
    lib = build.load("pairs_rans")
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_pairs_rans_encode.restype = ci
        lib.hesic_pairs_rans_encode.argtypes = [vp] * 6 + [ci] * 3 + [vp]
        lib._hesic_typed = True
    return lib


def rans_encode_pairs_cuda(starts, freqs, valid, cap: int):
    """Kernel 4 on the card; same contract as rans_encode_pairs_plain."""
    t_dim, lanes = starts.shape
    if cap < 1:
        raise ValueError(f"cap={cap} must be >= 1")
    build.check_cuda_tensor(starts, "starts", torch.int32)
    build.check_cuda_tensor(freqs, "freqs", torch.int32, (t_dim, lanes))
    build.check_cuda_tensor(valid, "valid", torch.bool, (t_dim, lanes))
    dev = starts.device
    words = torch.empty((lanes, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((lanes,), dtype=torch.int32, device=dev)
    states = torch.empty((lanes,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().hesic_pairs_rans_encode(
        starts.data_ptr(), freqs.data_ptr(), valid.data_ptr(),
        words.data_ptr(), counts.data_ptr(), states.data_ptr(), t_dim,
        lanes, cap, stream)
    build.check_status(rc, _NAME)
    build.launch_counts[_NAME] += 1
    return words, counts, states


def rans_encode_pairs(starts, freqs, valid, cap: int):
    """Encode: the kernel for CUDA tensors, the plain twin on the CPU."""
    if starts.is_cuda:
        return rans_encode_pairs_cuda(starts, freqs, valid, cap)
    return rans_encode_pairs_plain(starts, freqs, valid, cap)
