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
``counts`` still reports the true count.  A valid slot emits at most one
word, so ``cap = T`` holds every word.  The plain twin is the port's
lockstep grid coder (device_rans.rans_encode_grid) fitted to ``cap``;
the kernel (csrc/pairs_rans.cu) is bit-equal to it in words within
counts, counts and states.  ``rans_encode_pairs`` dispatches on the
device of its input: a CPU tensor runs the twin, a CUDA tensor launches
the kernel or raises.  ``pairs_plan`` picks each launch's shared-memory
ring and helper warps from the shape and the card's SM count; a stage
holds SLOTS slots, fixed in the kernel.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build
from .build import LANE_GROUP, SM_COUNT, SMEM_BLOCK, SMEM_SM, WARPS_SM
from .device_rans import rans_encode_grid

_NAME = "pairs_rans_encode"

SLOTS = 16              # slots a ring stage holds (the kernel's K)
HELPERS = 4             # staging warps per block, beside the chain warp
MAX_STAGES = 16         # ring depth D, in stages
MAX_AHEAD = 3           # own stages each helper keeps loading ahead
VALID_WORDS = 3         # int32 staged around a slot's 8 valid bytes

# int32 per ring stage: the chain's (x_max - 1, 1/f, f, start) entries,
# the staged starts, freqs and valid words, and each lane's word count
# before and after the stage
STAGE_INTS = SLOTS * (6 * LANE_GROUP + VALID_WORDS) + 2 * LANE_GROUP

PairsPlan = collections.namedtuple(
    "PairsPlan", "lg d helpers ahead vec ring blocks threads smem")


def pairs_plan(t_dim: int, lanes: int,
               sm_count: int = SM_COUNT) -> PairsPlan:
    """The launch plan of kernel 4 for (T, L).

    LG = LANE_GROUP consecutive lanes per block, ceil(L / LG) blocks of
    H helper warps and one chain warp (H = HELPERS, fewer when the blocks
    each of the card's ``sm_count`` SMs must hold would exceed its
    warps).  Stages of K = SLOTS slots; a ring of D stages (even, at
    most MAX_STAGES and no more than the walk's ceil(T / K) stages need,
    at least 2H), the deepest with which the blocks that share an SM fit
    its shared memory; each helper keeps ``ahead`` = min(MAX_AHEAD, D/H -
    1) of its own stages loading.  Each lane's word ring holds R, the
    power of two >= D*K + 4, words.  Copies of 16 bytes when L is a
    multiple of 4 (every row segment is then 16-byte aligned), else of
    4.  A plan whose shared memory exceeds SMEM_BLOCK is refused by the
    kernel's entry point.
    """
    lg, k = LANE_GROUP, SLOTS
    blocks = -(-lanes // lg)
    per_sm = -(-blocks // sm_count)
    h = max(1, min(HELPERS, WARPS_SM // per_sm - 1))
    stages = 2 * -(-t_dim // (2 * k))           # ceil(T / K), made even
    d_top = max(2 * h, min(MAX_STAGES, stages))
    for d in range(d_top, 2 * h - 1, -2):
        ring = 1 << (d * k + 4 - 1).bit_length()
        smem = d * (24 + 4 * STAGE_INTS) + 4 * lg * (ring + 4)
        if smem <= SMEM_BLOCK and per_sm * (smem + 1024) <= SMEM_SM:
            break
    ahead = max(1, min(MAX_AHEAD, d // h - 1))
    vec = 4 if lanes % 4 == 0 else 1
    return PairsPlan(lg, d, h, ahead, vec, ring, blocks, 32 * (h + 1), smem)


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
        lib.hesic_pairs_rans_encode.argtypes = [vp] * 6 + [ci] * 9 + [vp]
        lib._hesic_typed = True
    return lib


def launch_plan(starts, freqs) -> PairsPlan:
    """pairs_plan for the shape of `starts` on its card, with 4-byte
    copies unless starts and freqs start 16-byte aligned."""
    t_dim, lanes = starts.shape
    sms = torch.cuda.get_device_properties(
        starts.device).multi_processor_count
    plan = pairs_plan(t_dim, lanes, sms)
    if starts.data_ptr() % 16 or freqs.data_ptr() % 16:
        plan = plan._replace(vec=1)
    return plan


def rans_encode_pairs_cuda(starts, freqs, valid, cap: int):
    """Kernel 4 on the card; same contract as rans_encode_pairs_plain."""
    if cap < 1:
        raise ValueError(f"cap={cap} must be >= 1")
    build.check_cuda_tensor(starts, "starts", torch.int32)
    shape = tuple(starts.shape)
    build.check_cuda_tensor(freqs, "freqs", torch.int32, shape)
    build.check_cuda_tensor(valid, "valid", torch.bool, shape)
    if valid.data_ptr() % 4:
        raise ValueError("valid must start 4-byte aligned")
    plan = launch_plan(starts, freqs)
    t_dim, lanes = shape
    dev = starts.device
    words = torch.empty((lanes, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((lanes,), dtype=torch.int32, device=dev)
    states = torch.empty((lanes,), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().hesic_pairs_rans_encode(
        starts.data_ptr(), freqs.data_ptr(), valid.data_ptr(),
        words.data_ptr(), counts.data_ptr(), states.data_ptr(), t_dim,
        lanes, cap, plan.d, plan.helpers, plan.ahead, plan.vec, plan.ring,
        plan.smem, stream)
    build.check_status(rc, _NAME, (
        f"T={t_dim}, L={lanes}, cap={cap}, D={plan.d}, H={plan.helpers}, "
        f"ahead={plan.ahead}, R={plan.ring}: D even and >= (ahead + 1) * "
        f"H, H <= 15, R a power of two >= D*{SLOTS} + 4, {plan.smem} bytes "
        f"of shared memory within {SMEM_BLOCK}"))
    build.count_launch(_NAME)
    return words, counts, states


def rans_encode_pairs(starts, freqs, valid, cap: int):
    """Encode: the kernel for CUDA tensors, the plain twin on the CPU."""
    if starts.is_cuda:
        return rans_encode_pairs_cuda(starts, freqs, valid, cap)
    return rans_encode_pairs_plain(starts, freqs, valid, cap)
