"""GMM heads -> quantized frequency rows: CUDA kernel 1 and its plain
PyTorch twin.

Counterpart of hesic_tpu/codecs/pallas_pmf.py (gmm_freq_pallas) and of the
plain-XLA path of hesic_tpu/models/hesic_fast._gmm_freq_fast.

Inputs are the heads' NCHW outputs: sigma and means (B, K*M, h, w) f32
with channel k*M + m, which is already the (B, K, M, hw) layout the
computation wants (a view, no transpose); weights the same, or
(B, K*M, 1, 1) for the spatially pooled head (HESIC's); center (B, M)
int32 grid centres.  Output: freq (B, M, S, hw) int32, S = 2*mm + 1,
every row summing to 2^16 with every bin >= 1.

Both versions run the same det_math chain in the same order: edge CDFs
at e_s = (s - mm - 0.5) + c_m, the mixture sum unrolled in ascending k,
the row total accumulated in ascending s, floor/max-1 quantization, and
the deficit stolen by the first maximal bin.  ``gmm_freq`` dispatches on
the device of its input: CPU -> the plain twin, CUDA -> the kernel
(csrc/pmf.cu), which is bit-equal to the twin on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .det_math import (det_freq_rows, det_qscale, det_recip, det_std_cdf,
                       f32)

SCALE_MIN = f32(0.11)
_NAME = "gmm_freq"


def _views(sigma, means, weights, k: int):
    b, mk, h, w = sigma.shape
    if mk % k:
        raise ValueError(f"channels {mk} not divisible by K={k}")
    m = mk // k
    pooled = tuple(weights.shape[2:]) == (1, 1)
    if tuple(means.shape) != tuple(sigma.shape):
        raise ValueError("sigma and means must have the same shape")
    if tuple(weights.shape) not in ((b, mk, 1, 1), (b, mk, h, w)):
        raise ValueError(f"weights shape {tuple(weights.shape)} is neither "
                         f"pooled nor spatial")
    return b, m, h * w, pooled


def gmm_freq_plain(sigma, means, weights, mm: int, k: int, center):
    """Plain twin of kernel 1, one edge at a time (memory stays at one
    (B, K, M, hw) CDF slab per edge)."""
    b, m, hw, pooled = _views(sigma, means, weights, k)
    mu = means.reshape(b, k, m, hw).float()
    inv_sc = det_recip(torch.clamp_min(sigma.reshape(b, k, m, hw).float(),
                                       SCALE_MIN))
    wgt = weights.reshape(b, k, m, 1 if pooled else hw).float()
    edges = (torch.arange(-mm, mm + 2, dtype=torch.float32,
                          device=sigma.device) - 0.5)
    edges = edges[None, None, :] + center.to(torch.float32)[:, :, None]

    def edge_cdf(s):
        e = edges[:, :, s][:, None, :, None]           # (B, 1, M, 1)
        return det_std_cdf((e - mu) * inv_sc)          # (B, K, M, hw)

    prev = edge_cdf(0)
    rows = []
    total = None
    for s in range(1, 2 * mm + 2):
        cur = edge_cdf(s)
        diff = (cur - prev) * wgt
        acc = diff[:, 0]
        for kk in range(1, k):
            acc = acc + diff[:, kk]
        p_s = torch.clamp_min(acc, 0.0)                # (B, M, hw)
        rows.append(p_s)
        total = p_s if total is None else total + p_s
        prev = cur
    pmf = torch.stack(rows, dim=2)                     # (B, M, S, hw)
    return det_freq_rows(pmf, det_qscale(total)[:, :, None, :], dim=2)


def _lib():
    lib = build.load("pmf")
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_gmm_freq.restype = ci
        lib.hesic_gmm_freq.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib._hesic_typed = True
    return lib


def gmm_freq_cuda(sigma, means, weights, mm: int, k: int, center):
    """Kernel 1 on the card; same contract as gmm_freq_plain."""
    b, m, hw, pooled = _views(sigma, means, weights, k)
    if not 1 <= k <= 8:
        raise ValueError(f"K={k}: the kernel is built for 1..8 mixtures")
    build.check_cuda_tensor(sigma, "sigma", torch.float32)
    build.check_cuda_tensor(means, "means", torch.float32)
    build.check_cuda_tensor(weights, "weights", torch.float32)
    build.check_cuda_tensor(center, "center", torch.int32, (b, m))
    s = 2 * mm + 1
    freq = torch.empty((b, m, s, hw), dtype=torch.int32, device=sigma.device)
    stream = torch.cuda.current_stream(sigma.device).cuda_stream
    rc = _lib().hesic_gmm_freq(
        sigma.data_ptr(), means.data_ptr(), weights.data_ptr(),
        center.data_ptr(), freq.data_ptr(), b, k, m, hw, mm,
        0 if pooled else 1, stream)
    build.check_status(rc, _NAME)
    build.count_launch(_NAME)
    return freq


def gmm_freq(sigma, means, weights, mm: int, k: int, center):
    """Frequency rows: the kernel for CUDA tensors, the plain twin on the
    CPU."""
    if sigma.is_cuda:
        return gmm_freq_cuda(sigma, means, weights, mm, k, center)
    return gmm_freq_plain(sigma, means, weights, mm, k, center)
