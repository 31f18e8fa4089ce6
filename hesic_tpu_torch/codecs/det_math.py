"""Deterministic float32 math for the PMF -> frequency pipeline, in eager
PyTorch.

Counterpart of hesic_tpu/codecs/det_math.py: the same op sequence, built
only from single-rounding IEEE operations (mul, add, sub, floor, compare)
and integer bit tricks, so every strict-IEEE evaluation gives the same
bits:

  * ``det_recip``: bit-trick seed + 3 Newton iterations (mul/sub only);
  * ``det_exp``:   Cody-Waite reduction + degree-7 Taylor + bit-assembled
    2^k;
  * ``det_std_cdf``: the A&S 7.1.26 normal CDF over the two above.

Eager PyTorch runs each operator as its own kernel with one rounding per
element on the CPU and on the GPU, so no mul+add pair is ever fused.  The
CUDA kernel of codecs/pmf.py (csrc/pmf.cu) writes the same chain with
``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` and is bit-equal to this module
on the card.  Never route these chains through fused operators
(``addcmul``, ``lerp``) or ``torch.compile``: either may contract.

Constants are float32 values held as Python floats (exactly
representable), so PyTorch's float32 kernels apply them unrounded.
"""

from __future__ import annotations

import numpy as np
import torch

TOTAL = 1 << 16


def f32(v) -> float:
    """The float32 value of `v`, as a Python float (exact)."""
    return float(np.float32(v))


P = f32(0.3275911)
A1 = f32(0.254829592)
A2 = f32(-0.284496736)
A3 = f32(1.421413741)
A4 = f32(-1.453152027)
A5 = f32(1.061405429)
INV_SQRT2 = f32(0.7071067811865476)
LOG2E = f32(1.4426950408889634)
# Cody-Waite split of ln2: HI is exact in f32 (355/512), LO the residue
LN2_HI = f32(0.693359375)
LN2_LO = f32(-2.12194440e-4)
# Taylor 1/n! for e^r, |r| <= 0.3466
EXP_C = [f32(c) for c in (1.0, 1.0, 0.5, 1.0 / 6, 1.0 / 24, 1.0 / 120,
                           1.0 / 720, 1.0 / 5040)]
RECIP_MAGIC = 0x7EF311C3
TINY = f32(1e-30)


def det_recip(d: torch.Tensor) -> torch.Tensor:
    """Deterministic f32 reciprocal: bit-trick seed (rel err ~5%) + 3
    Newton iterations, x <- x * (2 - d * x)."""
    x = (RECIP_MAGIC - d.view(torch.int32)).view(torch.float32)
    for _ in range(3):
        x = x * (2.0 - d * x)
    return x


def det_exp(v: torch.Tensor) -> torch.Tensor:
    """Deterministic f32 exp for v <= 0 (flushes below 2^-126 to 0)."""
    k = torch.floor(v * LOG2E + 0.5)
    r = (v - k * LN2_HI) - k * LN2_LO
    p = torch.full_like(r, EXP_C[7])
    for c in reversed(EXP_C[:7]):
        p = p * r + c
    ki = k.to(torch.int32)
    scale = ((ki + 127) << 23).view(torch.float32)
    return torch.where(ki < -126, torch.zeros_like(p), p * scale)


def det_std_cdf(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF, A&S 7.1.26 erfc over det_recip/det_exp."""
    z = torch.clamp_max(torch.abs(x) * INV_SQRT2, 16.0)
    t = det_recip(1.0 + P * z)
    poly = t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5))))
    erfc_z = poly * det_exp(-z * z)
    return torch.where(x >= 0, 1.0 - 0.5 * erfc_z, 0.5 * erfc_z)


def det_qscale(total: torch.Tensor) -> torch.Tensor:
    """65536 / total with the deterministic reciprocal (total >= 0)."""
    return float(TOTAL) * det_recip(torch.clamp_min(total, TINY))


def det_steal(freq: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer-only steal: add the row deficit (65536 - sum) to the FIRST
    max bin along `dim`.  ``freq`` must be int32."""
    deficit = TOTAL - freq.sum(dim=dim, keepdim=True, dtype=torch.int32)
    amax = torch.argmax(freq, dim=dim, keepdim=True)
    return freq.scatter_add(dim, amax, deficit.to(freq.dtype))


def det_freq_rows(pmf: torch.Tensor, qscale: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """freq = max(floor(pmf * qscale), 1) with the deficit stolen by the
    FIRST max bin along `dim`."""
    freq = torch.clamp_min(torch.floor(pmf * qscale), 1.0).to(torch.int32)
    return det_steal(freq, dim)
