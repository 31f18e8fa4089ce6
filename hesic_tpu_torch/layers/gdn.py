"""Generalized Divisive Normalization, NCHW (hesic_tpu/layers/gdn.py).

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i, j] * x[j]^2) as a 1x1 channel
mix; ``inverse=True`` multiplies by the sqrt (IGDN).  ``GDN1`` is the
simplified form, y[i] = x[i] / (beta[i] + sum_j gamma[i, j] * |x[j]|),
with no square root.  gamma keeps torch's (out, in) orientation.
Parameters live in sqrt-space (nonneg_apply).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nonneg_apply, nonneg_init


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1,
                 dtype=None):
        super().__init__()
        self.inverse, self.beta_min, self.dtype = inverse, beta_min, dtype
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels)))
        self.gamma = nn.Parameter(nonneg_init(gamma_init
                                              * torch.eye(channels)))

    def forward(self, x):
        d = self.dtype or x.dtype
        beta = nonneg_apply(self.beta, self.beta_min).to(d)
        gamma = nonneg_apply(self.gamma).to(d)
        norm = F.conv2d((x * x).to(d), gamma[:, :, None, None], beta)
        if self.inverse:
            return x * torch.sqrt(norm)
        return x * torch.rsqrt(norm)


class GDN1(GDN):
    """Simplified GDN: |x| in place of x^2 and no square root;
    ``inverse=True`` multiplies by the norm instead of dividing."""

    def forward(self, x):
        d = self.dtype or x.dtype
        beta = nonneg_apply(self.beta, self.beta_min).to(d)
        gamma = nonneg_apply(self.gamma).to(d)
        norm = F.conv2d(torch.abs(x).to(d), gamma[:, :, None, None], beta)
        if not self.inverse:
            norm = 1.0 / norm
        return x * norm
