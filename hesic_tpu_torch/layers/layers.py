"""The raster-causal context conv (PixelCNN mask A/B), NCHW.

Counterpart of hesic_tpu/layers/layers.py (``raster_causal_mask``,
``MaskedConv2d``).  As in the JAX module, the weight is stored unmasked
and the mask is applied at use (no in-place mutation of the parameter),
so the stored weight maps one to one onto the flax ``kernel``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import _kaiming_


def raster_causal_mask(kh: int, kw: int, mask_type: str = "A"):
    """PixelCNN raster mask, (kh, kw) float32 with 1s at allowed taps.
    Type 'A' masks the centre pixel too; 'B' allows it."""
    if mask_type not in ("A", "B"):
        raise ValueError(f'Invalid "mask_type" value "{mask_type}"')
    mask = torch.ones((kh, kw), dtype=torch.float32)
    mask[kh // 2, kw // 2 + (mask_type == "B"):] = 0
    mask[kh // 2 + 1:] = 0
    return mask


class MaskedConv2d(nn.Module):
    """Raster-causal 2-D conv, stride 1, padding k//2.  ``weight`` is
    (out, in, k, k), unmasked; ``dtype`` (None = the input's) is the
    compute type, as ``layers.Conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 mask_type: str = "A", dtype=None, generator=None):
        super().__init__()
        k = kernel_size
        self.padding, self.dtype = k // 2, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.register_buffer("mask", raster_causal_mask(k, k, mask_type),
                             persistent=False)
        _kaiming_(self.weight, in_ch * k * k, generator)

    def masked_weight(self) -> torch.Tensor:
        """The float32 weight with the causality mask applied."""
        return self.weight * self.mask

    def forward(self, x):
        d = self.dtype or x.dtype
        return F.conv2d(x.to(d), self.masked_weight().to(d),
                        self.bias.to(d), padding=self.padding)
