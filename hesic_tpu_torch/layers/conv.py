"""Conv/deconv with the geometry of hesic_tpu/layers/conv.py, NCHW.

``Conv`` is ``Conv2d(k, s, padding=k//2)`` and ``Deconv`` is
``ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)`` (output size
exactly input * stride).  Parameters stay float32; ``dtype`` (None = the
input's) is the compute type: input, weight and bias are cast to it, as
the JAX modules do.  The JAX package's phase-decomposed deconv is a TPU
device for the same linear map and is not carried over.

Initialisation is kaiming-normal (fan_in, gain sqrt(2)) with zero bias,
the JAX package's ``variance_scaling(2.0, "fan_in", "normal")``, drawn
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _kaiming_(weight: torch.Tensor, fan_in: int, generator):
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)


class Conv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2, dtype=None, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, k // 2, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _kaiming_(self.weight, in_ch * k * k, generator)

    def forward(self, x, with_bias: bool = True):
        d = self.dtype or x.dtype
        return F.conv2d(x.to(d), self.weight.to(d),
                        self.bias.to(d) if with_bias else None,
                        stride=self.stride, padding=self.padding)


class Deconv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2, dtype=None, generator=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.dtype = stride, k // 2, dtype
        self.output_padding = stride - 1
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _kaiming_(self.weight, in_ch * k * k, generator)

    def forward(self, x, with_bias: bool = True):
        d = self.dtype or x.dtype
        return F.conv_transpose2d(
            x.to(d), self.weight.to(d),
            self.bias.to(d) if with_bias else None, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding)
