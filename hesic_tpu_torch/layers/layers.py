"""The raster-causal context conv (PixelCNN mask A/B) and Cheng2020's
building blocks, NCHW.

Counterpart of hesic_tpu/layers/layers.py.  As in the JAX module, the
masked conv's weight is stored unmasked and the mask is applied at use
(no in-place mutation of the parameter), so the stored weight maps one to
one onto the flax ``kernel``.

The blocks register their convs and GDNs under flax's automatic names
(``Conv_0``, ``GDN_0``, ``SubpelConv3x3_1``, ``_ResidualUnit_4``: the
class name and its index among the block's children of that class, in
call order), so state_dict keys map one to one onto the JAX parameter
tree (utils/from_jax.py).  Leaky ReLUs have flax's slope 0.01.  Their
stride-1 3x3 convs run image by image (``ImageConv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .conv import Conv, _kaiming_
from .gdn import GDN


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


class ImageConv(Conv):
    """A stride-1 conv that runs a float32 batch image by image.  Under
    the codecs' policy (deterministic cuDNN, no benchmarking, no TF32)
    cuDNN's heuristic pick for batched float32 3x3 convs of 128-192
    channels at 64x64-128x128 is an FFT-tiling algorithm that launches
    thousands of small GEMMs, several hundred times slower than the same
    convs one image at a time (``chip_smoke.py`` phase 17 prints both on
    the card); Cheng2020's residual blocks run at exactly those shapes.
    Each image's result is then also independent of the batch."""

    def forward(self, x):
        if x.shape[0] <= 1 or (self.dtype or x.dtype) != torch.float32:
            return super().forward(x)
        return torch.cat([Conv.forward(self, x[i:i + 1])
                          for i in range(x.shape[0])])


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, generator=None):
    """A 3x3 conv; stride 1 runs image by image (``ImageConv``)."""
    cls = ImageConv if stride == 1 else Conv
    return cls(in_ch, out_ch, kernel_size=3, stride=stride,
               generator=generator)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1, generator=None):
    return Conv(in_ch, out_ch, kernel_size=1, stride=stride,
                generator=generator)


def _leaky(x):
    return F.leaky_relu(x, 0.01)


class SubpelConv3x3(nn.Module):
    """3x3 conv to C*r^2 channels, then depth-to-space by r.  flax's
    ``pixel_shuffle`` takes channel c*r^2 + i*r + j to offset (i, j) of
    channel c, as F.pixel_shuffle does, so the conv's channels map one to
    one."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 1, generator=None):
        super().__init__()
        self.r = r
        self.Conv_0 = conv3x3(in_ch, out_ch * r * r, generator=generator)

    def forward(self, x):
        return F.pixel_shuffle(self.Conv_0(x), self.r)


class ResidualBlockWithStride(nn.Module):
    """conv3x3/s -> leaky -> conv3x3 -> GDN, plus a 1x1 strided shortcut
    (the identity at stride 1)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2,
                 generator=None):
        super().__init__()
        self.stride = stride
        self.Conv_0 = conv3x3(in_ch, out_ch, stride, generator)
        self.Conv_1 = conv3x3(out_ch, out_ch, generator=generator)
        self.GDN_0 = GDN(out_ch)
        if stride != 1:
            self.Conv_2 = conv1x1(in_ch, out_ch, stride, generator)

    def forward(self, x):
        out = self.GDN_0(self.Conv_1(_leaky(self.Conv_0(x))))
        return out + (self.Conv_2(x) if self.stride != 1 else x)


class ResidualBlockUpsample(nn.Module):
    """subpel conv -> leaky -> conv3x3 -> IGDN, plus a subpel shortcut."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2,
                 generator=None):
        super().__init__()
        self.SubpelConv3x3_0 = SubpelConv3x3(in_ch, out_ch, upsample,
                                             generator)
        self.Conv_0 = conv3x3(out_ch, out_ch, generator=generator)
        self.GDN_0 = GDN(out_ch, inverse=True)
        self.SubpelConv3x3_1 = SubpelConv3x3(in_ch, out_ch, upsample,
                                             generator)

    def forward(self, x):
        out = self.GDN_0(self.Conv_0(_leaky(self.SubpelConv3x3_0(x))))
        return out + self.SubpelConv3x3_1(x)


class ResidualBlock(nn.Module):
    """Two 3x3 convs, each followed by a leaky ReLU, and the identity
    shortcut."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.Conv_0 = conv3x3(in_ch, out_ch, generator=generator)
        self.Conv_1 = conv3x3(out_ch, out_ch, generator=generator)

    def forward(self, x):
        return _leaky(self.Conv_1(_leaky(self.Conv_0(x)))) + x


class _ResidualUnit(nn.Module):
    """1x1 to N/2 -> ReLU -> 3x3 -> ReLU -> 1x1 to N, the shortcut, ReLU."""

    def __init__(self, n: int, generator=None):
        super().__init__()
        self.Conv_0 = conv1x1(n, n // 2, generator=generator)
        self.Conv_1 = conv3x3(n // 2, n // 2, generator=generator)
        self.Conv_2 = conv1x1(n // 2, n, generator=generator)

    def forward(self, x):
        out = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        return F.relu(self.Conv_2(out) + x)


class AttentionBlock(nn.Module):
    """Cheng2020's simplified attention: x + a * sigmoid(b), a three
    residual units over x, b three more and a 1x1 conv."""

    def __init__(self, n: int, generator=None):
        super().__init__()
        for i in range(6):
            self.add_module(f"_ResidualUnit_{i}",
                            _ResidualUnit(n, generator))
        self.Conv_0 = conv1x1(n, n, generator=generator)

    def _unit(self, i: int):
        return getattr(self, f"_ResidualUnit_{i}")

    def forward(self, x):
        a, b = x, x
        for i in range(3):
            a = self._unit(i)(a)
        for i in range(3, 6):
            b = self._unit(i)(b)
        return x + a * torch.sigmoid(self.Conv_0(b))
