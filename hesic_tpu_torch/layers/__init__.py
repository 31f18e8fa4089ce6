"""Conv/deconv primitives, GDN and GDN1 (``conv_gdn`` and ``run_layers``
fold a conv's bias into GDN's kernel), the masked context conv and
Cheng2020's blocks, NCHW.  The JAX package's flax helpers (Sequential,
conv, deconv, pixel_shuffle, kaiming_normal) have no counterpart: a
PyTorch module holds its own layers and draws its own init."""

from .conv import Conv, Deconv
from .gdn import GDN, GDN1, conv_gdn, run_layers
from .layers import (AttentionBlock, ImageConv, MaskedConv2d, ResidualBlock,
                     ResidualBlockUpsample, ResidualBlockWithStride,
                     SubpelConv3x3, conv1x1, conv3x3, raster_causal_mask)

__all__ = ["AttentionBlock", "Conv", "Deconv", "GDN", "GDN1", "ImageConv",
           "MaskedConv2d", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "SubpelConv3x3", "conv1x1", "conv3x3",
           "conv_gdn", "raster_causal_mask", "run_layers"]
