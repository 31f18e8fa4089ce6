"""Conv/deconv primitives, GDN, the masked context conv and Cheng2020's
blocks, NCHW."""

from .conv import Conv, Deconv
from .gdn import GDN
from .layers import (AttentionBlock, ImageConv, MaskedConv2d, ResidualBlock,
                     ResidualBlockUpsample, ResidualBlockWithStride,
                     SubpelConv3x3, conv1x1, conv3x3, raster_causal_mask)

__all__ = ["AttentionBlock", "Conv", "Deconv", "GDN", "ImageConv",
           "MaskedConv2d", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "SubpelConv3x3", "conv1x1", "conv3x3",
           "raster_causal_mask"]
