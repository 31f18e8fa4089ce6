"""Conv/deconv primitives, GDN and the masked context conv, NCHW."""

from .conv import Conv, Deconv
from .gdn import GDN
from .layers import MaskedConv2d, raster_causal_mask

__all__ = ["Conv", "Deconv", "GDN", "MaskedConv2d", "raster_causal_mask"]
