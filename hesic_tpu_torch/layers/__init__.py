"""Conv/deconv primitives and GDN, NCHW."""

from .conv import Conv, Deconv
from .gdn import GDN

__all__ = ["Conv", "Deconv", "GDN"]
