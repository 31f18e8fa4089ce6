"""Homography warps (the fast codec's, the training forward's and the full
bilinear one of the host codecs), the homography net and its
photometric loss, and the classical feature-based homography estimate
(features.py)."""

from .features import (estimate_homography, find_homography_ransac,
                       get_h_classical)
from .homography import get_perspective_transform, upscale_homography
from .net import HomographyNet, photometric_loss
from .warp import (pick_warp_win, pick_warp_xwin, warp_perspective,
                   warp_perspective_train)

__all__ = ["HomographyNet", "estimate_homography", "find_homography_ransac",
           "get_h_classical", "get_perspective_transform",
           "photometric_loss", "pick_warp_win", "pick_warp_xwin",
           "upscale_homography", "warp_perspective",
           "warp_perspective_train"]
