"""Homography warp of the fast codec and of the training forward, and the
classical feature-based homography estimate (features.py)."""

from .features import estimate_homography, get_h_classical
from .warp import (pick_warp_win, pick_warp_xwin, warp_perspective,
                   warp_perspective_train)

__all__ = ["estimate_homography", "get_h_classical", "pick_warp_win",
           "pick_warp_xwin", "warp_perspective", "warp_perspective_train"]
