"""Homography warp of the fast codec and of the training forward."""

from .warp import (pick_warp_win, pick_warp_xwin, warp_perspective,
                   warp_perspective_train)

__all__ = ["pick_warp_win", "pick_warp_xwin", "warp_perspective",
           "warp_perspective_train"]
