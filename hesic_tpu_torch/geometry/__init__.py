"""Homography warp of the fast codec."""

from .warp import pick_warp_win, pick_warp_xwin, warp_perspective

__all__ = ["pick_warp_win", "pick_warp_xwin", "warp_perspective"]
