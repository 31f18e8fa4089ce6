"""Planar homography ops, NCHW: the counterpart of
hesic_tpu/geometry/homography.py.

Pixel coordinates (x = column, y = row); homogeneous 3x3 matrices act on
(x, y, 1).  ``warp_perspective(src, M)`` gives dst(x) = src(M^-1 x) with
bilinear sampling over the whole image and zero padding (the contract
kornia implements), unlike the codec's banded warp
(geometry/warp.py, exported as ``geometry.warp_perspective``): import
this one from ``geometry.homography``.  Everything is float32 and
batched.
"""

from __future__ import annotations

import torch

from .warp import _coords


def _dlt_system(src: torch.Tensor, dst: torch.Tensor):
    """The 8x8 DLT system of 4 point pairs: (a (B, 8, 8), rhs (B, 8,
    1)), float32."""
    src, dst = src.to(torch.float32), dst.to(torch.float32)
    x, y = src[..., 0], src[..., 1]                  # (B, 4)
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    return torch.cat([ax, ay], dim=1), torch.cat([u, v], dim=1)[..., None]


def _with_h22(h8: torch.Tensor) -> torch.Tensor:
    return torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(-1, 3, 3)


def get_perspective_transform(src: torch.Tensor,
                              dst: torch.Tensor) -> torch.Tensor:
    """The homography mapping 4 src points onto 4 dst points, by a DLT
    solve in float32: src, dst (B, 4, 2) pixel coordinates -> (B, 3, 3)
    with H[2, 2] = 1.  A singular system raises."""
    a, rhs = _dlt_system(src, dst)
    return _with_h22(torch.linalg.solve(a, rhs)[..., 0])


def solve_perspective_batch(src: torch.Tensor, dst: torch.Tensor):
    """get_perspective_transform for many hypotheses at once, without an
    error check (so without a host sync on the card): -> ((B, 3, 3), ok
    (B,) bool), ok False where the system is singular or the solve is
    not finite."""
    a, rhs = _dlt_system(src, dst)
    h8, info = torch.linalg.solve_ex(a, rhs, check_errors=False)
    h = _with_h22(h8[..., 0])
    return h, (info == 0) & torch.isfinite(h).flatten(1).all(-1)


def warp_perspective(src: torch.Tensor, m: torch.Tensor,
                     dsize=None) -> torch.Tensor:
    """Warp (B, C, H, W) images by (B, 3, 3) homographies: dst(x, y) =
    src(M^-1 (x, y)), bilinear, zero outside the image, float32.  `dsize`
    (H_out, W_out) defaults to the input's size.  The four taps sum in
    the JAX package's order: ((v00 w00 + v01 w01) + v10 w10) + v11 w11,
    with w = wy * wx."""
    b, c, h, w = src.shape
    ho, wo = dsize if dsize is not None else (h, w)
    sx, sy = _coords(m.to(torch.float32), ho, wo)    # (B, Ho, Wo)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx1, wy1 = sx - x0f, sy - y0f
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    img = src.to(torch.float32).reshape(b, c, h * w)

    def tap(yy, xx, weight):
        inside = (xx >= 0) & (xx <= w - 1) & (yy >= 0) & (yy <= h - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, 1, -1)
        v = torch.gather(img, 2, idx.expand(b, c, idx.shape[-1]))
        v = v * inside.reshape(b, 1, -1)
        return v * weight.reshape(b, 1, -1)

    out = (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
           + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))
    return out.reshape(b, c, ho, wo)


def upscale_homography(h, scale_h: float, scale_w=None) -> torch.Tensor:
    """A homography estimated at one resolution, rescaled to another:
    S @ H @ S^-1 with S = diag(scale_w, scale_h, 1), float32."""
    if scale_w is None:
        scale_w = scale_h
    h = torch.as_tensor(h, dtype=torch.float32)
    s = torch.tensor([[scale_w, 0, 0], [0, scale_h, 0], [0, 0, 1]],
                     dtype=torch.float32, device=h.device)
    s_inv = torch.tensor([[1 / scale_w, 0, 0], [0, 1 / scale_h, 0],
                          [0, 0, 1]], dtype=torch.float32, device=h.device)
    return s @ h @ s_inv
