"""The fast codec's homography warp, NCHW.

Semantics of hesic_tpu/geometry/fast_warp.warp_perspective_mxu, written
as a bilinear gather: dst(x, y) = src(H^-1 (x, y)) with zero padding.
Output rows are grouped in blocks of ``rows_per_block``; each block reads
a window of ``win`` source rows starting at its lowest in-image source
row (clamped to [0, h - win]).  Taps outside the window are masked to
zero and counted (the overflow count); image-border zero padding is
exact and not counted.  ``compute_dtype`` rounds the source pixels and
the bilinear weights as the JAX package's contraction does (bf16 in the
codec), and every product and sum runs in float32.

The window choices are host-side f64 numpy and must return the same
integers as the JAX package's, because ``win`` and ``xwin`` go into the
container header.  The x banding that ``xwin`` selects there is
bit-identical to the full-width warp when no x tap overflows, so the port
warps at full width and only stores the byte.
"""

from __future__ import annotations

import numpy as np
import torch

def pick_warp_win(m_np, h_out: int, w_out: int,
                  rows_per_block: int = 8,
                  choices=(16, 32, 64), margin: int = 4) -> int:
    """Host-side static window choice for ``warp_perspective_mxu``.

    The x-contraction carries ``win`` source rows through the MXU per
    output block, so the kernel's FLOPs scale linearly with ``win`` —
    64 is ~32x the 2 bilinear taps actually needed for near-rectified
    homographies (the HESIC stereo case).  This measures the real
    per-block vertical spread of the source rows on a coarse column
    grid (every 32nd column + the last, all rows, f64 numpy) and picks
    the smallest window bucket that covers it plus a safety margin.

    Deterministic by construction: pure f64 numpy on the container's
    f32 H bytes, so encoder and decoder always select the same compiled
    program — the shared-executable bit-exactness invariant holds for
    every choice, and an undersized window only ever degrades quality
    (taps masked to zero, counted by the kernel's overflow output),
    never codec correctness.
    """
    m = np.asarray(m_np, np.float64).reshape(-1, 3, 3)
    mi = np.linalg.inv(m)
    ys = np.arange(h_out, dtype=np.float64)
    xs = np.unique(np.concatenate(
        [np.arange(0, w_out, 32, dtype=np.float64), [w_out - 1.0]]))
    gx, gy = np.meshgrid(xs, ys)                       # (Ho, Xc)
    num = (mi[:, 1, 0, None, None] * gx + mi[:, 1, 1, None, None] * gy
           + mi[:, 1, 2, None, None])
    den = (mi[:, 2, 0, None, None] * gx + mi[:, 2, 1, None, None] * gy
           + mi[:, 2, 2, None, None])
    den = np.where(np.abs(den) < 1e-8, 1e-8, den)
    y0 = np.floor(num / den)                           # (B, Ho, Xc)
    r = rows_per_block
    nb = -(-h_out // r)
    pad = nb * r - h_out
    if pad:
        y0 = np.concatenate([y0, np.repeat(y0[:, -1:], pad, axis=1)],
                            axis=1)
    y0b = y0.reshape(y0.shape[0], nb, r, -1)
    spread = (y0b.max(axis=(2, 3)) - y0b.min(axis=(2, 3))).max()
    need = int(spread) + 2 + margin                    # 2 bilinear taps
    for c in choices:
        if c >= need:
            return c
    return choices[-1]


#: Static bound on the per-image global column shift folded into the
#: banded warp's source slice (pick_warp_xwin returns None beyond it).
_XSHIFT_BOUND = 128


def pick_warp_xwin(m_np, h_out: int, w_out: int, xblock: int = 128,
                   margin: int = 4):
    """Host-side static source-COLUMN window for the banded x
    contraction of ``warp_perspective_mxu``.

    The x one-hot contraction carries W source columns per output pixel
    when un-banded; after subtracting the per-image global column shift
    (the device-exact min disparity, folded into the source slice) the
    residual source columns of an ``xblock``-wide output block live in
    [0, xblock + disparity-span), so the contraction can run over
    ``xwin`` columns instead — FLOPs scale by xwin/W (~3.5x cut at 512
    wide).  Measures the real disparity span on a coarse row grid
    (exact in x) and returns the smallest window bucket covering
    xblock + span + taps + margin, or None when no bucket fits or the
    global shift exceeds the kernel's static bound (caller falls back
    to the full-width contraction).

    Deterministic pure f64 numpy on the container's f32 H bytes, like
    ``pick_warp_win`` — encoder and decoder derive the same window, so
    the shared-executable bit-exactness invariant holds.  The banded
    program is bit-identical to the full one whenever no tap overflows
    the window (adding zeros is exact; the 4 bilinear taps merge the
    same way), and overflow only masks taps to zero (counted), never
    corrupts the codec.
    """
    m = np.asarray(m_np, np.float64).reshape(-1, 3, 3)
    mi = np.linalg.inv(m)
    ys = np.unique(np.concatenate(
        [np.arange(0, h_out, 16, dtype=np.float64), [h_out - 1.0]]))
    xs = np.arange(w_out, dtype=np.float64)
    gx, gy = np.meshgrid(xs, ys)
    num = (mi[:, 0, 0, None, None] * gx + mi[:, 0, 1, None, None] * gy
           + mi[:, 0, 2, None, None])
    den = (mi[:, 2, 0, None, None] * gx + mi[:, 2, 1, None, None] * gy
           + mi[:, 2, 2, None, None])
    den = np.where(np.abs(den) < 1e-8, 1e-8, den)
    x0 = np.floor(num / den)                           # (B, Yc, W)
    # the kernel's dxg uses CLIPPED coords (out-of-image taps are
    # masked anyway); match that definition exactly
    dx = np.clip(x0, 0, w_out - 1) - gx[None]
    dmin = dx.min(axis=(1, 2))                         # per image
    if np.abs(dmin).max() > _XSHIFT_BOUND - margin:
        return None
    span = int((dx.max(axis=(1, 2)) - dmin).max())
    need = xblock + span + 2 + margin
    for cand in (xblock + 16, xblock + 64, xblock + 128):
        if cand >= need and cand < w_out:
            return cand
    return None


def _coords(m: torch.Tensor, h_out: int, w_out: int):
    """Source coordinates (sx, sy) of every output pixel, (B, Ho, Wo)
    f32, elementwise (no matmul: exact f32 sampling weights).  inv_ex
    skips inv's singularity check, which would wait for the device."""
    mi = torch.linalg.inv_ex(m).inverse[:, :, :, None, None]  # (B,3,3,1,1)
    ys, xs = torch.meshgrid(
        torch.arange(h_out, dtype=torch.float32, device=m.device),
        torch.arange(w_out, dtype=torch.float32, device=m.device),
        indexing="ij")
    px = mi[:, 0, 0] * xs + mi[:, 0, 1] * ys + mi[:, 0, 2]
    py = mi[:, 1, 0] * xs + mi[:, 1, 1] * ys + mi[:, 1, 2]
    pz = mi[:, 2, 0] * xs + mi[:, 2, 1] * ys + mi[:, 2, 2]
    pz = torch.where(torch.abs(pz) < 1e-8, torch.full_like(pz, 1e-8), pz)
    return px / pz, py / pz


def warp_perspective(src: torch.Tensor, m: torch.Tensor, win: int = 64,
                     rows_per_block: int = 8,
                     compute_dtype=torch.bfloat16):
    """Warp (B, C, H, W) images by (B, 3, 3) homographies.

    Returns (out (B, C, H, W) float32, overflow count (0-dim int64
    tensor): taps masked because a block's vertical spread exceeded the
    window)."""
    b, c, h, w = src.shape
    win = min(win, h)
    r = rows_per_block
    nb = -(-h // r)
    sx, sy = _coords(m.to(torch.float32), nb * r, w)
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    wx1, wy1 = sx - x0f, sy - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    in_x0 = (x0 >= 0) & (x0 <= w - 1)
    in_x1 = (x0 + 1 >= 0) & (x0 + 1 <= w - 1)
    in_y0 = (y0 >= 0) & (y0 <= h - 1)
    in_y1 = (y0 + 1 >= 0) & (y0 + 1 <= h - 1)

    # per-block source-row window
    y0b = y0.reshape(b, nb, r * w)
    start = torch.clamp(y0b.amin(dim=2), 0, h - win)       # (B, NB)
    yl = (y0b - start[:, :, None]).reshape(b, nb * r, w)
    win_y0 = (yl >= 0) & (yl <= win - 1)
    win_y1 = (yl + 1 >= 0) & (yl + 1 <= win - 1)
    overflow = (in_y0 & ~win_y0).sum() + (in_y1 & ~win_y1).sum()
    my0, my1 = in_y0 & win_y0, in_y1 & win_y1

    cd = compute_dtype
    img = src.to(cd).float().reshape(b, c, h * w)
    wx1c = wx1.to(cd)
    wy1c = wy1.to(cd)
    wx0, wx1 = (1 - wx1c).float(), wx1c.float()
    wy0, wy1 = (1 - wy1c).float(), wy1c.float()
    xc0 = torch.clamp(x0, 0, w - 1)
    xc1 = torch.clamp(x0 + 1, 0, w - 1)

    def tap(yy, xc, mask):
        idx = (torch.clamp(yy, 0, h - 1) * w + xc).reshape(b, 1, -1)
        v = torch.gather(img, 2, idx.expand(b, c, idx.shape[-1]))
        return torch.where(mask.reshape(b, 1, -1), v, 0.0)

    def row(yy, my):
        t = (wx0.reshape(b, 1, -1) * tap(yy, xc0, in_x0 & my)
             + wx1.reshape(b, 1, -1) * tap(yy, xc1, in_x1 & my))
        return t

    out = (wy0.reshape(b, 1, -1) * row(y0, my0)
           + wy1.reshape(b, 1, -1) * row(y0 + 1, my1))
    out = out.reshape(b, c, nb * r, w)[:, :, :h]
    return out.contiguous(), overflow


TRAIN_WIN = 64
TRAIN_ROWS_PER_BLOCK = 8


def warp_perspective_train(src: torch.Tensor, m: torch.Tensor,
                           dtype=None) -> torch.Tensor:
    """The model forward's warp, as the JAX package's
    ``warp_perspective_train``: windows of 64 source rows for blocks
    of 8 output rows, computed in `dtype` (the model's transform dtype;
    None means float32, not the codec's bf16).  Differentiable with
    respect to `src`: the gather's backward is a scatter-add.  Returns
    the (B, C, H, W) float32 warp; overflowed taps are masked to zero."""
    return warp_perspective(src, m, TRAIN_WIN,
                            rows_per_block=TRAIN_ROWS_PER_BLOCK,
                            compute_dtype=dtype or torch.float32)[0]
