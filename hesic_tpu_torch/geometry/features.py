"""Classical feature-based homography estimation.

Counterpart of hesic_tpu/geometry/features.py, the stand-in for the
reference's OpenCV pipeline (SURF keypoints, BFMatcher 2-NN with the 0.7
ratio test, ``findHomography(..., RANSAC, 5.0)``), with fixed shapes
throughout and no host round trip before the inlier count:

* Detection: the Harris response (Sobel gradients, Gaussian-smoothed
  structure tensor), non-max suppression over a (2r+1)^2 window, one
  ``topk`` over the map.  ``max_kp`` slots; slots without a corner carry
  score 0 and are masked.
* Description: upright SURF-style 64-d descriptors (a 16x16 gradient
  window pooled into 4x4 cells of (sum dx, sum |dx|, sum dy, sum |dy|),
  Gaussian-weighted, L2-normalised).
* Matching: the K x K similarity as one matmul (unit descriptors: d^2 =
  2 - 2 a.b), 2-NN by ``topk``, Lowe's ratio test at 0.7.
* RANSAC: ``n_hyp`` 4-point hypotheses drawn with replacement by one
  ``torch.multinomial`` on a generator seeded from the caller's seed
  (the JAX package's stream cannot be reproduced), solved as a batch,
  scored by reprojection error against 5.0 px; the winner is refit on
  its inliers by a Hartley-normalised weighted DLT (9x9 ``eigh``).

A hypothesis whose 4 samples are duplicate or collinear gives a singular
system.  ``solve_perspective_batch`` solves without an error check and
flags it, and it scores -1, as a non-finite JAX solve does; nothing
raises and nothing waits for the device.  ``score_hypotheses`` takes the
sample indices as an argument.  Inputs are NHWC numpy images or tensors;
the estimator runs on the device the caller names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .homography import solve_perspective_batch

# BT.601 luma weights (the grayscale of the reference's cv2 path)
_LUMA = (0.299, 0.587, 0.114)

_DESC_HALF = 8          # 16x16 descriptor window
_DESC_CELL = 4          # 4x4 cells of 4x4 px -> 64-d descriptor


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _sep_conv(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2-D cross-correlation of an (H, W) map, zero SAME
    padding: along rows, then along columns."""
    k = torch.as_tensor(k1d, dtype=torch.float32, device=img.device)
    r = len(k1d) // 2
    x = F.conv2d(img[None, None], k.reshape(1, 1, 1, -1), padding=(0, r))
    return F.conv2d(x, k.reshape(1, 1, -1, 1), padding=(r, 0))[0, 0]


def _sobel(gray: torch.Tensor):
    """Sobel gradients of an (H, W) map -> (ix, iy)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=gray.device) / 8.0
    w = torch.stack([kx, kx.T])[:, None]                     # (2, 1, 3, 3)
    g = F.conv2d(gray[None, None], w, padding=1)[0]
    return g[0], g[1]


def harris_response(gray: torch.Tensor, k: float = 0.04,
                    sigma: float = 1.5) -> torch.Tensor:
    """Harris corner response of an (H, W) grayscale image."""
    ix, iy = _sobel(gray)
    g = _gaussian_kernel1d(sigma, radius=2)
    a = _sep_conv(ix * ix, g)
    b = _sep_conv(iy * iy, g)
    c = _sep_conv(ix * iy, g)
    return a * b - c * c - k * (a + b) ** 2


def detect_keypoints(gray: torch.Tensor, max_kp: int = 512,
                     nms_radius: int = 4):
    """The top ``max_kp`` Harris corners after non-max suppression ->
    (xy (max_kp, 2) float32 in (x, y) order, score (max_kp,)); slots past
    the corners found (or below the relative floor) score 0."""
    h, w = gray.shape
    resp = harris_response(gray)
    win = 2 * nms_radius + 1
    mx = F.max_pool2d(resp[None, None], win, stride=1,
                      padding=nms_radius)[0, 0]
    is_max = resp >= mx
    margin = _DESC_HALF + 1     # the descriptor window must fit
    ys = torch.arange(h, device=gray.device)[:, None]
    xs = torch.arange(w, device=gray.device)[None, :]
    inside = ((ys >= margin) & (ys < h - margin)
              & (xs >= margin) & (xs < w - margin))
    floor = 1e-4 * torch.clamp(torch.max(resp), min=1e-12)
    cand = torch.where(is_max & inside & (resp > floor), resp,
                       torch.zeros_like(resp))
    score, flat = torch.topk(cand.reshape(-1), max_kp)
    y = torch.div(flat, w, rounding_mode="floor").to(torch.float32)
    x = (flat % w).to(torch.float32)
    return torch.stack([x, y], dim=-1), score


def describe_keypoints(gray: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Upright SURF-style 64-d unit descriptors at integer keypoints:
    gray (H, W), xy (K, 2) in (x, y) order -> (K, 64)."""
    ix, iy = _sobel(gray)
    h, w = gray.shape
    k = xy.shape[0]
    off = torch.arange(-_DESC_HALF, _DESC_HALF, device=gray.device)
    yy = torch.clamp(xy[:, 1].to(torch.int64)[:, None, None]
                     + off[None, :, None], 0, h - 1).expand(k, 16, 16)
    xx = torch.clamp(xy[:, 0].to(torch.int64)[:, None, None]
                     + off[None, None, :], 0, w - 1).expand(k, 16, 16)
    g1 = _gaussian_kernel1d(sigma=5.0, radius=_DESC_HALF)[:-1]
    wgt = torch.as_tensor(np.outer(g1, g1), dtype=torch.float32,
                          device=gray.device)[None]
    dx = ix[yy, xx] * wgt
    dy = iy[yy, xx] * wgt

    def cells(t):
        t = t.reshape(k, _DESC_CELL, _DESC_CELL, _DESC_CELL, _DESC_CELL)
        return t.permute(0, 1, 3, 2, 4).reshape(
            k, _DESC_CELL * _DESC_CELL, _DESC_CELL * _DESC_CELL)

    cdx, cdy = cells(dx), cells(dy)
    desc = torch.cat([cdx.sum(-1), torch.abs(cdx).sum(-1),
                      cdy.sum(-1), torch.abs(cdy).sum(-1)], dim=-1)
    norm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    return desc / torch.clamp(norm, min=1e-8)


def match_descriptors(d1, d2, valid1, valid2, ratio: float = 0.7):
    """2-NN matching with Lowe's ratio test -> (idx2, weight): for each
    keypoint of image 1 the index of its best match in image 2, and 1.0
    where it passed the ratio test between valid keypoints, else 0."""
    sim = d1 @ d2.T
    sim = torch.where(valid2[None, :], sim,
                      torch.full_like(sim, -float("inf")))
    top2, idx = torch.topk(sim, 2, dim=-1)
    d2_best = torch.clamp(2.0 - 2.0 * top2[:, 0], min=0.0)
    d2_next = torch.clamp(2.0 - 2.0 * top2[:, 1], min=1e-12)
    good = d2_best < (ratio * ratio) * d2_next
    good = good & valid1 & torch.isfinite(top2[:, 0])
    return idx[:, 0], good.to(torch.float32)


def _dlt_refit(src, dst, w) -> torch.Tensor:
    """Hartley-normalised weighted DLT over every weighted
    correspondence: src, dst (K, 2), w (K,) >= 0 -> (3, 3)."""
    wn = w / torch.clamp(torch.sum(w), min=1e-8)

    def normalize(pts):
        mu = torch.sum(wn[:, None] * pts, dim=0)
        d = torch.sqrt(torch.sum((pts - mu) ** 2, dim=-1))
        scale = np.sqrt(2.0) / torch.clamp(torch.sum(wn * d), min=1e-8)
        zero, one = torch.zeros_like(scale), torch.ones_like(scale)
        t = torch.stack([scale, zero, -scale * mu[0],
                         zero, scale, -scale * mu[1],
                         zero, zero, one]).reshape(3, 3)
        return (pts - mu) * scale, t

    s_n, t_s = normalize(src)
    d_n, t_d = normalize(dst)
    x, y = s_n[:, 0], s_n[:, 1]
    u, v = d_n[:, 0], d_n[:, 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    row_u = torch.stack([x, y, ones, zeros, zeros, zeros,
                         -u * x, -u * y, -u], dim=-1)
    row_v = torch.stack([zeros, zeros, zeros, x, y, ones,
                         -v * x, -v * y, -v], dim=-1)
    a = torch.cat([row_u, row_v], dim=0)                     # (2K, 9)
    ww = torch.cat([w, w])[:, None]
    m = (a * ww).T @ a                                       # (9, 9)
    _, vecs = torch.linalg.eigh(m)
    h_n = vecs[:, 0].reshape(3, 3)                           # least eigvec
    h_full = torch.linalg.inv(t_d) @ h_n @ t_s
    h22 = h_full[2, 2]
    return h_full / torch.where(torch.abs(h22) < 1e-12,
                                torch.ones_like(h22), h22)


def sample_hypotheses(weight: torch.Tensor, n_hyp: int,
                      generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, 4) correspondence indices drawn with replacement in
    proportion to `weight`; uniform when every weight is 0 (those
    hypotheses then score no inliers)."""
    p = torch.where(torch.sum(weight) > 0, weight, torch.ones_like(weight))
    return torch.multinomial(p, n_hyp * 4, replacement=True,
                             generator=generator).reshape(n_hyp, 4)


def score_hypotheses(src, dst, weight, idx, thresh: float = 5.0):
    """The hypotheses of sample indices `idx` (N, 4) -> (hs (N, 3, 3),
    inliers (N, K) bool, score (N,)): the inlier count, -1 where the 4
    samples give a singular or non-finite solve."""
    n_hyp = idx.shape[0]
    flat = idx.reshape(-1)
    hs, ok = solve_perspective_batch(src[flat].reshape(n_hyp, 4, 2),
                                     dst[flat].reshape(n_hyp, 4, 2))
    src_h = torch.cat([src, torch.ones_like(src[:, :1])], dim=-1)
    proj = torch.einsum("nij,kj->nki", hs, src_h)            # (N, K, 3)
    z = proj[..., 2]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    err2 = torch.sum((proj[..., :2] / z[..., None] - dst[None]) ** 2, -1)
    inl = (err2 < thresh * thresh) & (weight > 0)[None]
    score = torch.where(ok, torch.sum(inl, dim=-1),
                        torch.full_like(ok, -1, dtype=torch.int64))
    return hs, inl, score


def find_homography_ransac(src, dst, weight, generator,
                           n_hyp: int = 512, thresh: float = 5.0):
    """RANSAC homography from weighted correspondences: src, dst (K, 2),
    weight (K,) sampling weights (0 excludes), `thresh` the inlier radius
    in pixels; hypotheses drawn from `generator`.  -> (h (3, 3),
    n_inliers int64 scalar tensor)."""
    return ransac_from_samples(src, dst, weight,
                               sample_hypotheses(weight, n_hyp, generator),
                               thresh)


def ransac_from_samples(src, dst, weight, idx, thresh: float = 5.0):
    """find_homography_ransac on given sample indices `idx` (N, 4): the
    best hypothesis refit on its inliers, or the identity where no
    hypothesis has an inlier."""
    hs, inl, score = score_hypotheses(src, dst, weight, idx, thresh)
    best = torch.argmax(score)
    inliers = inl[best].to(torch.float32)
    n_inl = torch.sum(inl[best])
    h_refit = _dlt_refit(src, dst, inliers)
    ok = (n_inl >= 4) & torch.isfinite(h_refit).all()
    h_best = torch.where(ok, h_refit, hs[best])
    eye = torch.eye(3, dtype=torch.float32, device=src.device)
    h_best = torch.where(torch.isfinite(h_best).all() & (score[best] > 0),
                         h_best, eye)
    return h_best, n_inl


def _gray(im, device) -> torch.Tensor:
    im = im if torch.is_tensor(im) else torch.from_numpy(np.asarray(im))
    im = im.to(device, torch.float32)
    if im.dim() == 2:
        return im
    return im @ torch.tensor(_LUMA, dtype=torch.float32, device=device)


@torch.no_grad()
def estimate_homography(im1, im2, seed: int = 0, *, max_kp: int = 512,
                        n_hyp: int = 512, ratio: float = 0.7,
                        thresh: float = 5.0, nms_radius: int = 4,
                        device="cuda") -> dict:
    """H mapping image-1 pixel coordinates into image 2.

    im1, im2: (H, W, 3) RGB float images in [0, 1] (or (H, W) gray),
    numpy or tensors; the estimate runs on `device`.  The convention is
    the reference ``get_H``'s (``findHomography(kp1, kp2)``): a warp of
    im1 by h lands in image 2's frame.  Returns {'h' (3, 3), 'n_inliers',
    'n_matches'} as tensors on `device`; :func:`get_h_classical` maps a
    failure to None as the reference does."""
    device = torch.device(device)
    g1, g2 = _gray(im1, device), _gray(im2, device)
    xy1, s1 = detect_keypoints(g1, max_kp=max_kp, nms_radius=nms_radius)
    xy2, s2 = detect_keypoints(g2, max_kp=max_kp, nms_radius=nms_radius)
    d1 = describe_keypoints(g1, xy1)
    d2 = describe_keypoints(g2, xy2)
    idx2, good = match_descriptors(d1, d2, s1 > 0, s2 > 0, ratio=ratio)
    gen = torch.Generator(device=device).manual_seed(seed)
    h, n_inl = find_homography_ransac(xy1, xy2[idx2], good, gen,
                                      n_hyp=n_hyp, thresh=thresh)
    return {"h": h, "n_inliers": n_inl,
            "n_matches": torch.sum(good).to(torch.int64)}


def get_h_classical(im1, im2, min_inliers: int = 8, **kw):
    """The reference ``get_H`` contract: numpy (3, 3) float32, or None
    when the estimate has fewer than `min_inliers` inliers."""
    out = estimate_homography(im1, im2, **kw)
    if int(out["n_inliers"]) < min_inliers:
        return None
    return out["h"].cpu().numpy().astype(np.float32)
