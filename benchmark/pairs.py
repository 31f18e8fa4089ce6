"""The benchmark's stereo pairs, made on the device from a seed.

The left view is a textured RGB field with the roughly 1/f amplitude
spectrum of natural photographs: white noise filtered by 1/f^alpha, a
luminance field and two weaker chroma fields, scaled to a mean and a
spread and clipped to [0, 1].  Each pair has a homography drawn as an
uncalibrated rig's (a rotation within +-rot_deg about the origin and a
shift within +-shift_px), and its right view is the left view warped by
it, dst(p) = src(H^-1 p), which is the warp the codec applies: the
warped left view predicts the right one.  The field is made larger than
the views by ``margin`` pixels on each side, so the warp never samples
outside it.  Then a per-pair gain and offset and Gaussian sensor noise,
and both views are clipped to [0, 1].

Every parameter comes from the traffic file's ``images`` object; one
general generator serves every mix.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.layers import warp


def _field(n: int, size: int, p: dict, gen, device) -> torch.Tensor:
    """(n, 3, size, size) textured RGB fields."""
    noise = torch.randn((n, 3, size, size), generator=gen, device=device)
    f = torch.fft.fftfreq(size, device=device)
    rad = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2).clamp_min(1 / size)
    spec = torch.fft.fft2(noise) / rad ** p["alpha"]
    spec[..., 0, 0] = 0
    x = torch.fft.ifft2(spec).real
    x = x / x.flatten(2).std(dim=2)[:, :, None, None]
    lum, c1, c2 = x[:, 0], x[:, 1] * p["chroma"], x[:, 2] * p["chroma"]
    rgb = torch.stack([lum + c1, lum - 0.5 * (c1 + c2), lum + c2], dim=1)
    return (p["mean"] + p["std"] * rgb).clamp(0, 1)


def homographies(n: int, p: dict, gen, device) -> torch.Tensor:
    """(n, 3, 3) float32: rotation within +-rot_deg, shift within
    +-shift_px."""
    u = torch.rand((n, 3), generator=gen, device=device, dtype=torch.float64)
    th = (2 * u[:, 0] - 1) * math.radians(p["rot_deg"])
    tx = (2 * u[:, 1] - 1) * p["shift_px"]
    ty = (2 * u[:, 2] - 1) * p["shift_px"]
    h = torch.zeros((n, 3, 3), dtype=torch.float64, device=device)
    h[:, 0, 0], h[:, 0, 1], h[:, 0, 2] = torch.cos(th), -torch.sin(th), tx
    h[:, 1, 0], h[:, 1, 1], h[:, 1, 2] = torch.sin(th), torch.cos(th), ty
    h[:, 2, 2] = 1
    return h.float()


def make_pairs(n: int, hw: int, p: dict, gen, device):
    """n pairs: (x1, x2) (n, 3, hw, hw) float32 in [0, 1] and H (n, 3, 3)
    float32, with x2 = x1 warped by H (then gain, offset, noise)."""
    m = p["margin"]
    big = _field(n, hw + 2 * m, p, gen, device)
    h = homographies(n, p["homography"], gen, device)
    # warp the field by T(m) H T(-m) and crop: x2(q) = field(H^-1 q + m)
    t = torch.eye(3, device=device).repeat(n, 1, 1)
    t[:, 0, 2] = t[:, 1, 2] = m
    ti = torch.linalg.inv(t)
    x2 = warp(big, t @ h @ ti)[:, :, m:m + hw, m:m + hw]
    x1 = big[:, :, m:m + hw, m:m + hw]
    u = torch.rand((n, 2), generator=gen, device=device)
    gain = 1 + (2 * u[:, 0] - 1) * p["gain"]
    off = (2 * u[:, 1] - 1) * p["offset"]
    x2 = x2 * gain[:, None, None, None] + off[:, None, None, None]
    s = p["noise_std"]
    x1 = x1 + s * torch.randn(x1.shape, generator=gen, device=device)
    x2 = x2 + s * torch.randn(x2.shape, generator=gen, device=device)
    return x1.clamp(0, 1).contiguous(), x2.clamp(0, 1).contiguous(), h


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of a run's seed: `stream`
    keeps the weights, the calibration and the traffic apart."""
    mixed = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), stream])
    return torch.Generator(device=device).manual_seed(
        int(mixed.generate_state(1, np.uint64)[0] >> 1))
