"""The pair generator: one seed, one set of pairs; the right view is the
left view warped by the pair's homography."""

import torch

from benchmark import pairs
from benchmark.reference.layers import warp

P = {"alpha": 1.0, "chroma": 0.3, "mean": 0.45, "std": 0.2, "margin": 16,
     "gain": 0.0, "offset": 0.0, "noise_std": 0.0,
     "homography": {"rot_deg": 1.5, "shift_px": 8}}


def make(seed, p=P):
    return pairs.make_pairs(3, 64, p, pairs.generator(seed, 3, "cpu"), "cpu")


def test_same_seed_same_pairs():
    a, b = make(2 ** 31 + 9), make(2 ** 31 + 9)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = make(2 ** 31 + 10)
    assert not torch.equal(a[0], c[0])


def test_right_view_follows_from_h():
    x1, x2, h = make(11)
    w = warp(x1, h)
    # where H^-1 p falls inside the left view (4 pixels in), the warped
    # left view is the right view up to float rounding
    inner = w[:, :, 14:50, 14:50]
    assert (inner - x2[:, :, 14:50, 14:50]).abs().max() < 1e-4
    assert x1.std() > 0.1                       # textured, not flat


def test_homographies_in_range():
    h = pairs.homographies(1000, P["homography"],
                           pairs.generator(1, 3, "cpu"), "cpu")
    ang = torch.rad2deg(torch.atan2(h[:, 1, 0], h[:, 0, 0]))
    assert ang.abs().max() <= 1.5 + 1e-4 and h[:, :2, 2].abs().max() <= 8
