"""Port: the full-image homography ops
(hesic_tpu_torch/geometry/homography.py) against the JAX package's
(hesic_tpu/geometry/homography.py), on the CPU, within 1e-5 absolute.

* ``get_perspective_transform`` on seeded point sets: a DLT solve in
  float32, within 1e-5 of JAX's after scaling by the matrix's largest
  entry (the two solvers pivot and sum in their own orders; measured
  6e-8), and the solved matrix maps the source points onto the
  destinations.
* ``warp_perspective`` of seeded smooth images (values in [0, 1]) by the
  identity, a rotation about the centre with a shift, a seeded
  perspective and a homography that throws part of the image outside
  (the zero-padded border), NCHW in the port and NHWC in JAX, also with
  an output size other than the input's; the identity returns the image
  exactly.  The sampling coordinates can differ in the last bits
  (another inverse; XLA contracts FMAs), which moves a bilinear weight
  by about an ULP of the coordinate: measured max 4.8e-7.
* ``upscale_homography``: S H S^-1, within 1e-5 relative to the largest
  entry (measured equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.geometry import homography as jh
from hesic_tpu_torch.geometry import homography as th
from hesic_tpu_torch.geometry import warp_perspective as codec_warp

torch.set_num_threads(2)

TOL = 1e-5


def _points(seed, b=3, hw=64.0, jitter=6.0):
    rng = np.random.RandomState(seed)
    corners = np.array([[0, 0], [hw - 1, 0], [hw - 1, hw - 1], [0, hw - 1]],
                       np.float32)
    src = np.tile(corners[None], (b, 1, 1))
    dst = src + rng.uniform(-jitter, jitter, src.shape).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_perspective_transform_matches_jax(seed):
    src, dst = _points(seed)
    got = th.get_perspective_transform(torch.from_numpy(src),
                                       torch.from_numpy(dst)).numpy()
    want = np.asarray(jh.get_perspective_transform(src, dst))
    assert got.dtype == np.float32 and got.shape == (3, 3, 3)
    np.testing.assert_array_equal(got[:, 2, 2], 1.0)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)
    # the matrix maps each source point onto its destination
    hom = np.concatenate([src, np.ones_like(src[..., :1])], -1)
    mapped = np.einsum("bij,bpj->bpi", got.astype(np.float64), hom)
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:], dst,
                               rtol=0, atol=1e-3)


def _smooth(seed, b=2, hw=64, c=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(b, hw // 8 + 1, hw // 8 + 1, c).astype(np.float32)
    idx = np.linspace(0, hw // 8 - 1e-3, hw)
    i0 = idx.astype(np.int32)
    f = (idx - i0).astype(np.float32)
    rows = (base[:, i0] * (1 - f)[None, :, None, None]
            + base[:, i0 + 1] * f[None, :, None, None])
    return (rows[:, :, i0] * (1 - f)[None, None, :, None]
            + rows[:, :, i0 + 1] * f[None, None, :, None]).astype(np.float32)


def _rotation(deg, tx, ty, hw=64):
    c = (hw - 1) / 2
    th_ = np.deg2rad(deg)
    r = np.array([[np.cos(th_), -np.sin(th_), 0], [np.sin(th_), np.cos(th_),
                                                     0], [0, 0, 1]])
    t = np.array([[1, 0, c + tx], [0, 1, c + ty], [0, 0, 1]])
    t0 = np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1]])
    return (t @ r @ t0).astype(np.float32)


def _perspective(seed):
    src, dst = _points(seed, b=1, jitter=5.0)
    return np.asarray(jh.get_perspective_transform(src, dst))[0]


HOMOGRAPHIES = {
    "identity": np.eye(3, dtype=np.float32),
    "rotated": _rotation(1.5, 6.0, -4.0),
    "perspective": _perspective(3),
    "border": _rotation(20.0, 18.0, -11.0),
}


def _warp_pair(hm, x, dsize=None):
    b = x.shape[0]
    m = np.tile(hm[None], (b, 1, 1))
    got = th.warp_perspective(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
        torch.from_numpy(m), dsize)
    want = np.asarray(jh.warp_perspective(jnp.asarray(x), jnp.asarray(m),
                                          dsize))
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("name", list(HOMOGRAPHIES))
def test_warp_perspective_matches_jax(name):
    x = _smooth(4)
    got, want = _warp_pair(HOMOGRAPHIES[name], x)
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if name == "identity":
        np.testing.assert_array_equal(got, x)
    if name == "border":
        # part of the output samples outside the source: zero padding
        assert (want == 0).all(axis=-1).mean() > 0.05
        np.testing.assert_array_equal(got[want == 0], 0.0)


def test_warp_perspective_output_size_matches_jax():
    got, want = _warp_pair(HOMOGRAPHIES["rotated"], _smooth(5), (48, 80))
    assert got.shape == want.shape == (2, 48, 80, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_full_warp_is_not_the_codec_warp():
    """The package-level name stays the codec's banded warp (a tuple of
    the bf16 warp and its overflow count)."""
    x = torch.from_numpy(_smooth(6).transpose(0, 3, 1, 2).copy())
    m = torch.from_numpy(np.tile(HOMOGRAPHIES["rotated"][None], (2, 1, 1)))
    banded, overflow = codec_warp(x, m)
    full = th.warp_perspective(x, m)
    assert int(overflow) == 0 and banded.shape == full.shape
    assert not torch.equal(banded, full)


@pytest.mark.parametrize("scale_h,scale_w", [(2.0, None), (4.0, 2.0),
                                             (0.5, 0.25)])
def test_upscale_homography_matches_jax(scale_h, scale_w):
    hm = np.stack([HOMOGRAPHIES["rotated"], HOMOGRAPHIES["perspective"]])
    got = th.upscale_homography(torch.from_numpy(hm), scale_h,
                                scale_w).numpy()
    want = np.asarray(jh.upscale_homography(hm, scale_h, scale_w))
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)
