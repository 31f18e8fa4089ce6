"""Port: HESIC's codec sub-programs and the codec warp against the JAX
package, at the tiny config (N=16, M=24, K=2, 64x64), with the JAX
parameters carried over by hesic_from_jax (strict load: every parameter
maps).  float32 on the CPU.  Tolerances: sub-programs atol 2e-5 (measured
<= 4.1e-6 on outputs of magnitude ~4); bilinear x4 upsample (two
interpolation-matrix products) atol 1e-6 against jax.image.resize and
F.interpolate, its gradient atol 1e-6 against JAX's vjp, and in bf16
within two bf16 ulps of the float32 result.
The warp's overflow counts must be identical.  Its sampling coordinates
differ from XLA:CPU's in the last bit (XLA contracts the projective
transform's mul+add into FMAs), so the float32 warp is held to atol 1e-5
(measured 3.6e-6); in the codec's bf16 mode such a last-bit difference
can flip the bf16 rounding of a bilinear weight (2^-8 of a weight times
a pixel difference), so it is held to atol 1e-3 on all elements and
atol 1e-5 on all but 1% of them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.geometry.fast_warp import (pick_warp_win as j_pick_win,
                                          pick_warp_xwin as j_pick_xwin,
                                          warp_perspective_mxu)
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models.base import CompressionModel
from hesic_tpu_torch.geometry import (pick_warp_win, pick_warp_xwin,
                                      warp_perspective)
from hesic_tpu_torch.models.hesic import HESIC, upsample4
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jm = JHESIC(N=16, M=24, K=2)
    cm = CompressionModel.init(jm, [(1, 64, 64, 3), (1, 64, 64, 3),
                                    (1, 3, 3)], seed=0)
    params = jax.tree_util.tree_map(np.asarray, cm.params)
    tm = HESIC(N=16, M=24, K=2, device="cpu")
    tm.load_state_dict(hesic_from_jax(params, tm))
    return jm, params, tm


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(2, 64, 64, 3).astype(np.float32),
            rng.rand(2, 64, 64, 3).astype(np.float32))


def _apply(jm, params, method, *args):
    out = jm.apply({"params": params}, *[jnp.asarray(a) for a in args],
                   method=method)
    return [np.asarray(o) for o in out] if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.mark.parametrize("method", [
    "analysis1", "analysis2", "hyper_analysis1", "synthesis1",
    "synthesis2", "gmm1", "gmm2"])
def test_sub_program_matches_jax(models, method):
    jm, params, tm = models
    x1, x2 = _inputs()
    y1 = _apply(jm, params, "analysis1", x1)
    y1_hat = np.round(y1)
    z1_hat = np.round(_apply(jm, params, "hyper_analysis1", y1))
    args = {"analysis1": (x1,), "analysis2": (x1, x2),
            "hyper_analysis1": (y1,), "synthesis1": (y1_hat,),
            "synthesis2": (y1_hat, x1), "gmm1": (z1_hat,),
            "gmm2": (z1_hat, y1_hat)}[method]
    want = _apply(jm, params, method, *args)
    got = getattr(tm, method)(*[_nchw(a) for a in args])
    if isinstance(want, list):           # the three GMM heads
        for w, g in zip(want, got):
            assert w.shape == _nhwc(g).shape
            np.testing.assert_allclose(_nhwc(g), w, atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=0)


def test_upsample4_matches_jax_image_resize():
    z = np.random.RandomState(1).randn(2, 3, 5, 4).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(z), (2, 12, 20, 4),
                                       "bilinear"))
    np.testing.assert_allclose(_nhwc(upsample4(_nchw(z))), want, atol=1e-6,
                               rtol=0)


def test_upsample4_matches_f_interpolate():
    """The matrix form against PyTorch's own half-pixel bilinear
    interpolation: float32 within 1e-6; bf16 within two bf16 ulps of the
    float32 result on the same (bf16) input, since the two products round
    to bf16 once each (the weights are exact in bf16).  The ulp is taken
    at the scale of the values combined, the float32 upsampling of |z|:
    where neighbours of opposite sign cancel, the first product's rounding
    is an error relative to them, not to the small result (measured 1.10
    such ulps)."""
    z = torch.from_numpy(
        np.random.RandomState(2).randn(2, 5, 6, 7).astype(np.float32) * 3)
    want = torch.nn.functional.interpolate(z, scale_factor=4,
                                           mode="bilinear",
                                           align_corners=False)
    got = upsample4(z)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    zb = z.to(torch.bfloat16)
    ref = upsample4(zb.float())
    out = upsample4(zb)
    assert out.dtype == torch.bfloat16
    scale = upsample4(zb.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
    assert bool(((out.float() - ref).abs() <= 2 * ulp).all())


def test_upsample4_gradient_matches_jax_vjp():
    """The backward (two transposed matrix products, no atomics) against
    JAX's vjp of jax.image.resize on a seeded cotangent, float32."""
    rng = np.random.RandomState(3)
    z = rng.randn(2, 3, 5, 4).astype(np.float32)
    ct = rng.randn(2, 12, 20, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, 12, 20, 4),
                                                "bilinear"), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(ct))
    zt = _nchw(z).requires_grad_(True)
    upsample4(zt).backward(_nchw(ct))
    np.testing.assert_allclose(_nhwc(zt.grad), np.asarray(want), atol=1e-6,
                               rtol=0)


def _homography(deg, tx, ty):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th), tx],
                     [np.sin(th), np.cos(th), ty], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("deg,win,overflows", [
    (1.5, 16, False), (20.0, 16, True), (20.0, 64, False),
    (0.0, 32, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_warp_matches_mxu_warp(deg, win, overflows, bf16):
    x1, _ = _inputs(2)
    h = np.tile(_homography(deg, 6.0, -4.0)[None], (2, 1, 1))
    want, ovf_j = warp_perspective_mxu(
        jnp.asarray(x1), jnp.asarray(h), (64, 64), win,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    got, ovf_t = warp_perspective(
        _nchw(x1), torch.from_numpy(h), win,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    diff = np.abs(_nhwc(got) - np.asarray(want))
    if bf16:
        assert diff.max() <= 1e-3 and (diff > 1e-5).mean() < 0.01
    else:
        assert diff.max() <= 1e-5
    assert int(ovf_t) == int(ovf_j)
    assert (int(ovf_t) > 0) == overflows


@pytest.mark.parametrize("deg,tx,ty,size", [
    (0.0, 0.0, 0.0, 64), (1.5, 6.0, -4.0, 512), (8.0, -20.0, 9.0, 256),
    (0.3, 130.0, 0.0, 512)])
def test_warp_windows_equal_jax(deg, tx, ty, size):
    h = np.tile(_homography(deg, tx, ty)[None], (3, 1, 1))
    assert pick_warp_win(h, size, size) == j_pick_win(h, size, size)
    assert pick_warp_xwin(h, size, size) == j_pick_xwin(h, size, size)
