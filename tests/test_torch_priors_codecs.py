"""Port: the CompressAI priors (hesic_tpu_torch/models/priors.py
``FactorizedPrior``, ``ScaleHyperprior``, ``MeanScaleHyperprior``) and
their host codecs (hesic_tpu_torch/models/codec.py) against the JAX
package, on the CPU, at tests/test_models.py's config (N=32, M=48,
64x64, batch 2, float32), the JAX parameters carried over by
hesic_from_jax (strict load: every parameter maps, by module type).

* Forwards in eval and in training, both packages taking their noise
  from one numpy sequence (test_torch_training.py's ``Noise``) in JAX's
  draw order (the factorized prior: y in the bottleneck; the
  hyperpriors: z in the bottleneck, then y in the Gaussian conditional):
  x_hat and every likelihood within atol 2e-5 (float32 convs summed in
  another order; the JAX tests' tolerance).  The aux loss within rtol
  1e-6.
* The port's codecs round-trip exactly (decoded y_hat equal to the
  encoder's); the factorized prior's y_hat is round(y - medians) +
  medians of the port's own analysis, the hyperpriors' round(y - means)
  + means.
* y_hat equals the JAX codec's decoded y_hat within 1e-4 on every cell
  whose y - means is not within 1e-4 of a rounding boundary (at least
  95% of the cells), and bpp_real is within 2% of JAX's (the tables are
  float math: test_torch_host_ar.py has their bound).
* At the coder layer, on the JAX side's z, y, indexes and means and
  with JAX's tables, the port's z and y strings are byte-identical to
  JAX's and each side decodes the other's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.models as jmodels
import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.entropy_models import build_indexes as j_build_indexes
from hesic_tpu_torch.entropy_models import build_indexes
from hesic_tpu_torch.models import codec, priors
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
CFG = dict(N=32, M=48)
B, HW = 2, 64
NAMES = {"factorized": ("FactorizedPrior", "FactorizedPriorCodec"),
         "hyperprior": ("ScaleHyperprior", "ScaleHyperpriorCodec"),
         "mean-scale": ("MeanScaleHyperprior", "MeanScaleHyperpriorCodec")}


@pytest.fixture(scope="module", params=list(NAMES))
def pair(request):
    """(name, the JAX codec after update, the port's model, the port's
    codec after update)."""
    model_name, codec_name = NAMES[request.param]
    base = getattr(jmodels, codec_name).init(
        getattr(jmodels, model_name)(**CFG), [(1, HW, HW, 3)], seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    tm = getattr(priors, model_name)(**CFG, device="cpu")
    tm.load_state_dict(hesic_from_jax(params, tm))
    return (request.param, base, tm,
            getattr(codec, codec_name)(tm).update())


@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


def _images(seed=0):
    return np.random.RandomState(seed).rand(B, HW, HW, 3).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _noise_shapes(name):
    """The draws of the training forward, in JAX's layout."""
    lat = HW // 16
    y_eb = (CFG["M"], 1, B * lat * lat)
    z = (CFG["N"], 1, B * (HW // 64) ** 2)
    return [y_eb] if name == "factorized" else [z, (B, lat, lat, CFG["M"])]


def test_from_jax_maps_every_parameter(pair):
    name, base, tm, _ = pair
    sd = hesic_from_jax(jax.tree_util.tree_map(np.asarray, base.params), tm)
    assert set(sd) == set(tm.state_dict())
    assert tm.single_image and not tm.uses_homography
    assert tm.entropy_bottlenecks == ("entropy_bottleneck",)
    assert tm.gaussian_conditionals == (
        () if name == "factorized" else ("gaussian_conditional",))


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(pair, noise, training):
    name, base, tm, _ = pair
    x = _images()
    noise.fed = noise.feed(_noise_shapes(name) if training else [])
    want = base.module.apply({"params": base.params}, jnp.asarray(x),
                             training=training,
                             rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm(_nchw(x), training=training,
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_nhwc(got["x_hat"]),
                               np.asarray(want["x_hat"]), atol=ATOL, rtol=0)
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for key, lik in want["likelihoods"].items():
        np.testing.assert_allclose(_nhwc(got["likelihoods"][key]),
                                   np.asarray(lik), atol=ATOL, rtol=0,
                                   err_msg=key)
    assert not noise.fed        # JAX took every draw it was fed
    np.testing.assert_allclose(
        float(tm.aux_loss()),
        float(base.module.apply({"params": base.params},
                                method="aux_loss")), rtol=1e-6)


def _means(tm, cdc, strings, shape):
    """The decoder's means (None for the zero-mean priors)."""
    if len(strings) == 1:
        return None
    z_hat = cdc.eb_decompress("entropy_bottleneck", strings[1], shape)
    with torch.no_grad():
        return tm.gaussian_params(z_hat)[1]


@pytest.mark.parametrize("seed", [1, 2])
def test_round_trip_exact(pair, seed):
    name, _, tm, cdc = pair
    x = _images(seed)
    out = cdc.compress(x)
    rec = cdc.decompress(out["strings"], out["shape"])
    assert torch.equal(rec["y_hat"], out["y_hat"])
    assert rec["x_hat"].shape == x.shape
    assert float(rec["x_hat"].min()) >= 0 and float(rec["x_hat"].max()) <= 1
    assert len(out["strings"]) == (1 if name == "factorized" else 2)
    assert all(len(group) == B for group in out["strings"])
    with torch.no_grad():
        y = tm.analysis(_nchw(x))
    if name == "factorized":
        med = tm.entropy_bottleneck.medians()[None, :, None, None]
        want = torch.round(y - med) + med
    else:
        means = _means(tm, cdc, out["strings"], out["shape"])
        want = torch.round(y) if means is None else (
            torch.round(y - means) + means)
    assert torch.equal(out["y_hat"], want.permute(0, 2, 3, 1))


def _jax_y_hat(name, base, out):
    """The JAX codec's decoded y_hat (B, h, w, M)."""
    if name == "factorized":
        return np.asarray(base.eb_decompress(
            "entropy_bottleneck", out["strings"][0], out["shape"]))
    z_hat = base.eb_decompress("entropy_bottleneck", out["strings"][1],
                               out["shape"])
    gp = base.jit("hyper_synthesis")(z_hat)
    scales, means = (jnp.split(gp, 2, axis=-1) if name == "mean-scale"
                     else (gp, None))
    idx = j_build_indexes(scales, base.scale_table)
    return np.asarray(base.gc_decompress("gaussian_conditional",
                                         out["strings"][0], idx,
                                         means=means))


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_jax_codec(pair, seed):
    name, base, tm, cdc = pair
    x = _images(seed)
    j_out = base.compress(jnp.asarray(x))
    j_yhat = _jax_y_hat(name, base, j_out)
    out = cdc.compress(x)
    assert out["shape"] == tuple(j_out["shape"])
    j_bytes = sum(len(s) for group in j_out["strings"] for s in group)
    assert abs(out["bpp_real"] / (j_bytes * 8 / (B * HW * HW)) - 1) < 0.02
    ty = out["y_hat"].numpy()
    with torch.no_grad():
        raw = _nhwc(tm.analysis(_nchw(x)))
    # off the rounding margin: y - y_hat is the residual's rounding error
    keep = ~(np.abs(np.abs(raw - ty) - 0.5) < 1e-4)
    assert keep.mean() > 0.95
    np.testing.assert_allclose(ty[keep], j_yhat[keep], atol=1e-4, rtol=0)


def test_strings_byte_identical_to_jax(pair):
    """The coder layer: the JAX side's z, y, indexes and means, JAX's
    tables in both codecs."""
    name, base, tm, _ = pair
    cdc = type(pair[3])(tm).update()
    cdc.tables = dict(base.tables)
    x = jnp.asarray(_images(5))
    y = base.jit("analysis")(x)
    if name == "factorized":
        j_strs = base.eb_compress("entropy_bottleneck", y)
        t_strs = cdc.eb_compress("entropy_bottleneck", _nchw(y))
        assert t_strs == j_strs
        np.testing.assert_array_equal(
            _nhwc(cdc.eb_decompress("entropy_bottleneck", j_strs,
                                    y.shape[1:3])),
            np.asarray(base.eb_decompress("entropy_bottleneck", t_strs,
                                          y.shape[1:3])))
        return
    z = base.jit("hyper_analysis")(y)
    j_z = base.eb_compress("entropy_bottleneck", z)
    assert cdc.eb_compress("entropy_bottleneck", _nchw(z)) == j_z
    z_hat = base.eb_decompress("entropy_bottleneck", j_z, z.shape[1:3])
    gp = base.jit("hyper_synthesis")(z_hat)
    scales, means = (jnp.split(gp, 2, axis=-1) if name == "mean-scale"
                     else (gp, None))
    idx = j_build_indexes(scales, base.scale_table)
    j_strs = base.gc_compress("gaussian_conditional", y, idx, means=means)
    t_idx = build_indexes(_nchw(scales), cdc.scale_table)
    np.testing.assert_array_equal(_nhwc(t_idx), np.asarray(idx))
    t_means = None if means is None else _nchw(means)
    t_strs = cdc.gc_compress("gaussian_conditional", _nchw(y), t_idx,
                             t_means)
    assert t_strs == j_strs
    np.testing.assert_array_equal(
        _nhwc(cdc.gc_decompress("gaussian_conditional", j_strs, t_idx,
                                t_means)),
        np.asarray(base.gc_decompress("gaussian_conditional", t_strs, idx,
                                      means=means)))
