"""Port: stage 2 (hesic_tpu_torch/models/hesic.py ``IndependentEnhancement``
and ``HESICTogether``, hesic_plus.py ``HESICPlusTogether``, dsic.py
``IndependentEnhancementNoWarp`` and ``DSICPlus``) and the Together codecs
(models/base.py ``TogetherCodec``: ``HESICTogetherCodec``,
``HESICPlusTogetherCodec``, ``DSICPlusCodec``) against the JAX package, on
the CPU, at the JAX tests' tiny configs (HESIC N16/M24/K2, HESIC+ N16/M24,
DSIC N16/M24/F6/C4/K2; 64x64, float32), the JAX parameters carried over by
hesic_from_jax (strict load).

* The enhancement nets alone, on random reconstructions at a rotated
  homography (B=2), and each Together model's forward, eval and training
  (both sides' noise from one numpy sequence, test_torch_training's
  ``Noise``, in m1's draw order): x1_hat/x2_hat within OUT_REL = 1e-4 of
  the largest |value| (float32 convs summed in another order; the
  enhancement's 20 random-weight convs amplify inputs in [0, 1] to ~50:
  measured 1e-5), likelihoods within ATOL = 2e-5.
* Each Together codec: ``update`` names the inner codec's tables under
  ``m1/``; a round trip's ``x*_hat_base`` is bit-equal to the inner
  codec's own decode of the same container, and ``x*_hat`` bit-equal to
  ``model.enhance`` on the base as contiguous NCHW tensors (tolerance 0:
  the same programs on the same inputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.models as jm
import hesic_tpu.models.dsic as jdsic
import hesic_tpu.models.hesic as jhesic
import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.models.base import CompressionModel as JCompressionModel
from hesic_tpu_torch.models.dsic import (DSICPlus,
                                         IndependentEnhancementNoWarp)
from hesic_tpu_torch.models.dsic_codec import DSICCodec, DSICPlusCodec
from hesic_tpu_torch.models.hesic import (HESICTogether,
                                          IndependentEnhancement)
from hesic_tpu_torch.models.hesic_codec import (HESICCodec,
                                                HESICTogetherCodec)
from hesic_tpu_torch.models.hesic_plus import HESICPlusTogether
from hesic_tpu_torch.models.hesic_plus_codec import (HESICPlusCodec,
                                                     HESICPlusTogetherCodec)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
OUT_REL = 1e-4
HW = 64


def _z(b=2):
    return (16, 1, b * (HW // 64) ** 2)


def _y(b=2):
    return (b, HW // 16, HW // 16, 24)


# name: (JAX model, port model, takes H, m1's training draws, port codec,
# its inner codec)
CASES = {
    "hesic-together": (
        lambda: jm.HESICTogether(N=16, M=24, K=2),
        lambda: HESICTogether(N=16, M=24, K=2, device="cpu"), True,
        [_z(), _y(), _y(), _z(), _y()], HESICTogetherCodec, HESICCodec),
    "hesic-plus-together": (
        lambda: jm.HESICPlusTogether(N=16, M=24),
        lambda: HESICPlusTogether(N=16, M=24, device="cpu"), True,
        [_z(), _y(), _y(), _z(), _y(), _y(), _y()], HESICPlusTogetherCodec,
        HESICPlusCodec),
    "dsic-plus": (
        lambda: jm.DSICPlus(N=16, M=24, F=6, C=4, K=2),
        lambda: DSICPlus(N=16, M=24, F=6, C=4, K=2, device="cpu"), False,
        [_z(), _y(), _z(), _y()], DSICPlusCodec, DSICCodec),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.array(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close_rel(got, want, key):
    """Within OUT_REL of the largest |want|."""
    assert got.shape == want.shape, key
    assert np.abs(got - want).max() <= OUT_REL * np.abs(want).max(), key


def _rotated(b=2, deg=3.0, tx=2.0, ty=-1.5):
    th = np.deg2rad(deg)
    h = np.array([[np.cos(th), -np.sin(th), tx],
                  [np.sin(th), np.cos(th), ty], [0, 0, 1]], np.float32)
    return np.tile(h[None], (b, 1, 1))


def _pairs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, HW, HW, 3).astype(np.float32),
            rng.rand(b, HW, HW, 3).astype(np.float32))


@pytest.fixture(scope="module")
def built():
    """name -> (JAX module, numpy params, port model), each built once."""
    cache = {}

    def get(name):
        if name not in cache:
            j_make, t_make, takes_h = CASES[name][:3]
            module = j_make()
            shapes = [(1, HW, HW, 3)] * 2 + ([(1, 3, 3)] if takes_h else [])
            params = jax.tree_util.tree_map(np.asarray, JCompressionModel.init(
                module, shapes, seed=0).params)
            tm = t_make()
            tm.load_state_dict(hesic_from_jax(params, tm))
            cache[name] = (module, params, tm)
        return cache[name]

    return get


@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


# ---- the enhancement nets ----

@pytest.mark.parametrize("warp", [True, False],
                         ids=["IndependentEnhancement",
                              "IndependentEnhancementNoWarp"])
def test_enhancement_matches_jax(warp):
    x1, x2 = _pairs(seed=1)
    args = (x1, x2, _rotated()) if warp else (x1, x2)
    jmod = (jhesic.IndependentEnhancement() if warp
            else jdsic.IndependentEnhancementNoWarp())
    jargs = [jnp.asarray(a) for a in args]
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), *jargs)["params"])
    tm = IndependentEnhancement() if warp else IndependentEnhancementNoWarp()
    tm.load_state_dict(hesic_from_jax(params, tm))
    want = jmod.apply({"params": params}, *jargs)
    targs = [_nchw(x1), _nchw(x2)] + ([torch.from_numpy(args[2])]
                                      if warp else [])
    with torch.no_grad():
        got = tm(*targs)
    for key in ("x1_hat", "x2_hat"):
        _close_rel(_nhwc(got[key]), np.asarray(want[key]), key)


# ---- the Together models ----

@pytest.mark.parametrize("name", list(CASES))
def test_from_jax_maps_every_parameter(built, name):
    _, params, tm = built(name)
    sd = hesic_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    assert {k.split(".")[0] for k in sd} == {"m1", "m2"}
    assert tm.entropy_bottlenecks == ("m1/entropy_bottleneck1",
                                      "m1/entropy_bottleneck2")


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(built, noise, name, training):
    module, params, tm = built(name)
    takes_h, draws = CASES[name][2:4]
    x1, x2 = _pairs()
    h = _rotated()
    jargs = [jnp.asarray(x1), jnp.asarray(x2)] + ([jnp.asarray(h)]
                                                  if takes_h else [])
    noise.fed = noise.feed(draws if training else [])
    want = jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, training=training,
        rngs={"noise": jax.random.PRNGKey(0)}))(params, *jargs)
    targs = [_nchw(x1), _nchw(x2)] + ([torch.from_numpy(h)]
                                      if takes_h else [])
    with torch.no_grad():
        got = tm(*targs, training=training,
                 generator=torch.Generator().manual_seed(0))
    assert not noise.fed
    for key in ("x1_hat", "x2_hat"):
        _close_rel(_nhwc(got[key]), np.asarray(want[key]), key)
    for key, w in want["likelihoods"].items():
        np.testing.assert_allclose(_nhwc(got["likelihoods"][key]),
                                   np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=key)


def test_aux_loss_is_m1s(built):
    _, _, tm = built("hesic-together")
    assert float(tm.aux_loss()) == float(tm.m1.aux_loss())


# ---- the Together codecs ----

def _round_trip(cdc, takes_h, x1, x2, h, tmp_path, name):
    args = (x1, x2, h) if takes_h else (x1, x2)
    if isinstance(cdc.inner, HESICPlusCodec):
        blob = cdc.compress(*args)["strings"][0]
        return (lambda c: c.decompress(blob))
    cdc.compress(*args, name, str(tmp_path))
    return lambda c: c.decompress(name, str(tmp_path))


@pytest.mark.parametrize("name", list(CASES))
def test_codec_base_is_the_inner_codecs_decode(built, name, tmp_path):
    _, _, tm = built(name)
    takes_h, _, codec_cls, inner_cls = CASES[name][2:]
    cdc = codec_cls(tm).update()
    assert isinstance(cdc.inner, inner_cls) and cdc.inner.model is tm.m1
    assert set(cdc.tables) == {f"m1/{k}" for k in cdc.inner.tables}
    x1, x2 = _pairs(seed=2, b=1)
    decode = _round_trip(cdc, takes_h, x1, x2, _rotated(1), tmp_path, name)
    rec = decode(cdc)
    ref = decode(inner_cls(tm.m1).update())
    for eye in ("x1_hat", "x2_hat"):
        assert torch.equal(rec[f"{eye}_base"], ref[eye]), eye
    # contiguous NCHW, as the codec hands them over (a CPU convolution's
    # result can depend on its input's strides)
    base = [rec[f"{e}_hat_base"].permute(0, 3, 1, 2).contiguous()
            for e in ("x1", "x2")]
    if takes_h:
        base.append(torch.from_numpy(np.asarray(rec["h_matrix"],
                                                np.float32)))
    with torch.no_grad():
        enh = tm.enhance(*base)
    for eye in ("x1_hat", "x2_hat"):
        assert torch.equal(rec[eye], enh[eye].permute(0, 2, 3, 1)), eye
        assert not torch.equal(rec[eye], rec[f"{eye}_base"])
