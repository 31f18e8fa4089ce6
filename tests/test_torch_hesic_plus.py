"""Port: HESIC+ (hesic_tpu_torch/models/hesic_plus.py), its
autoregressive weights and its wavefront device codec
(hesic_tpu_torch/models/ar_device.py) against the JAX package, on the
CPU, at tests/test_ar_device.py's config: N=16, M=24, 64x64 pairs, B=2,
mm 8, 4 channel groups, float32, the JAX parameters carried over by
hesic_from_jax (strict load: every parameter maps, by module type).

* Sub-programs: atol 2e-5, as tests/test_torch_hesic.py (float32 convs
  summed in another order; outputs of magnitude ~1-10).
* extract_ar_weights: equal (transposes and the mask product are exact).
* The port's compress -> decompress: decoded latents equal the encoder's
  (the identity H, a rotated H, and an mm=1 case whose residuals escape
  the grid in both eyes).
* Against JAX's HESICPlusDeviceCodec on the same inputs and weights: the
  latents agree within 1e-4 on every cell not within 1e-4 of a rounding
  boundary (the means come from the same float32 chain computed in
  another order: measured <= 2.2e-6), and bpp_real within 1% (the
  backends' Phi differ in the last bits, which moves frequencies by a
  count or two; measured equal).
* The backend byte: a container of another backend is refused, naming
  both.
* The pairs encoder launches once per eye, and the containers do not
  depend on the codec's initial word cap.
* HESIC's carry-over gives the same state_dict as the name rule it
  replaced.
* The training forward (eval and training, identity and rotated H),
  its likelihoods, and the loss and gradients of bench.py's calibration
  loss (stereo RD loss + aux loss) against the JAX package under one
  noise sequence (test_torch_training.py's ``Noise``, drawn in the JAX
  forward's order: z1, y1_hat, the first Gaussian conditional, z2, the
  re-encoded warped left reconstruction, y2_hat, the second
  conditional): tensors atol 2e-5, scalar sums rtol 1e-6, gradients per
  tensor max |d| <= 1e-4 x max |g_jax|, as tests/test_torch_training.py;
  left_prior and aux_loss atol 2e-5 and rtol 1e-6.  The bf16 model's
  loss within rtol 2e-2 of JAX's bf16 model.
* A calibrated model (training.recipe.calibrate, two steps at 64x64)
  round-trips exactly through the device codec.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models import HESICPlus as JHESICPlus
from hesic_tpu.models import HESICPlusCodec
from hesic_tpu.models import HESICPlusDeviceCodec as JDeviceCodec
from hesic_tpu.models.autoregressive import (
    extract_ar_weights as j_extract_ar_weights)
from hesic_tpu.models.base import CompressionModel as JCompressionModel
from hesic_tpu_torch.codecs import pairs_rans
from hesic_tpu_torch.geometry import warp_perspective
from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
from hesic_tpu_torch.models.autoregressive import extract_ar_weights
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu.training import stereo_rate_distortion_loss as j_stereo_loss
from hesic_tpu_torch.models.hesic_plus import HESICPlus
from hesic_tpu_torch.training import make_loss_fn
from hesic_tpu_torch.training.recipe import calibrate
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
SCALAR_RTOL = 1e-6
GRAD_REL = 1e-4
LMBDA = 1e-2
SHAPES = [(2, 64, 64, 3), (2, 64, 64, 3), (2, 3, 3)]


@pytest.fixture(scope="module")
def models():
    base = HESICPlusCodec.init(JHESICPlus(N=16, M=24), SHAPES, seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    model = HESICPlus(N=16, M=24, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return base, params, model


def _pair(b=2, seed=5, deg=0.0, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    x1 = (rng.rand(b, 64, 64, 3) * scale + shift).astype(np.float32)
    x2 = (rng.rand(b, 64, 64, 3) * scale + shift).astype(np.float32)
    th = np.deg2rad(deg)
    h = np.array([[np.cos(th), -np.sin(th), 3.0 if deg else 0.0],
                  [np.sin(th), np.cos(th), -2.0 if deg else 0.0],
                  [0, 0, 1]], np.float32)
    return x1, x2, np.tile(h[None], (b, 1, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (method, input shapes NHWC): every codec-facing sub-program
SUBPROGRAMS = [
    ("analysis1", [(2, 64, 64, 3)]),
    ("analysis2", [(2, 64, 64, 3), (2, 64, 64, 3)]),
    ("synthesis1", [(2, 4, 4, 24)]),
    ("synthesis2", [(2, 4, 4, 24), (2, 64, 64, 3)]),
    ("hyper_analysis1", [(2, 4, 4, 24)]),
    ("hyper_analysis2", [(2, 4, 4, 24)]),
    ("hyper_synthesis1", [(2, 1, 1, 16)]),
    ("hyper_synthesis2", [(2, 1, 1, 16)]),
    ("entropy_params1", [(2, 4, 4, 96)]),
    ("entropy_params2", [(2, 4, 4, 120)]),
    ("context_prediction1", [(2, 4, 4, 24)]),
    ("context_prediction2", [(2, 4, 4, 24)]),
]


@pytest.mark.parametrize("method,shapes", SUBPROGRAMS,
                         ids=[s[0] for s in SUBPROGRAMS])
def test_subprograms_match_flax(models, method, shapes):
    base, params, model = models
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    if method.startswith("context_prediction"):
        def fn(mod, x):
            return getattr(mod, method)(x)
    else:
        fn = method
    want = np.asarray(base.module.apply(
        {"params": base.params}, *[jnp.asarray(x) for x in xs], method=fn))
    got = getattr(model, method)(*[_nchw(x) for x in xs])
    got = got.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("eye", [1, 2])
def test_extract_ar_weights_equals_jax(models, eye):
    base, _, model = models
    want = j_extract_ar_weights(base.params, f"context_prediction{eye}",
                                f"entropy_parameters{eye}")
    got = extract_ar_weights(model, f"context_prediction{eye}",
                             f"entropy_parameters{eye}")
    np.testing.assert_array_equal(got.ctx_kernel.numpy(),
                                  np.asarray(want.ctx_kernel))
    np.testing.assert_array_equal(got.ctx_bias.numpy(),
                                  np.asarray(want.ctx_bias))
    for a, b in zip(got.ep_kernels + got.ep_biases,
                    want.ep_kernels + want.ep_biases):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def codec(models):
    return HESICPlusDeviceCodec(models[2], mm=8, groups=4).update()


@pytest.mark.parametrize("deg", [0.0, 6.0])
def test_roundtrip_bit_exact(codec, deg):
    x1, x2, h = _pair(deg=deg)
    out = codec.compress(x1, x2, h)
    assert 0 < out["bpp_real"] < 64
    rec = codec.decompress(out["strings"])
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], out[key], rtol=0, atol=0)
    for key in ("x1_hat", "x2_hat"):
        assert tuple(rec[key].shape) == x1.shape
        assert torch.isfinite(rec[key]).all()


def test_pairs_encoder_launches_once_per_eye(codec, monkeypatch):
    calls = []
    encode = pairs_rans.rans_encode_pairs

    def counted(starts, freqs, valid, cap):
        calls.append(cap)
        return encode(starts, freqs, valid, cap)

    monkeypatch.setattr(pairs_rans, "rans_encode_pairs", counted)
    x1, x2, h = _pair(seed=6)
    out = codec.compress(x1, x2, h)
    t_slots = codec.groups * (3 * (4 - 1) + (4 - 1) + 1)
    assert calls == [t_slots, t_slots]
    rec = codec.decompress(out["strings"])
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], out[key], rtol=0, atol=0)


def test_containers_do_not_depend_on_the_cap(models, codec):
    """cap is the JAX class's argument only: a cap below the counts (8),
    the codec path's 64 and 4096 give the same bytes, and a codec of cap
    8 decodes them (its word buffer is as wide as the largest count)."""
    x1, x2, h = _pair(seed=7)
    codecs = {cap: HESICPlusDeviceCodec(models[2], mm=8, groups=4,
                                        cap=cap).update()
              for cap in (8, 64, 4096)}
    outs = {cap: c.compress(x1, x2, h) for cap, c in codecs.items()}
    assert outs[8]["strings"] == outs[64]["strings"] == outs[4096]["strings"]
    rec = codecs[8].decompress(outs[4096]["strings"])
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], outs[8][key], rtol=0, atol=0)


def test_escape_corrections_roundtrip(models):
    """mm=1 forces out-of-grid residuals in both eyes through the exact
    side-channels, which must feed each recursion mid-scan."""
    hot = HESICPlusDeviceCodec(models[2], mm=1, groups=4).update()
    x1, x2, h = _pair(b=1, seed=11, scale=4.0, shift=-1.5)
    out = hot.compress(x1, x2, h)
    blob = out["strings"][0]
    # eye 1's escape count follows the 1 B backend byte + 5 x u32 header
    (n_esc1,) = np.frombuffer(blob, np.uint32, 1, 21)
    assert n_esc1 > 0 and out["escapes"][0] == n_esc1
    assert out["escapes"][1] > 0
    rec = hot.decompress(out["strings"])
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], out[key], rtol=0, atol=0)


def _margin(raw, y_hat, eps):
    """Cells whose unrounded residual lies within eps of a .5 boundary:
    y - y_hat is the residual's rounding error (y_hat = resid + mean)."""
    return np.abs(np.abs(raw - y_hat) - 0.5) < eps


@pytest.mark.parametrize("deg", [0.0, 6.0])
def test_matches_jax_codec(models, codec, deg):
    base, _, model = models
    x1, x2, h = _pair(deg=deg)
    j_out = JDeviceCodec(base, mm=8, groups=4).compress(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(h))
    t_out = codec.compress(x1, x2, h)
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.01
    with torch.no_grad():
        x1t, x2t = _nchw(x1), _nchw(x2)
        warped, _ = warp_perspective(x1t, torch.from_numpy(h), 64)
        raws = {"y1_hat": model.analysis1(x1t),
                "y2_hat": model.analysis2(warped, x2t)}
    for key, raw in raws.items():
        ty = t_out[key].numpy()
        jy = np.asarray(j_out[key])
        keep = ~_margin(raw.numpy().transpose(0, 2, 3, 1), ty, 1e-4)
        assert keep.mean() > 0.95
        np.testing.assert_allclose(ty[keep], jy[keep], atol=1e-4, rtol=0)


@pytest.mark.parametrize("tag", [0, 2, 4, 5])
def test_backend_mismatch_raises(codec, tag):
    names = {0: "xla-scan", 2: "pallas-level-scan", 4: "cuda-level-scan",
             5: "cuda-level-scan-cluster"}
    blob = bytes([tag]) + b"\0" * 40
    with pytest.raises(ValueError) as err:
        codec.decompress([blob])
    assert names[tag] in str(err.value)
    assert "torch-plain-level-scan" in str(err.value)


def _name_rule(params_np):
    """The carry-over rule hesic_from_jax applied before it looked up
    module types: the parent's name prefix decides conv vs deconv."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            p = path + (key,)
            if hasattr(val, "items"):
                walk(val, p)
                continue
            v = np.asarray(val, np.float32)
            parent = p[-2] if len(p) > 1 else ""
            if key == "kernel" and parent.startswith("Conv_"):
                key, v = "weight", v.transpose(3, 2, 0, 1)
            elif key == "kernel" and parent.startswith("Deconv_"):
                key, v = "weight", np.flip(v.transpose(2, 3, 0, 1), (2, 3))
            out[".".join(p[:-1] + (key,))] = v
    walk(params_np, ())
    return out


def test_hesic_carry_over_unchanged():
    cm = JCompressionModel.init(JHESIC(N=16, M=24, K=2),
                                [(1, 64, 64, 3), (1, 64, 64, 3),
                                 (1, 3, 3)], seed=0)
    params = jax.tree_util.tree_map(np.asarray, cm.params)
    model = HESIC(N=16, M=24, K=2, device="cpu")
    got = hesic_from_jax(params, model)
    want = _name_rule(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_kernel_without_conv_module_raises(models):
    _, params, _ = models
    with pytest.raises(ValueError, match="no conv module"):
        hesic_from_jax({"h_a1_0": params["h_a1_0"]}, torch.nn.Module())


# ---- the training forward ----

@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


def _noise_shapes(b=2, hw=64, n=16, m=24):
    """The seven draws of HESIC+'s training forward, in JAX's layout."""
    z = (n, 1, b * (hw // 64) ** 2)
    y = (b, hw // 16, hw // 16, m)
    return [z, y, y, z, y, y, y]


def _close(got, want, key, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy().transpose(
        0, 2, 3, 1), np.asarray(want), atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize("deg,training", [(0.0, True), (6.0, True),
                                          (0.0, False)])
def test_forward_matches_jax(models, noise, deg, training):
    base, params, model = models
    x1, x2, h = _pair(seed=12, deg=deg)
    noise.fed = noise.feed(_noise_shapes() if training else [])
    want = jax.jit(lambda p, a, b, c: base.module.apply(
        {"params": p}, a, b, c, training=training,
        rngs={"noise": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(h))
    with torch.no_grad():
        got = model(_nchw(x1), _nchw(x2), torch.from_numpy(h),
                    training=training,
                    generator=torch.Generator().manual_seed(0))
    assert not noise.fed        # JAX took every draw it was fed
    for key in ("x1_hat", "x2_hat", "y1_hat", "y2_hat"):
        _close(got[key], want[key], key)
    for key in ("y1", "y2", "z1", "z2"):
        _close(got["likelihoods"][key], want["likelihoods"][key], key)


def test_left_prior_and_aux_loss_match_jax(models):
    base, params, model = models
    x1, _, h = _pair(seed=13, deg=6.0)
    want = base.module.apply({"params": params}, jnp.asarray(x1),
                             jnp.asarray(h), method="left_prior")
    with torch.no_grad():
        got = model.left_prior(_nchw(x1), torch.from_numpy(h))
    _close(got, want, "left_prior")
    np.testing.assert_allclose(
        float(model.aux_loss()),
        float(base.module.apply({"params": params}, method="aux_loss")),
        rtol=SCALAR_RTOL)


def _jax_loss_fn(module, params, batch, rng, noise):
    """bench.py's _calibrate loss: stereo RD loss + aux loss."""
    noise.fed = list(batch["noise"])
    out = module.apply({"params": params}, batch["x1"], batch["x2"],
                       batch["h"], training=True, rngs={"noise": rng})
    rd = j_stereo_loss(out, batch["x1"], batch["x2"], lmbda=LMBDA)
    aux = module.apply({"params": params}, method="aux_loss")
    return rd["loss"] + aux, {"bpp": rd["bpp_loss"], "mse": rd["mse_loss"]}


def _jax_loss(module, params, noise, grad: bool):
    x1, x2, h = _pair(seed=14, deg=6.0)
    batch = {"x1": jnp.asarray(x1), "x2": jnp.asarray(x2),
             "h": jnp.asarray(h), "noise": noise.feed(_noise_shapes())}
    fn = lambda p, b: _jax_loss_fn(module, p, b,  # noqa: E731
                                   jax.random.PRNGKey(0), noise)
    if grad:
        fn = jax.value_and_grad(fn, has_aux=True)
    return jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, params), batch)


def _port_loss(model):
    x1, x2, h = _pair(seed=14, deg=6.0)
    return make_loss_fn(LMBDA)(
        model, {"x1": _nchw(x1), "x2": _nchw(x2), "h": torch.from_numpy(h)},
        torch.Generator().manual_seed(0))


def test_loss_and_gradients_match_jax(models, noise):
    base, params, model = models
    (want_loss, _), grads = _jax_loss(base.module, params, noise, True)
    model = copy.deepcopy(model).requires_grad_(True)
    loss, _ = _port_loss(model)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=SCALAR_RTOL)
    want = hesic_from_jax(jax.tree_util.tree_map(np.asarray, grads), model)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        limit = GRAD_REL * float(g.abs().max())
        err = float((got[name].grad - g).abs().max())
        assert err <= limit, (name, err, limit)


def test_bf16_loss_matches_jax(models, noise):
    _, params, model = models
    want_loss, want = _jax_loss(JHESICPlus(N=16, M=24, dtype=jnp.bfloat16),
                                params, noise, False)
    bf = HESICPlus(N=16, M=24, dtype=torch.bfloat16, device="cpu")
    bf.load_state_dict(model.state_dict())
    with torch.no_grad():
        got_loss, got = _port_loss(bf)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=2e-2)
    for key in ("bpp", "mse"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-2, err_msg=key)


def test_calibrated_round_trip_exact(models):
    model = copy.deepcopy(models[2])
    losses, _ = calibrate(model, np.random.RandomState(0), steps=2, hw=64,
                          batch=2)
    assert np.isfinite(losses).all()
    model.requires_grad_(False)
    cal = HESICPlusDeviceCodec(model, mm=8, groups=4).update()
    x1, x2, h = _pair(seed=15, deg=6.0)
    out = cal.compress(x1, x2, h)
    rec = cal.decompress(out["strings"])
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], out[key], rtol=0, atol=0)
