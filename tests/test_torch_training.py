"""Port: HESIC's training step against the JAX package, at the tiny config
(N=16, M=24, K=2, 64x64, batch 2), with the JAX parameters carried over by
hesic_from_jax.  float32 on the CPU unless stated.

Both sides take their training noise from one numpy sequence: the test
monkeypatches ``quantize_noise`` in hesic_tpu.ops.ops and in
hesic_tpu_torch.ops.ops, and each side takes, in the forward's order (z1,
y1, the re-encoded warped left reconstruction, z2, y2), the draws of its
own ``Noise`` over the same seed.  The JAX side is fed arrays drawn ahead
in its NHWC layout (through the batch under ``jit``, so every step gets
fresh noise); the port draws as it goes and maps each draw to NCHW.  The
bottlenecks' (C, 1, N) layout is the same on both sides.

Tolerances: tensors atol 2e-5; gradients, per tensor, max |d| <= 1e-4 x
max |g_jax|; the optimizer step atol 1e-7 plus rtol 1e-7 (STEP_RTOL);
three steps' losses rtol 1e-4 and their parameters, per tensor, max |d|
<= 5e-2 x the most JAX's steps moved the tensor (PARAM_REL);
the bf16 model's losses rtol 2e-2.  Scalar sums (losses, bpp, mse) are
held at rtol 1e-6, a few float32 ulps of their magnitude (up to ~1e3),
where an absolute 2e-5 would be below one ulp.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.entropy_models.entropy_models import (
    EntropyBottleneck as JEntropyBottleneck,
    GaussianMixtureConditional as JGaussianMixtureConditional)
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models.base import CompressionModel
from hesic_tpu.training import (TrainState, make_optimizer as j_optimizer,
                                make_train_step as j_train_step,
                                mse2psnr as j_mse2psnr,
                                msssim_db as j_msssim_db,
                                param_labels as j_param_labels,
                                rate_distortion_loss as j_rd_loss,
                                stereo_rate_distortion_loss as j_stereo_loss)
from hesic_tpu_torch.entropy_models import (EntropyBottleneck,
                                            GaussianMixtureConditional)
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.training import (make_loss_fn, make_optimizer,
                                      make_train_step, mse2psnr, msssim_db,
                                      param_labels, rate_distortion_loss,
                                      stereo_rate_distortion_loss)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

ATOL = 2e-5
SCALAR_RTOL = 1e-6
GRAD_REL = 1e-4
# one float32 ulp of a parameter: torch and optax order Adam's division
# and bias corrections differently, so a parameter of magnitude >= 1 (the
# bottlenecks' matrices, quantiles, GDN betas) can round to either
# neighbour of the exact update
STEP_RTOL = 1e-7
# three whole steps: a parameter's max |d| against JAX's, over the most
# JAX's steps moved that tensor.  Adam's first steps move an element by
# about lr times the sign of its gradient, so elements whose gradients are
# within the forward's rounding of zero can differ by up to 2 lr; a sound
# step read <= 8.3e-3 on the CPU, a step that skips zero_grad or uses other
# betas >= 0.4 on its worst tensor
PARAM_REL = 5e-2
LMBDA = 1e-2
NOISE_SEED = 11


class Noise:
    """One numpy sequence of U(-0.5, 0.5) draws, taken in call order."""

    def __init__(self, seed: int = NOISE_SEED):
        self.rng = np.random.RandomState(seed)
        self.fed = []

    def _draw(self, shape):
        return self.rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    def feed(self, shapes):
        """The next draws, at JAX's shapes, for the JAX side to take."""
        return [jnp.asarray(self._draw(s)) for s in shapes]

    def jax(self, x, rng):
        assert self.fed[0].shape == x.shape, (self.fed[0].shape, x.shape)
        return x + self.fed.pop(0).astype(x.dtype)

    def torch(self, x, generator=None):
        if x.dim() == 4:            # NCHW: draw in JAX's NHWC layout
            b, c, h, w = x.shape
            n = self._draw((b, h, w, c)).transpose(0, 3, 1, 2)
        else:
            n = self._draw(tuple(x.shape))
        return x + torch.from_numpy(np.ascontiguousarray(n)).to(x.dtype)


@pytest.fixture
def noise(monkeypatch):
    """Patches both packages' noise with sequences over one seed; returns
    the JAX side's Noise, whose draws the test feeds."""
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


def _hesic_noise_shapes(b=2, hw=64, n=16, m=24):
    """The five draws of HESIC's training forward, in JAX's layout."""
    z = (n, 1, b * (hw // 64) ** 2)
    y = (b, hw // 16, hw // 16, m)
    return [z, y, y, z, y]


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
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _homography(deg, tx, ty):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th), tx],
                     [np.sin(th), np.cos(th), ty], [0, 0, 1]], np.float32)


HOMOGRAPHIES = {"identity": np.eye(3, dtype=np.float32),
                "rotated": _homography(1.5, 6.0, -4.0)}


def _batch(seed=0, hm=HOMOGRAPHIES["identity"]):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(2, 64, 64, 3).astype(np.float32)
    x2 = rng.rand(2, 64, 64, 3).astype(np.float32)
    return x1, x2, np.tile(hm[None], (2, 1, 1))


def _port_batch(x1, x2, h):
    return {"x1": _nchw(x1), "x2": _nchw(x2), "h": torch.from_numpy(h)}


def _jax_loss_fn(module, params, batch, rng, noise):
    """bench.py's calibration loss, stereo RD loss + aux loss, with the
    batch's "noise" fed to `noise`."""
    noise.fed = list(batch["noise"])
    out = module.apply({"params": params}, batch["x1"], batch["x2"],
                       batch["h"], training=True, rngs={"noise": rng})
    rd = j_stereo_loss(out, batch["x1"], batch["x2"], lmbda=LMBDA)
    aux = module.apply({"params": params}, method="aux_loss")
    return rd["loss"] + aux, {"bpp": rd["bpp_loss"], "mse": rd["mse_loss"]}


def _jax_batch(x1, x2, h, noise):
    return {"x1": jnp.asarray(x1), "x2": jnp.asarray(x2),
            "h": jnp.asarray(h), "noise": noise.feed(_hesic_noise_shapes())}


def _flat(tree, prefix=()):
    """Nested dict -> {dotted path: leaf}, flax "kernel" as "weight"."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[".".join(prefix + ("weight" if k == "kernel" else k,))] = v
    return out


# ---- quantization ops ----

@pytest.mark.parametrize("means", [False, True])
@pytest.mark.parametrize("mode", ["dequantize", "symbols"])
def test_quantize_matches_jax(mode, means):
    rng = np.random.RandomState(8)
    x = (rng.randn(2, 5, 4, 3) * 6).astype(np.float32)
    mu = (rng.randn(1, 5, 1, 1) * 2).astype(np.float32) if means else None
    want = np.asarray(j_ops.quantize(
        jnp.asarray(x), mode, means=None if mu is None else jnp.asarray(mu)))
    got = t_ops.quantize(torch.from_numpy(x), mode,
                         means=None if mu is None else torch.from_numpy(mu))
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_ste_round_and_noise_mode():
    x = torch.tensor([-1.7, -0.5, 0.2, 2.5, 3.49], requires_grad=True)
    y = t_ops.ste_round(x)
    y.sum().backward()
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(j_ops.ste_round(jnp.asarray(x.detach().numpy()))))
    assert torch.equal(x.grad, torch.ones(5))      # straight through
    g = torch.Generator().manual_seed(3)
    z = torch.zeros(4000, dtype=torch.bfloat16)
    n = t_ops.quantize(z, "noise", generator=g)
    assert n.dtype == torch.bfloat16
    assert float(n.min()) >= -0.5 and float(n.max()) <= 0.5
    assert abs(float(n.float().mean())) < 0.02
    with pytest.raises(ValueError):
        t_ops.quantize(z, "noise")
    with pytest.raises(ValueError):
        t_ops.quantize(z, "round")


def test_psnr_and_msssim_db_match_jax():
    for ours, theirs, v in ((mse2psnr, j_mse2psnr, 1e-3),
                            (msssim_db, j_msssim_db, 0.97)):
        np.testing.assert_allclose(float(ours(torch.tensor(v))),
                                   float(theirs(jnp.float32(v))), rtol=1e-6)


# ---- EntropyBottleneck ----

def _eb_pair(params):
    """The model's first bottleneck on both sides, with per-channel
    quantiles moved off their initial values (medians not 0)."""
    rng = np.random.RandomState(3)
    p = {k: np.array(v) for k, v in params["entropy_bottleneck1"].items()}
    p["quantiles"] = p["quantiles"] + rng.uniform(
        -2, 2, (p["quantiles"].shape[0], 1, 1)).astype(np.float32)
    teb = EntropyBottleneck(16)
    teb.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return JEntropyBottleneck(channels=16), p, teb


@pytest.mark.parametrize("training", [False, True])
def test_entropy_bottleneck_forward_matches_jax(models, noise, training):
    jeb, p, teb = _eb_pair(models[1])
    z = (np.random.RandomState(4).randn(2, 5, 6, 16) * 4).astype(np.float32)
    noise.fed = noise.feed([(16, 1, 60)])
    want = jeb.apply({"params": p}, jnp.asarray(z), training=training,
                     rngs={"noise": jax.random.PRNGKey(0)})
    got = teb(_nchw(z), training=training,
              generator=torch.Generator().manual_seed(0))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=0)
    if not training:      # values rounded about the medians
        u = np.asarray(want[0]) - p["quantiles"][:, 0, 1]
        np.testing.assert_allclose(u, np.round(u), atol=1e-5, rtol=0)


def test_entropy_bottleneck_aux_loss_and_its_gradient(models):
    jeb, p, teb = _eb_pair(models[1])
    want, gj = jax.value_and_grad(
        lambda q: jeb.apply({"params": q}, method="loss"))(
        jax.tree_util.tree_map(jnp.asarray, p))
    teb.requires_grad_(True)
    got = teb.loss()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=SCALAR_RTOL)
    for name, prm in teb.named_parameters():
        if name == "quantiles":
            np.testing.assert_allclose(prm.grad.numpy(),
                                       np.asarray(gj[name]), atol=ATOL,
                                       rtol=0)
            assert np.abs(prm.grad.numpy()).max() > 0
        else:            # the density is detached in the aux loss
            assert prm.grad is None, name
            assert not np.asarray(gj[name]).any(), name


# ---- GaussianMixtureConditional ----

def _gmm_inputs():
    rng = np.random.RandomState(5)
    b, h, w, m, k = 2, 6, 5, 24, 2
    y = (rng.randn(b, h, w, m) * 3).astype(np.float32)
    scales = (np.abs(rng.randn(b, h, w, m * k)) * 2).astype(np.float32)
    low = rng.rand(*scales.shape) < 0.3          # under the 0.11 bound
    scales[low] = rng.uniform(0, 0.11, int(low.sum()))
    means = (rng.randn(b, h, w, m * k) * 2).astype(np.float32)
    logits = rng.randn(b, 1, 1, k, m)
    wts = np.exp(logits) / np.exp(logits).sum(3, keepdims=True)
    return y, scales, means, wts.reshape(b, 1, 1, k * m).astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
def test_gmm_likelihoods_match_jax(noise, training):
    y, scales, means, wts = _gmm_inputs()
    noise.fed = noise.feed([y.shape])
    want = JGaussianMixtureConditional(K=2).apply(
        {}, *map(jnp.asarray, (y, scales, means, wts)), training=training,
        rngs={"noise": jax.random.PRNGKey(0)})
    got = GaussianMixtureConditional(K=2)(
        *map(_nchw, (y, scales, means, wts)), training=training,
        generator=torch.Generator().manual_seed(0))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


def test_gmm_scale_gradient_gate_matches_jax():
    """The lower_bound gate on the scales: below 0.11 a gradient passes
    only where it pushes the scale up."""
    y, scales, means, wts = _gmm_inputs()
    jg = JGaussianMixtureConditional(K=2)

    def jbits(s):
        _, lik = jg.apply({}, jnp.asarray(y), s, jnp.asarray(means),
                          jnp.asarray(wts))
        return -jnp.sum(jnp.log(lik))

    want = np.asarray(jax.grad(jbits)(jnp.asarray(scales)))
    s = _nchw(scales).requires_grad_(True)
    _, lik = GaussianMixtureConditional(K=2)(_nchw(y), s, _nchw(means),
                                              _nchw(wts))
    (-torch.log(lik).sum()).backward()
    got = _nhwc(s.grad)
    assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()
    low = scales < 0.11
    assert (got[low] == 0).any() and (got[low] < 0).any()
    assert not (got[low] > 0).any()


# ---- losses ----

@pytest.mark.parametrize("stereo", [True, False])
def test_rd_losses_match_jax(stereo):
    rng = np.random.RandomState(6)
    x1, x2 = rng.rand(2, 2, 16, 12, 3).astype(np.float32)
    xh1, xh2 = (x1 + 0.1 * rng.randn(*x1.shape)).astype(np.float32), \
        (x2 + 0.1 * rng.randn(*x2.shape)).astype(np.float32)
    liks = {k: rng.uniform(1e-3, 1, (2, 4, 3, c)).astype(np.float32)
            for k, c in (("y1", 24), ("y2", 24), ("z1", 16), ("z2", 16))}
    if stereo:
        want = j_stereo_loss({"x1_hat": jnp.asarray(xh1),
                              "x2_hat": jnp.asarray(xh2),
                              "likelihoods": liks}, jnp.asarray(x1),
                             jnp.asarray(x2), LMBDA)
        got = stereo_rate_distortion_loss(
            {"x1_hat": _nchw(xh1), "x2_hat": _nchw(xh2),
             "likelihoods": {k: _nchw(v) for k, v in liks.items()}},
            _nchw(x1), _nchw(x2), LMBDA)
    else:       # a bf16 x_hat, against JAX on the same bf16 values
        xh = _nchw(xh1).to(torch.bfloat16)
        want = j_rd_loss({"x_hat": jnp.asarray(_nhwc(xh)),
                          "likelihoods": liks}, jnp.asarray(x1), LMBDA)
        got = rate_distortion_loss(
            {"x_hat": xh,
             "likelihoods": {k: _nchw(v) for k, v in liks.items()}},
            _nchw(x1), LMBDA)
    for key in ("loss", "mse_loss", "bpp_loss"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=SCALAR_RTOL)


# ---- HESIC's training forward ----

@pytest.mark.parametrize("homography,training", [
    ("identity", True), ("rotated", True), ("identity", False)])
def test_training_forward_matches_jax(models, noise, homography, training):
    """The forward in training mode (noise) and in eval mode (rounding)."""
    jm, params, tm = models
    x1, x2, h = _batch(0, HOMOGRAPHIES[homography])
    noise.fed = noise.feed(_hesic_noise_shapes())
    want = jm.apply({"params": params}, *map(jnp.asarray, (x1, x2, h)),
                    training=training, rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm(_nchw(x1), _nchw(x2), torch.from_numpy(h),
                 training=training,
                 generator=torch.Generator().manual_seed(0))
    for key in ("x1_hat", "x2_hat", "y1_hat", "y2_hat"):
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    for key in ("y1", "y2", "z1", "z2"):
        np.testing.assert_allclose(_nhwc(got["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.fixture(scope="module")
def jax_grads(models):
    """JAX's loss and gradients of rd + aux at the identity batch, under
    the shared noise; and the port model they were taken at."""
    jm, params, tm = models
    jn = Noise()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ops, "quantize_noise", jn.jax)
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b, r: _jax_loss_fn(jm, p, b, r, jn), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params),
            _jax_batch(*_batch(), jn), jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def test_gradients_match_jax(models, noise, jax_grads):
    jm, params, tm = models
    want_loss, grads = jax_grads
    model = copy.deepcopy(tm).requires_grad_(True)
    loss, _ = make_loss_fn(LMBDA)(model, _port_batch(*_batch()),
                                  torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=SCALAR_RTOL)
    want = hesic_from_jax(grads, model)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        limit = GRAD_REL * float(g.abs().max())
        err = float((got[name].grad - g).abs().max())
        assert err <= limit, (name, err, limit)


def test_param_split_matches_jax(models):
    jm, params, tm = models
    labels = _flat(jax.tree_util.tree_map(str, j_param_labels(params)))
    ours = param_labels(tm)
    assert set(labels) == set(ours)
    aux = {k for k, v in ours.items() if v == "aux"}
    assert aux == {k for k, v in labels.items() if v == "aux"}
    assert {k.split(".")[0] for k in aux} == {"entropy_bottleneck1",
                                              "entropy_bottleneck2"}
    assert len(aux) == 2 * 15       # 5 matrices, 5 biases, 4 factors, q
    opt = make_optimizer(copy.deepcopy(tm))
    assert [g["name"] for g in opt.param_groups] == ["main", "aux"]
    assert [g["lr"] for g in opt.param_groups] == [1e-4, 1e-3]


def test_optimizer_step_matches_optax(models, jax_grads):
    jm, params, tm = models
    _, grads = jax_grads
    tx = j_optimizer(1e-4, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState.create(jp, tx)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    updates, _ = tx.update(jg, state.opt_state, jp)
    want = hesic_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(lambda a, b: a + b, jp,
                                           updates)), tm)

    model = copy.deepcopy(tm)
    opt = make_optimizer(model, 1e-4, 1e-3)
    tg = hesic_from_jax(grads, model)
    for name, p in model.named_parameters():
        p.grad = tg[name].clone()
    opt.step()
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-7, rtol=STEP_RTOL, err_msg=name)
        moved += int(not torch.equal(p.detach(), tm.state_dict()[name]))
    assert moved == len(want)


def test_optimizer_three_steps_match_optax(models):
    """Three Adam steps on three different seeded gradients, copied into
    both sides: from step 2 on, the moments' betas and the bias
    corrections no longer cancel, so this holds them."""
    jm, params, tm = models
    rng = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 10 ** rng.uniform(-4, 0)).astype(
            np.float32), params) for _ in range(3)]
    tx = j_optimizer(1e-4, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)
    want = hesic_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)

    model = copy.deepcopy(tm)
    opt = make_optimizer(model, 1e-4, 1e-3)
    for g in grads:
        tg = hesic_from_jax(g, model)
        for name, p in model.named_parameters():
            p.grad = tg[name].clone()
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-7, rtol=STEP_RTOL, err_msg=name)


def test_three_steps_match_jax(models, noise):
    """Three whole steps (forward, backward, Adam) from the same weights
    over one noise sequence: the losses agree along the way, and so does
    every parameter at the end, per tensor, relative to how far JAX's
    steps moved it (PARAM_REL)."""
    jm, params, tm = models
    x1, x2, h = _batch()
    tx = j_optimizer(1e-4, 1e-3)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                              tx)
    jstep = j_train_step(
        jm, tx, lambda *a: _jax_loss_fn(*a, noise))
    want = []
    for i in range(3):
        state, metrics = jstep(state, _jax_batch(x1, x2, h, noise),
                               jax.random.PRNGKey(i))
        want.append(float(metrics["loss"]))
    want_params = hesic_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), tm)

    model = copy.deepcopy(tm)
    step = make_train_step(model, make_optimizer(model, 1e-4, 1e-3),
                           make_loss_fn(LMBDA))
    g = torch.Generator().manual_seed(0)
    got = [float(step(_port_batch(x1, x2, h), g)["loss"])
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]
    start = tm.state_dict()
    for name, p in model.named_parameters():
        w = want_params[name]
        limit = PARAM_REL * float((w - start[name]).abs().max())
        err = float((p.detach() - w).abs().max())
        assert err <= limit, (name, err, limit)


def test_bf16_training_forward_losses_match_jax(models, noise):
    jm, params, tm = models
    x1, x2, h = _batch()
    jb = JHESIC(N=16, M=24, K=2, dtype=jnp.bfloat16)
    want_loss, want = jax.jit(lambda p, b: _jax_loss_fn(
        jb, p, b, jax.random.PRNGKey(0), noise))(
        jax.tree_util.tree_map(jnp.asarray, params),
        _jax_batch(x1, x2, h, noise))
    model = HESIC(N=16, M=24, K=2, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got_loss, got = make_loss_fn(LMBDA)(
            model, _port_batch(x1, x2, h), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=2e-2)
    for key in ("bpp", "mse"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-2, err_msg=key)
