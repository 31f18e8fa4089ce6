"""Port: mbt2018 (hesic_tpu_torch/models/priors.py), GaussianConditional
and the single-image training recipe against the JAX package, on the
CPU, at tests/test_ar_device.py's config (N=16, M=16, 64x64, batch 2,
float32), the JAX parameters carried over by hesic_from_jax (strict
load: every parameter maps, by module type).

Both sides take their training noise from one numpy sequence
(test_torch_training.py's ``Noise``), in mbt2018's order: z in the
bottleneck, y_hat, then the Gaussian conditional's own draw on y.

Tolerances, as tests/test_torch_training.py: tensors atol 2e-5 (float32
convs summed in another order; outputs of magnitude ~1-10); scalar sums
(losses, bpp, mse) rtol 1e-6; gradients, per tensor, max |d| <= 1e-4 x
max |g_jax| (GRAD_REL); the optimizer step atol 1e-7 plus rtol 1e-7.
GaussianConditional's likelihoods atol 2e-5 and their gradients with
respect to the inputs, scales and means within GRAD_REL, including the
gates of both lower bounds (scales below 0.11, likelihoods at 1e-9).
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
    GaussianConditional as JGaussianConditional)
from hesic_tpu.models import (JointAutoregressiveCodec,
                              JointAutoregressiveHierarchicalPriors as JMbt)
from hesic_tpu.training import (TrainState, make_optimizer as j_optimizer,
                                rate_distortion_loss as j_rd_loss)
from hesic_tpu_torch.entropy_models import GaussianConditional
from hesic_tpu_torch.models.priors import (
    JointAutoregressiveHierarchicalPriors)
from hesic_tpu_torch.training import make_loss_fn, make_optimizer
from hesic_tpu_torch.training.recipe import (calibrate, calibrate_single,
                                             smooth_pairs)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
SCALAR_RTOL = 1e-6
GRAD_REL = 1e-4
STEP_RTOL = 1e-7
LMBDA = 1e-2
CFG = dict(N=16, M=16)


@pytest.fixture(scope="module")
def models():
    base = JointAutoregressiveCodec.init(JMbt(**CFG), [(1, 64, 64, 3)],
                                         seed=0)
    params = jax.tree_util.tree_map(np.asarray, base.params)
    tm = JointAutoregressiveHierarchicalPriors(**CFG, device="cpu")
    tm.load_state_dict(hesic_from_jax(params, tm))
    return base.module, params, tm


@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _images(seed=0, b=2):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _noise_shapes(b=2, hw=64, n=16, m=16):
    """The three draws of mbt2018's training forward, in JAX's layout."""
    z = (n, 1, b * (hw // 64) ** 2)
    y = (b, hw // 16, hw // 16, m)
    return [z, y, y]


# ---- GaussianConditional ----

def _gc_inputs():
    rng = np.random.RandomState(5)
    shape = (2, 6, 5, 16)
    y = (rng.randn(*shape) * 3).astype(np.float32)
    scales = (np.abs(rng.randn(*shape)) * 2).astype(np.float32)
    low = rng.rand(*shape) < 0.3                  # under the 0.11 bound
    scales[low] = rng.uniform(0, 0.11, int(low.sum()))
    means = (rng.randn(*shape) * 2).astype(np.float32)
    # far from the mean at a small scale: the likelihood hits its bound
    far = rng.rand(*shape) < 0.1
    y[far] = means[far] + rng.choice([-40.0, 40.0], int(far.sum()))
    return y, scales, means


@pytest.mark.parametrize("with_means", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_gaussian_conditional_matches_jax(noise, training, with_means):
    y, scales, means = _gc_inputs()
    mu = means if with_means else None
    noise.fed = noise.feed([y.shape])
    want = JGaussianConditional().apply(
        {}, jnp.asarray(y), jnp.asarray(scales),
        means=None if mu is None else jnp.asarray(mu), training=training,
        rngs={"noise": jax.random.PRNGKey(0)})
    got = GaussianConditional()(
        _nchw(y), _nchw(scales), None if mu is None else _nchw(mu),
        training, torch.Generator().manual_seed(0))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=ATOL,
                                   rtol=0)
    if not training and with_means:      # rounded about the means
        u = np.asarray(want[0]) - means
        np.testing.assert_allclose(u, np.round(u), atol=1e-5, rtol=0)
    # the far cells sit on the likelihood's bound
    assert float(got[1].min()) == float(np.float32(1e-9))


def test_gaussian_conditional_gradients_match_jax():
    """The gradients of a signed sum of the likelihoods with respect to the
    inputs, scales and means (eval mode): below either bound a gradient
    passes only where it pushes the value up, so both gates show."""
    y, scales, means = _gc_inputs()
    sign = np.where(np.random.RandomState(6).rand(*y.shape) < 0.5, -1.0,
                    1.0).astype(np.float32)

    def jobj(a, s, m):
        _, lik = JGaussianConditional().apply({}, a, s, means=m)
        return jnp.sum(lik * sign) - jnp.sum(jnp.log(lik))

    want = jax.grad(jobj, argnums=(0, 1, 2))(
        *map(jnp.asarray, (y, scales, means)))
    ts = [_nchw(a).requires_grad_(True) for a in (y, scales, means)]
    _, lik = GaussianConditional()(*ts)
    (torch.sum(lik * _nchw(sign)) - torch.log(lik).sum()).backward()
    for name, t, w in zip(("inputs", "scales", "means"), ts, want):
        got, w = _nhwc(t.grad), np.asarray(w)
        assert np.abs(got - w).max() <= GRAD_REL * np.abs(w).max(), name
    g_scale = _nhwc(ts[1].grad)
    low = scales < 0.11
    assert (g_scale[low] == 0).any() and not (g_scale[low] > 0).any()


# ---- the model ----

def test_from_jax_maps_every_parameter(models):
    _, params, tm = models
    sd = hesic_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    assert sorted({k.split(".")[0] for k in sd}) == sorted(
        [f"g_a_{i}" for i in range(7)] + [f"g_s_{i}" for i in range(7)]
        + [f"h_a_{i}" for i in (0, 2, 4)] + [f"h_s_{i}" for i in (0, 2, 4)]
        + [f"entropy_parameters_{i}" for i in (0, 2, 4)]
        + ["context_prediction", "entropy_bottleneck"])


# (method, input shapes NHWC): every codec-facing sub-program
SUBPROGRAMS = [
    ("analysis", [(2, 64, 64, 3)]),
    ("synthesis", [(2, 4, 4, 16)]),
    ("hyper_analysis", [(2, 4, 4, 16)]),
    ("hyper_synthesis", [(2, 1, 1, 16)]),
    ("entropy_params", [(2, 4, 4, 64)]),
    ("context", [(2, 4, 4, 16)]),
]


@pytest.mark.parametrize("method,shapes", SUBPROGRAMS,
                         ids=[s[0] for s in SUBPROGRAMS])
def test_subprograms_match_flax(models, method, shapes):
    jm, params, tm = models
    xs = [np.random.RandomState(i).randn(*s).astype(np.float32)
          for i, s in enumerate(shapes)]
    want = np.asarray(jm.apply({"params": params},
                               *[jnp.asarray(x) for x in xs], method=method))
    with torch.no_grad():
        got = _nhwc(getattr(tm, method)(*[_nchw(x) for x in xs]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_aux_loss_matches_jax(models):
    jm, params, tm = models
    want = jm.apply({"params": params}, method="aux_loss")
    np.testing.assert_allclose(float(tm.aux_loss()), float(want),
                               rtol=SCALAR_RTOL)


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(models, noise, training):
    jm, params, tm = models
    x = _images()
    noise.fed = noise.feed(_noise_shapes() if training else [])
    want = jm.apply({"params": params}, jnp.asarray(x), training=training,
                    rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm(_nchw(x), training=training,
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_nhwc(got["x_hat"]), np.asarray(
        want["x_hat"]), atol=ATOL, rtol=0)
    for key in ("y", "z"):
        np.testing.assert_allclose(_nhwc(got["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert not noise.fed        # JAX took every draw it was fed


def _jax_loss_fn(module, params, batch, rng, noise):
    """bench.py's _calibrate_single loss: RD loss + aux loss, with the
    batch's "noise" fed to `noise`."""
    noise.fed = list(batch["noise"])
    out = module.apply({"params": params}, batch["x"], training=True,
                       rngs={"noise": rng})
    rd = j_rd_loss(out, batch["x"], lmbda=LMBDA)
    aux = module.apply({"params": params}, method="aux_loss")
    return rd["loss"] + aux, {"bpp": rd["bpp_loss"], "mse": rd["mse_loss"]}


@pytest.fixture(scope="module")
def jax_grads(models):
    jm, params, _ = models
    jn = Noise()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ops, "quantize_noise", jn.jax)
    try:
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b, r: _jax_loss_fn(jm, p, b, r, jn), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params),
            {"x": jnp.asarray(_images()), "noise": jn.feed(_noise_shapes())},
            jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return (float(loss), {k: float(v) for k, v in aux.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_loss_and_gradients_match_jax(models, noise, jax_grads):
    _, _, tm = models
    want_loss, want_aux, grads = jax_grads
    model = copy.deepcopy(tm).requires_grad_(True)
    loss, metrics = make_loss_fn(LMBDA)(
        model, {"x": _nchw(_images())}, torch.Generator().manual_seed(0))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss,
                               rtol=SCALAR_RTOL)
    for key in ("bpp", "mse"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   want_aux[key], rtol=SCALAR_RTOL,
                                   err_msg=key)
    want = hesic_from_jax(grads, model)
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        limit = GRAD_REL * float(g.abs().max())
        err = float((got[name].grad - g).abs().max())
        assert err <= limit, (name, err, limit)


def test_optimizer_step_matches_optax(models, jax_grads):
    _, params, tm = models
    grads = jax_grads[2]
    tx = j_optimizer(1e-4, 1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                           TrainState.create(jp, tx).opt_state, jp)
    want = hesic_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(lambda a, b: a + b, jp,
                                           updates)), tm)
    model = copy.deepcopy(tm)
    opt = make_optimizer(model, 1e-4, 1e-3)
    tg = hesic_from_jax(grads, model)
    for name, p in model.named_parameters():
        p.grad = tg[name].clone()
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-7, rtol=STEP_RTOL, err_msg=name)


def test_calibrate_single_draws_and_falls(models):
    """calibrate_single takes calibrate's draws (the first eyes of the same
    pairs) and its loss falls over a few steps at the tiny config."""
    _, _, tm = models
    rng = np.random.RandomState(0)
    losses, bpps = calibrate_single(copy.deepcopy(tm), rng, steps=12,
                                    hw=64, batch=2)
    ref = np.random.RandomState(0)
    smooth_pairs(ref, 2, 64)
    assert rng.randn() == ref.randn()
    assert np.isfinite(losses).all() and np.isfinite(bpps).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    with pytest.raises(KeyError):       # a single-image model takes "x"
        calibrate(copy.deepcopy(tm), np.random.RandomState(0), steps=1,
                  hw=64, batch=2)
