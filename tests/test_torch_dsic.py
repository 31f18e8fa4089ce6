"""Port: DSIC's modules and forward (hesic_tpu_torch/models/dsic.py) against
the JAX package, on the CPU, at the JAX tests' tiny config (N=16, M=24,
F=6, C=4, K=2, 64x64, batch 2), the JAX parameters carried over by
hesic_from_jax and loaded strictly.  Inputs come from numpy seeds.

Tolerances: dense_warp and the upsamplers atol 1e-6 (float32); Conv3D's
NDHWC path and GroupNorm atol 2e-5; the port's folded Conv3D against its
own conv3d atol 1e-5; the bf16 folded Conv3D within 2 bf16 ulps of the
largest output (2 x 2^-8 x max |want|; the two sides round their float32
sums to bf16 after adding in another order); modules, sub-programs and
the forward atol 2e-5 (float32); gradients, per tensor, max |d| <= 1e-4
x max |g_jax| against JAX's float32 gradient or, where that misses,
against JAX's float64 gradient at the same limit (see
test_loss_and_gradients_match_jax); scalar losses rtol 1e-6; the bf16
model's losses rtol 2e-2.  Training shares the noise with JAX through
the ``quantize_noise`` monkeypatch of test_torch_training.py (draws z1,
y1, z2, y2).
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

import hesic_tpu.models.dsic as jd
import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.models.base import CompressionModel
from hesic_tpu.training import stereo_rate_distortion_loss as j_stereo_loss
from hesic_tpu_torch.models import dsic as td
from hesic_tpu_torch.training import make_loss_fn
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
GRAD_REL = 1e-4
SCALAR_RTOL = 1e-6
LMBDA = 1e-2
CFG = dict(N=16, M=24, F=6, C=4, K=2)
SHAPES = [(1, 64, 64, 3), (1, 64, 64, 3)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.array(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _ndhwc_to_port(a):
    """JAX (B, D, H, W, I) -> port (B, I, D, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.array(a, np.float32).transpose(0, 4, 1, 2, 3)))


@pytest.fixture(scope="module")
def models():
    jm = jd.DSIC(**CFG)
    params = jax.tree_util.tree_map(
        np.asarray, CompressionModel.init(jm, SHAPES, seed=0).params)
    tm = td.DSIC(**CFG, device="cpu")
    tm.load_state_dict(hesic_from_jax(params, tm), strict=True)
    return jm, params, tm


def _pairs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 64, 64, 3).astype(np.float32),
            rng.rand(b, 64, 64, 3).astype(np.float32))


# ---- dense_warp ----

def test_dense_warp_identity_at_shift_zero():
    h1 = torch.from_numpy(np.random.RandomState(0).rand(1, 2, 4, 8)
                          .astype(np.float32))
    cost = torch.zeros(1, 5, 4, 8)
    cost[:, 0] = 1.0
    np.testing.assert_allclose(td.dense_warp(h1, cost).numpy(), h1.numpy(),
                               atol=1e-6, rtol=0)


def test_dense_warp_pure_shift():
    h1 = torch.from_numpy(np.random.RandomState(1).rand(1, 1, 2, 8)
                          .astype(np.float32))
    cost = torch.zeros(1, 5, 2, 8)
    cost[:, 3] = 1.0
    out = td.dense_warp(h1, cost).numpy()
    np.testing.assert_allclose(out[..., :5], h1.numpy()[..., 3:], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out[..., 5:], 0.0, atol=1e-6, rtol=0)


def test_dense_warp_blocks_the_feature_gradient():
    h1 = torch.ones(1, 1, 2, 4, requires_grad=True)
    cost = torch.full((1, 2, 2, 4), 0.5, requires_grad=True)
    td.dense_warp(h1, cost).sum().backward()
    assert h1.grad is None
    assert (cost.grad != 0).any()


def test_dense_warp_matches_jax():
    rng = np.random.RandomState(2)
    h1 = rng.randn(2, 5, 9, 6).astype(np.float32)          # NHWC
    cost = rng.rand(2, 5, 9, 4).astype(np.float32)
    want = np.asarray(jd.dense_warp(jnp.asarray(h1), jnp.asarray(cost)))
    got = td.dense_warp(_nchw(h1), _nchw(cost))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6, rtol=0)


def _warp_inputs(seed, dtype, c, b=2, n=3, h=4, w=37):
    """Features of both signs and softmaxed costs, as the model has them."""
    rng = np.random.RandomState(seed)
    h1 = torch.from_numpy(rng.randn(b, n, h, w).astype(np.float32))
    cost = torch.softmax(torch.from_numpy(
        3 * rng.randn(b, c, h, w).astype(np.float32)), dim=1)
    return h1.to(dtype), cost.to(dtype)


@pytest.mark.parametrize("c", [5, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_warp_function_backward_matches_the_loop(dtype, c):
    h1, cost = _warp_inputs(4, dtype, c)
    g = torch.from_numpy(np.random.RandomState(5).randn(*h1.shape)
                         .astype(np.float32)).to(dtype)
    ref_cost = cost.clone().requires_grad_(True)
    want = td.dense_warp_plain(h1, ref_cost)
    want.backward(g)
    fn_cost = cost.clone().requires_grad_(True)
    got = td.DenseWarp.apply(h1, fn_cost)
    got.backward(g)
    assert got.dtype == dtype and fn_cost.grad.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(fn_cost.grad, ref_cost.grad, rtol=0, atol=0)


def _round_bf16(a):
    """float32 -> nearest bf16 (ties to even), as float32 (finite a)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def test_dense_warp_cpu_bf16_rounds_after_every_shift():
    c = 32
    h1, cost = _warp_inputs(6, torch.bfloat16, c)
    got = td.dense_warp(h1, cost).float().numpy()
    hf, cf = h1.float().numpy(), cost.float().numpy()
    w = hf.shape[-1]
    hp = np.pad(hf, ((0, 0), (0, 0), (0, 0), (0, c - 1)))
    acc = np.zeros_like(hf)
    once = np.zeros_like(hf)
    for d in range(c):
        term = cf[:, d:d + 1] * hp[..., d:d + w]        # exact in float32
        acc = _round_bf16(acc + term)
        once = once + term
    np.testing.assert_array_equal(got, acc)
    # the rounding after every shift is what the comparison holds
    assert (_round_bf16(once) != acc).any()


def test_dense_warp_cpu_takes_the_loop(monkeypatch):
    from hesic_tpu_torch.codecs import build

    def refuse(*_):
        raise AssertionError("the kernel was called for CPU tensors")

    monkeypatch.setattr(td, "dense_warp_cuda", refuse)
    before = dict(build.launch_counts)
    for dtype in (torch.float32, torch.bfloat16):
        h1, cost = _warp_inputs(7, dtype, 5)
        torch.testing.assert_close(td.dense_warp(h1, cost),
                                   td.dense_warp_plain(h1, cost),
                                   rtol=0, atol=0)
        torch.testing.assert_close(td.DenseWarp.apply(h1, cost),
                                   td.dense_warp_plain(h1, cost),
                                   rtol=0, atol=0)
    assert dict(build.launch_counts) == before


def test_dense_warp_cpu_leaves_no_launch_counter():
    from torch.profiler import ProfilerActivity, profile
    h1, cost = _warp_inputs(8, torch.bfloat16, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.dense_warp(h1, cost)
    names = [e.name for e in prof.events()]
    assert "dsic/dense_warp" in names
    assert not [n for n in names if n.startswith("count/dense_warp_launches")]


@pytest.mark.parametrize("case", ["cpu", "c33", "float16", "shape", "3d"])
def test_dense_warp_kernel_wrapper_refuses(case):
    h1, cost = _warp_inputs(9, torch.float32, 5)
    if case == "c33":
        cost = torch.ones(2, 33, 4, 37)
        match = "1 to 32 disparities"
    elif case == "float16":
        h1, cost = h1.half(), cost.half()
        match = "bf16 or float32"
    elif case == "shape":
        cost = cost[..., :36]
        match = "shape"
    elif case == "3d":
        h1 = h1[0]
        match = "4-D"
    else:
        match = "CUDA tensor"
    with pytest.raises(ValueError, match=match):
        td.dense_warp_cuda(h1, cost)


# ---- align-corners upsamplers ----

@pytest.mark.parametrize("scale", [2, 8])
def test_upsamplers_match_jax(scale):
    rng = np.random.RandomState(3)
    d5 = rng.randn(2, 4, 3, 5, 2).astype(np.float32)       # (B, C, h, w, F0)
    want5 = np.asarray(jd._upsample_bilinear_align_corners(
        jnp.asarray(d5), scale))
    got5 = td.upsample_bilinear_ac(_ndhwc_to_port(d5), scale)
    np.testing.assert_allclose(got5.numpy(), want5.transpose(0, 4, 1, 2, 3),
                               atol=1e-6, rtol=0)
    d4 = rng.randn(2, 3, 5, 8).astype(np.float32)          # (B, h, w, C*F0)
    want4 = np.asarray(jd._upsample_bilinear_ac_2d(jnp.asarray(d4), scale))
    got4 = td.upsample_bilinear_ac(_nchw(d4), scale)
    np.testing.assert_allclose(_nhwc(got4), want4, atol=1e-6, rtol=0)
    # torch's own align_corners=True bilinear, a yardstick only
    ref = F.interpolate(_nchw(d4), scale_factor=scale, mode="bilinear",
                        align_corners=True)
    np.testing.assert_allclose(got4.numpy(), ref.numpy(), atol=1e-5, rtol=0)


# ---- Conv3D ----

def _carried(module, p):
    """`module` with the flax parameters `p` carried by hesic_from_jax."""
    holder = torch.nn.ModuleDict({"m": module})
    holder.load_state_dict(hesic_from_jax({"m": p}, holder), strict=True)
    return module


def _conv3d_pair(seed=4, b=2, c=8, f0=3, hw=6):
    rng = np.random.RandomState(seed)
    x5 = rng.randn(b, c, hw, hw, f0).astype(np.float32)    # NDHWC
    jm = jd.Conv3D(f0)
    p = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x5))["params"])
    p["bias"] = rng.randn(f0).astype(np.float32)
    tm = _carried(td.Conv3D(f0, f0), p)
    return x5, p, tm


def _folded(x5):
    """NDHWC (B, D, H, W, I) -> the JAX package's folded NHWC (B, H, W,
    D*I), channel d*I + i."""
    b, d, h, w, i = x5.shape
    return x5.transpose(0, 2, 3, 1, 4).reshape(b, h, w, d * i)


def test_conv3d_matches_jax_ndhwc():
    x5, p, tm = _conv3d_pair()
    want = np.asarray(jd.Conv3D(3).apply({"params": p}, jnp.asarray(x5)))
    got = tm(_ndhwc_to_port(x5))
    np.testing.assert_allclose(got.detach().numpy(),
                               want.transpose(0, 4, 1, 2, 3), atol=ATOL,
                               rtol=0)


def test_conv3d_folded_equals_its_conv3d():
    x5, _, tm = _conv3d_pair(seed=5)
    plain = tm(_ndhwc_to_port(x5)).detach()              # (B, O, D, H, W)
    folded = tm(_nchw(_folded(x5))).detach()             # (B, D*O, H, W)
    b, o, d, h, w = plain.shape
    np.testing.assert_allclose(
        folded.reshape(b, d, o, h, w).transpose(1, 2).numpy(),
        plain.numpy(), atol=1e-5, rtol=0)


def test_conv3d_bf16_folded_matches_jax():
    x5, p, _ = _conv3d_pair(seed=6)
    xf = _folded(x5)
    want = np.asarray(jd.Conv3D(3, dtype=jnp.bfloat16, folds=8).apply(
        {"params": p}, jnp.asarray(xf)).astype(jnp.float32))
    tm = _carried(td.Conv3D(3, 3, dtype=torch.bfloat16), p)
    got = tm(_nchw(xf))
    assert got.dtype == torch.bfloat16
    err = np.abs(_nhwc(got) - want).max()
    assert err <= 2 * 2 ** -8 * np.abs(want).max(), err


def test_band_weight_entries_are_the_kernel_or_zero():
    tm = td.Conv3D(2, 3, generator=torch.Generator().manual_seed(0))
    band = tm.band_weight(6).reshape(6, 3, 6, 2, 5, 5)
    w = tm.weight.detach()
    for m in range(6):
        for n in range(6):
            t = n - m + 2
            want = w[:, :, t] if 0 <= t < 5 else torch.zeros_like(w[:, :, 0])
            assert torch.equal(band[m, :, n].detach(), want), (m, n)


# ---- GroupNorm ----

@pytest.mark.parametrize("groups,folds", [(1, 1), (1, 4), (4, 1), (3, 1)])
def test_group_norm_matches_jax(groups, folds):
    rng = np.random.RandomState(7)
    ch = 12 // folds if folds > 1 else 12
    x = (rng.randn(2, 5, 6, ch * folds) * 3 + 1).astype(np.float32)
    scale = rng.randn(ch).astype(np.float32)
    bias = rng.randn(ch).astype(np.float32)
    if folds > 1:
        jm = jd.GroupNorm(num_groups=1, epsilon=1e-5, folds=folds)
    else:
        jm = nn.GroupNorm(num_groups=groups, epsilon=1e-5)
    want = np.asarray(jm.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x)))
    tm = _carried(td.GroupNorm(ch, groups), {"scale": scale, "bias": bias})
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), want, atol=ATOL, rtol=0)


def test_from_jax_loads_the_whole_tree_and_refuses_unknown_scales(models):
    _, params, tm = models
    sd = hesic_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    assert sd["cost_volume1.Conv3D_0.weight"].shape == (2, 2, 5, 5, 5)
    assert sd["global_context.GroupNorm_1.weight"].shape == (24,)
    bad = {"encoder1": {"Conv_0": {"scale": np.ones(16, np.float32)}}}
    with pytest.raises(ValueError, match="GroupNorm"):
        hesic_from_jax(bad, tm)


# ---- modules and the codec's sub-programs ----

def _japply(jm, params, method, *args):
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                          method=method))(params, *args)


def _close(got, want, name):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]")
        return
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy()
    if g.ndim == 5:                 # (B, F0, C, h, w) vs (B, C, h, w, F0)
        g = g.transpose(0, 2, 3, 4, 1)
    elif g.ndim == 4:
        g = g.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


def test_subprograms_match_jax(models):
    """Each sub-program on what the codec feeds it: the images, the rounded
    latents of JAX's own transforms, the left taps and the contexts."""
    jm, params, tm = models
    x1, x2 = map(jnp.asarray, _pairs(8))

    def port(a):
        if isinstance(a, tuple):
            return tuple(map(port, a))
        return _ndhwc_to_port(a) if a.ndim == 5 else _nchw(a)

    def both(method, *args):
        want = _japply(jm, params, method, *args)
        with torch.no_grad():
            _close(getattr(tm, method)(*map(port, args)), want,
                   method)
        return want

    y1, *taps_a = both("analysis1", x1)
    y1_hat = jnp.round(y1)
    x1_hat, *taps_s = both("synthesis1", y1_hat)
    ctx = both("contexts", y1_hat)
    y2_hat = jnp.round(both("analysis2", x2, *taps_a, ctx))
    both("synthesis2", y2_hat, *taps_s, ctx)
    z1_hat = jnp.round(both("hyper_analysis1", y1))
    z2_hat = jnp.round(both("hyper_analysis2", y2_hat))
    both("gmm1", z1_hat)
    both("gmm2", z2_hat, y1_hat)


@pytest.mark.parametrize("i", [1, 3])
def test_cost_volume_matches_jax(models, i):
    """Cost volume 1 (scale 8) and 3 (scale 2) on seeded features and a
    seeded context volume."""
    jm, params, tm = models
    cv = getattr(tm, f"cost_volume{i}")
    rng = np.random.RandomState(12 + i)
    hw = 4 * cv.scale
    h1, h2 = rng.randn(2, 2, hw, hw, 16).astype(np.float32)
    d = rng.randn(2, 4, 4, 4, 2).astype(np.float32)       # (B, C, h, w, F0)
    want = jd.CostVolume(N=16, scale=cv.scale, F=6, C=4).apply(
        {"params": params[f"cost_volume{i}"]},
        *map(jnp.asarray, (h1, h2, d)))
    with torch.no_grad():
        got = cv(_nchw(h1), _nchw(h2), _ndhwc_to_port(d))
    _close(got, want, f"cost_volume{i}")
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5, rtol=0)


def test_aux_loss_matches_jax(models):
    jm, params, tm = models
    want = jm.apply({"params": params}, method="aux_loss")
    np.testing.assert_allclose(float(tm.aux_loss()), float(want),
                               rtol=SCALAR_RTOL)


# ---- the forward, eval and training ----

@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


def _noise_shapes(b=2, hw=64, n=16, m=24):
    """The four draws of DSIC's training forward, in JAX's layout."""
    z = (n, 1, b * (hw // 64) ** 2)
    y = (b, hw // 16, hw // 16, m)
    return [z, y, z, y]


def _jax_loss_fn(module, params, batch, rng, noise):
    """bench.py's calibration loss for DSIC (no homography)."""
    noise.fed = list(batch["noise"])
    out = module.apply({"params": params}, batch["x1"], batch["x2"],
                       training=True, rngs={"noise": rng})
    rd = j_stereo_loss(out, batch["x1"], batch["x2"], lmbda=LMBDA)
    aux = module.apply({"params": params}, method="aux_loss")
    return rd["loss"] + aux, {"bpp": rd["bpp_loss"], "mse": rd["mse_loss"]}


def _jax_batch(x1, x2, noise):
    return {"x1": jnp.asarray(x1), "x2": jnp.asarray(x2),
            "noise": noise.feed(_noise_shapes())}


def _port_batch(x1, x2):
    """A port batch without "h": DSIC's loss must not read one."""
    return {"x1": _nchw(x1), "x2": _nchw(x2)}


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(models, noise, training):
    jm, params, tm = models
    x1, x2 = _pairs(0)
    noise.fed = noise.feed(_noise_shapes())
    want = jax.jit(lambda p, a, b: jm.apply(
        {"params": p}, a, b, training=training,
        rngs={"noise": jax.random.PRNGKey(0)}))(params, jnp.asarray(x1),
                                                 jnp.asarray(x2))
    with torch.no_grad():
        got = tm(_nchw(x1), _nchw(x2), training=training,
                 generator=torch.Generator().manual_seed(0))
    for key in ("x1_hat", "x2_hat", "y1_hat", "y2_hat"):
        _close(got[key], want[key], key)
    for key in ("y1", "y2", "z1", "z2"):
        _close(got["likelihoods"][key], want["likelihoods"][key], key)


def _jax_grads(models, dtype):
    """JAX's loss and gradients of rd + aux at the identity batch, the
    parameters and images in `dtype`, under a fresh noise sequence."""
    jm, params, _ = models
    jn = Noise()
    mp = pytest.MonkeyPatch()
    mp.setattr(j_ops, "quantize_noise", jn.jax)
    x1, x2 = (x.astype(dtype) for x in _pairs(0))
    try:
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b, r: _jax_loss_fn(jm, p, b, r, jn), has_aux=True))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params),
            _jax_batch(x1, x2, jn), jax.random.PRNGKey(0))
    finally:
        mp.undo()
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def jax_grads(models):
    return _jax_grads(models, np.float32)


def _port_grads(tm):
    """The port's loss and gradients of rd + aux at the identity batch,
    under a fresh noise sequence."""
    t_ops.quantize_noise = Noise().torch
    model = copy.deepcopy(tm).requires_grad_(True)
    loss, _ = make_loss_fn(LMBDA)(
        model, _port_batch(*_pairs(0)), torch.Generator().manual_seed(0))
    loss.backward()
    return float(loss.detach()), {n: p.grad.double()
                                  for n, p in model.named_parameters()}


def test_loss_and_gradients_match_jax(models, noise, jax_grads):
    """Per tensor, max |d| <= GRAD_REL x max |g_jax|.  A tensor that misses
    this against JAX's float32 gradient is held, at the same limit, against
    JAX's float64 gradient: a gradient that is a cancellation residue (a
    bias just before a one-group GroupNorm, whose channels' gradients sum
    to zero) can miss by JAX's float32 rounding alone."""
    _, _, tm = models
    want_loss, grads = jax_grads
    loss, got = _port_grads(tm)
    np.testing.assert_allclose(loss, want_loss, rtol=SCALAR_RTOL)
    want = hesic_from_jax(grads, tm)
    assert set(want) == set(got)
    exact = None
    for name, g in want.items():
        limit = GRAD_REL * float(g.double().abs().max())
        err = float((got[name] - g.double()).abs().max())
        if err <= limit:
            continue
        if exact is None:
            with jax.enable_x64(True):
                exact = hesic_from_jax(_jax_grads(models, np.float64)[1], tm)
        err64 = float((got[name] - exact[name].double()).abs().max())
        assert err64 <= limit, (name, err, err64, limit)


def test_bf16_losses_match_jax(models, noise):
    _, params, tm = models
    x1, x2 = _pairs(0)
    jb = jd.DSIC(**CFG, dtype=jnp.bfloat16)
    want_loss, want = jax.jit(lambda p, b: _jax_loss_fn(
        jb, p, b, jax.random.PRNGKey(0), noise))(
        jax.tree_util.tree_map(jnp.asarray, params),
        _jax_batch(x1, x2, noise))
    model = td.DSIC(**CFG, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(tm.state_dict())
    assert model.cost_volume1.fold
    with torch.no_grad():
        got_loss, got = make_loss_fn(LMBDA)(
            model, _port_batch(x1, x2), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=2e-2)
    for key in ("bpp", "mse"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=2e-2, err_msg=key)

