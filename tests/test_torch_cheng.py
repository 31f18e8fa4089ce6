"""Port: Cheng2020 (hesic_tpu_torch/models/waseda.py, its blocks in
hesic_tpu_torch/layers/layers.py) and its codecs against the JAX package,
on the CPU, at N=16 (M=16), 64x64 images, B=2, float32, the JAX
parameters carried over by hesic_from_jax (strict load).  Kernels 4 and 5
run as their plain twins here.

Tolerances:
* blocks and the hyper, context and entropy-parameter sub-programs atol
  2e-5 (float32 convs summed in another order); the analysis within 5e-6
  of the largest |value| (values up to ~100, measured 1.2e-6); the
  synthesis and x_hat, whose random-weight IGDN cascade amplifies to
  ~1e4-1e7, within 1e-4 of it (measured 2.2e-5); likelihoods atol 2e-4
  (y carries up to ~6e-5 of float error and a Gaussian bin's slope is up
  to 1/(0.11 sqrt(2 pi)) = 3.6; measured 5.7e-5);
* training forward: both sides take their noise from one numpy sequence
  (test_torch_training's ``Noise``) in JAX's draw order: z in the
  bottleneck, y_hat, the Gaussian conditional's own draw;
* the level scan (twin) against JAX's lax.scan on lattice inputs (JAX's
  own y_hat, where no residual may flip): residuals equal, y_hat within
  1e-6 of the largest |y_hat| (values up to ~90; measured 3.3e-7),
  starts/freqs within +-2 counts on valid slots (A&S Phi against
  XLA's erfc), as tests/test_torch_wavefront.py;
* the device codec against JAX's JointAutoregressiveDeviceCodec: y_hat
  within 1e-4 off the rounding margin, bpp_real within 1%; its own round
  trip bit-exact, escapes included;
* the host codec: z and y strings byte-identical to JAX's at equal
  inputs and tables, its own round trip exact;
* the port's random init (torch.nn.Conv2d's default draw, as the
  reference's Cheng2020 keeps it) keeps x_hat within 10 where the JAX
  package's kaiming init, carried over, reaches beyond 100;
  ``layers.ImageConv`` (stride-1 3x3 convs image by image) equals the
  batched conv within 1e-5 and is a plain conv for one image or bf16;
* kernel 5's weight packing at N=16's ragged widths (H1 53, H2 42,
  padded to 64 and 48): the MLP in a fixed summation order gives
  bit-equal outputs with and without the padding, the padded hidden
  units are exactly 0, and the level plans at the padded widths of
  N=16, 128 and 192 keep the C entry's rules.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import hesic_tpu.layers.layers as jl
import hesic_tpu.ops.ops as j_ops
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.models import (Cheng2020Anchor as JAnchor,
                              Cheng2020Attention as JAttention,
                              JointAutoregressiveCodec as JCodec)
from hesic_tpu.models.ar_device import (
    JointAutoregressiveDeviceCodec as JDeviceCodec)
from hesic_tpu.models.ar_device import ar_wavefront as j_ar_wavefront
from hesic_tpu.models.autoregressive import ar_compress as j_ar_compress
from hesic_tpu.models.autoregressive import (
    extract_ar_weights as j_extract_ar_weights)
from hesic_tpu_torch import layers as tl
from hesic_tpu_torch.layers.layers import _ResidualUnit
from hesic_tpu_torch.models.ar_device import (
    JointAutoregressiveDeviceCodec, schedule, wavefront_valid_mask)
from hesic_tpu_torch.models.autoregressive import (ArWeights, ar_compress,
                                                   extract_ar_weights)
from hesic_tpu_torch.models.codec import JointAutoregressiveCodec
from hesic_tpu_torch.models.waseda import Cheng2020Anchor, Cheng2020Attention
from hesic_tpu_torch.models.wavefront import (ar_wavefront,
                                              ar_wavefront_plain,
                                              hoisted_base_plain,
                                              pack_weights)
from test_torch_wavefront import check_level_plans
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from test_torch_training import Noise

torch.set_num_threads(2)

ATOL = 2e-5
# relative to the largest |value|: the analysis (values up to ~100;
# measured 1.2e-6) and the synthesis (measured 2.2e-5)
REL = {"analysis": 5e-6, "synthesis": 1e-4}
LIK_ATOL = 2e-4
SCAN_REL = 1e-6
N = 16
VARIANTS = {"anchor": (JAnchor, Cheng2020Anchor),
            "attn": (JAttention, Cheng2020Attention)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.array(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _images(seed=0, b=2):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _close_rel(got, want, rel):
    """Within `rel` of the largest |want|."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    jcls, tcls = VARIANTS[request.param]
    base = JCodec.init(jcls(N=N, M=N), [(1, 64, 64, 3)], seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    tm = tcls(N=N, M=N, device="cpu")
    tm.load_state_dict(hesic_from_jax(params, tm))
    return base, params, tm


@pytest.fixture
def noise(monkeypatch):
    jn = Noise()
    monkeypatch.setattr(j_ops, "quantize_noise", jn.jax)
    monkeypatch.setattr(t_ops, "quantize_noise", Noise().torch)
    return jn


# ---- the blocks ----

BLOCKS = {
    "SubpelConv3x3": (lambda: jl.SubpelConv3x3(features=8, r=2),
                      lambda: tl.SubpelConv3x3(16, 8, 2)),
    "ResidualBlockWithStride s2": (
        lambda: jl.ResidualBlockWithStride(features=16, stride=2),
        lambda: tl.ResidualBlockWithStride(16, 16, 2)),
    "ResidualBlockWithStride s1": (
        lambda: jl.ResidualBlockWithStride(features=16, stride=1),
        lambda: tl.ResidualBlockWithStride(16, 16, 1)),
    "ResidualBlockUpsample": (
        lambda: jl.ResidualBlockUpsample(features=16, upsample=2),
        lambda: tl.ResidualBlockUpsample(16, 16, 2)),
    "ResidualBlock": (lambda: jl.ResidualBlock(features=16),
                      lambda: tl.ResidualBlock(16, 16)),
    "_ResidualUnit": (lambda: jl._ResidualUnit(features=16),
                      lambda: _ResidualUnit(16)),
    "AttentionBlock": (lambda: jl.AttentionBlock(features=16),
                       lambda: tl.AttentionBlock(16)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    jmake, tmake = BLOCKS[name]
    x = np.random.RandomState(1).randn(2, 8, 8, 16).astype(np.float32)
    jm = jmake()
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = tmake()
    tm.load_state_dict(hesic_from_jax(params, tm))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pixel_shuffle_channel_order_is_torchs():
    """flax's pixel_shuffle and F.pixel_shuffle agree on a ramp: the
    subpel conv's channels map one to one."""
    from hesic_tpu.layers.conv import pixel_shuffle
    x = np.arange(2 * 3 * 4 * 12, dtype=np.float32).reshape(2, 3, 4, 12)
    want = np.asarray(pixel_shuffle(jnp.asarray(x), 2))
    got = _nhwc(torch.nn.functional.pixel_shuffle(_nchw(x), 2))
    np.testing.assert_array_equal(got, want)


# ---- the models ----

def test_from_jax_maps_every_parameter(models):
    _, params, tm = models
    sd = hesic_from_jax(params, tm)
    assert set(sd) == set(tm.state_dict())
    n_ga = 9 if isinstance(tm, Cheng2020Attention) else 7
    assert sorted({k.split(".")[0] for k in sd}) == sorted(
        [f"g_a_{i}" for i in range(n_ga)]
        + [f"g_s_{i}" for i in range(n_ga + 1)]
        + [f"h_a_{i}" for i in (0, 2, 4, 6, 8)]
        + [f"h_s_{i}" for i in (0, 2, 4, 6, 8)]
        + [f"entropy_parameters_{i}" for i in (0, 2, 4)]
        + ["context_prediction", "entropy_bottleneck"])
    assert tuple(sd["entropy_parameters_0.weight"].shape) == (53, 64, 1, 1)
    assert tuple(sd["entropy_parameters_2.weight"].shape) == (42, 53, 1, 1)


SUBPROGRAMS = [
    ("analysis", [(2, 64, 64, 3)]),
    ("synthesis", [(2, 4, 4, N)]),
    ("hyper_analysis", [(2, 4, 4, N)]),
    ("hyper_synthesis", [(2, 1, 1, N)]),
    ("entropy_params", [(2, 4, 4, 4 * N)]),
    ("context", [(2, 4, 4, N)]),
]


@pytest.mark.parametrize("method,shapes", SUBPROGRAMS,
                         ids=[s[0] for s in SUBPROGRAMS])
def test_subprograms_match_flax(models, method, shapes):
    base, params, tm = models
    xs = [np.random.RandomState(i).randn(*s).astype(np.float32)
          for i, s in enumerate(shapes)]
    want = np.asarray(base.module.apply(
        {"params": params}, *[jnp.asarray(x) for x in xs], method=method))
    with torch.no_grad():
        got = _nhwc(getattr(tm, method)(*[_nchw(x) for x in xs]))
    if method in REL:
        _close_rel(got, want, REL[method])
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("training", [True, False])
def test_forward_matches_jax(models, noise, training):
    base, params, tm = models
    x = _images()
    y = (2, 4, 4, N)
    noise.fed = noise.feed([(N, 1, 2), y, y] if training else [])
    want = base.module.apply({"params": params}, jnp.asarray(x),
                             training=training,
                             rngs={"noise": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm(_nchw(x), training=training,
                 generator=torch.Generator().manual_seed(0))
    _close_rel(_nhwc(got["x_hat"]), np.asarray(want["x_hat"]),
               REL["synthesis"])
    for key in ("y", "z"):
        np.testing.assert_allclose(_nhwc(got["likelihoods"][key]),
                                   np.asarray(want["likelihoods"][key]),
                                   atol=LIK_ATOL, rtol=0, err_msg=key)
    assert not noise.fed


# ---- the wavefront device codec ----

def _round_trip(cdc, x):
    out = cdc.compress(x)
    rec = cdc.decompress(out["strings"])
    torch.testing.assert_close(rec["y_hat"], out["y_hat"], rtol=0, atol=0)
    return out, rec


def test_device_codec_round_trip(models):
    cdc = JointAutoregressiveDeviceCodec(models[2], mm=8, groups=4).update()
    assert cdc.latent_ch == N
    out, rec = _round_trip(cdc, _images(seed=1))
    assert out["y_hat"].shape == (2, 4, 4, N)
    assert tuple(rec["x_hat"].shape) == (2, 64, 64, 3)
    hot = JointAutoregressiveDeviceCodec(models[2], mm=1, groups=4).update()
    out, _ = _round_trip(hot, (_images(seed=2) * 4 - 1.5).astype(np.float32))
    assert out["escapes"] > 0


def test_level_scan_matches_jax(models):
    """The twin against JAX's lax.scan at Cheng2020's ragged widths, on
    lattice inputs (JAX's own y_hat of the model's latents)."""
    base, params, tm = models
    x = jnp.asarray(_images(seed=3))
    y = base.jit("analysis")(x)
    pre = base.jit("hyper_synthesis")(jnp.round(base.jit("hyper_analysis")(
        y)))
    b, hy, wy, m = y.shape
    mm, groups = 8, 4
    lanes = b * schedule(hy, wy)[3] * (m // groups)
    zimg = jnp.zeros((b, hy, wy, m), jnp.int32)
    zl = jnp.zeros((lanes,), jnp.int32)
    jw = j_extract_ar_weights(base.params)

    def scan(y_in):
        return [np.asarray(a) for a in j_ar_wavefront(
            jw, pre, jnp.zeros((b, hy, wy, 0), jnp.float32), y_in, zimg,
            zimg, jnp.zeros((lanes, 1), jnp.int32), zl,
            zl.astype(jnp.uint32), jnp.bool_(True), hy, wy, mm, groups)]

    lattice = jnp.asarray(scan(y)[2])
    want = scan(lattice)
    got = [t.numpy() for t in ar_wavefront_plain(
        extract_ar_weights(tm), torch.from_numpy(np.array(pre)), None,
        torch.from_numpy(np.array(lattice)), None, None, None, None, None,
        True, mm, groups)]
    valid = wavefront_valid_mask(hy, wy, b, groups, m).numpy()
    np.testing.assert_array_equal(got[3], want[3])
    _close_rel(got[2], want[2], SCAN_REL)
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g.astype(np.int64) - w)[valid].max() <= 2
    # the packed (padded) weights run the twin at the real widths
    packed = ar_wavefront(pack_weights(extract_ar_weights(tm)),
                          torch.from_numpy(np.array(pre)), None,
                          torch.from_numpy(np.array(lattice)), None, None,
                          None, None, None, True, mm, groups)
    for a, w in zip(packed, got):
        np.testing.assert_array_equal(a.numpy(), w)


def test_device_codec_matches_jax_codec(models):
    base, _, tm = models
    x = _images(seed=4)
    j_out = JDeviceCodec(base, mm=8, groups=4).compress(jnp.asarray(x))
    t_out = JointAutoregressiveDeviceCodec(tm, mm=8, groups=4).update(
    ).compress(x)
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.01
    with torch.no_grad():
        raw = _nhwc(tm.analysis(_nchw(x)))
    ty, jy = t_out["y_hat"].numpy(), np.asarray(j_out["y_hat"])
    keep = ~(np.abs(np.abs(raw - ty) - 0.5) < 1e-4)
    assert keep.mean() > 0.95
    np.testing.assert_allclose(ty[keep], jy[keep], atol=1e-4, rtol=0)


# ---- the host AR codec ----

def test_host_codec_strings_byte_identical_to_jax(models):
    base, _, tm = models
    x = jnp.asarray(_images(seed=5))
    y = base.jit("analysis")(x)
    z = base.jit("hyper_analysis")(y)
    z_strings = base.eb_compress("entropy_bottleneck", z)
    z_hat = base.eb_decompress("entropy_bottleneck", z_strings, z.shape[1:3])
    params = base.jit("hyper_synthesis")(z_hat)
    j_strs, j_yhat = j_ar_compress(base, y, params)
    cdc = JointAutoregressiveCodec(tm).update()
    cdc.tables = dict(base.tables)
    cdc.scale_table = np.asarray(base.scale_table)
    assert cdc.eb_compress("entropy_bottleneck", _nchw(z)) == z_strings
    t_strs, t_yhat = ar_compress(cdc, _nchw(y), _nchw(params))
    assert t_strs == j_strs
    np.testing.assert_array_equal(_nhwc(t_yhat), np.asarray(j_yhat))


def test_host_codec_round_trip(models):
    cdc = JointAutoregressiveCodec(models[2]).update()
    x = _images(seed=6)
    out = cdc.compress(x)
    rec = cdc.decompress(out["strings"], out["shape"])
    torch.testing.assert_close(rec["y_hat"], out["y_hat"], rtol=0, atol=0)
    assert tuple(rec["x_hat"].shape) == x.shape and out["bpp_real"] > 0


# ---- the random init and ImageConv ----

def test_random_init_is_conv2ds_default(models):
    _, _, carried = models
    tm = type(carried)(N=N, M=N, device="cpu", seed=1)
    for name, mod in tm.named_modules():
        if isinstance(mod, (tl.Conv, tl.MaskedConv2d)):
            bound = 1 / np.sqrt(mod.weight[0].numel())
            assert float(mod.weight.abs().max()) <= bound, name
            assert float(mod.bias.abs().max()) <= bound, name
            assert mod.bias.abs().sum() > 0, name
    x = _nchw(_images(seed=7))
    with torch.no_grad():
        own = tm(x)["x_hat"]
        jax_init = carried(x)["x_hat"]
    assert float(own.abs().max()) < 10 < 100 < float(jax_init.abs().max())


def test_image_conv_equals_the_batched_conv():
    conv = tl.conv3x3(16, 8, generator=torch.Generator().manual_seed(0))
    assert isinstance(conv, tl.ImageConv)
    assert not isinstance(tl.conv3x3(16, 8, 2), tl.ImageConv)
    x = torch.randn(3, 16, 9, 7, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = conv(x)
        want = tl.Conv.forward(conv, x)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        for i in range(3):
            assert torch.equal(got[i:i + 1], conv(x[i:i + 1]))
        half = conv(x.to(torch.bfloat16))
    assert half.dtype == torch.bfloat16 and half.shape == got.shape


# ---- kernel 5's packing at ragged widths ----

def _ragged_weights(m=16, seed=0):
    """Random AR weights at Cheng2020 N=16's widths: pre 2N, H1 53, H2
    42."""
    rng = np.random.RandomState(seed)
    h1, h2 = m * 10 // 3, m * 8 // 3
    f = np.float32

    def t(*shape, s=0.2):
        return torch.from_numpy((rng.randn(*shape) * s).astype(f))

    return ArWeights(t(5, 5, m, 2 * m), t(2 * m),
                     (t(4 * m, h1), t(h1, h2), t(h2, 2 * m)),
                     (t(h1, s=0.1), t(h2, s=0.1), t(2 * m, s=0.1)))


def _mlp_fixed_order(feat, w0, b0, w1, b1, w2, b2):
    """The entropy-parameter MLP with every sum in ascending k, one term
    at a time (float32): trailing zero terms leave a sum unchanged."""
    def layer(a, w, b):
        acc = b.expand(a.shape[0], -1).clone()
        for k in range(w.shape[0]):
            acc = acc + a[:, k:k + 1] * w[k]
        return acc

    g1 = torch.nn.functional.leaky_relu(layer(feat, w0, b0), 0.01)
    g2 = torch.nn.functional.leaky_relu(layer(g1, w1, b1), 0.01)
    return g1, g2, layer(g2, w2, b2)


def test_padded_packing_is_exact_at_ragged_widths():
    m = 16
    raw = _ragged_weights(m)
    pk = pack_weights(raw)
    assert tuple(pk.w1.shape) == (64, 48) and tuple(pk.w2.shape) == (48, 32)
    assert tuple(pk.w0_ctx.shape) == (2 * m, 64) and pk.b0.shape == (64,)
    assert pk.raw is raw
    feat = torch.from_numpy(np.random.RandomState(1).randn(
        37, 4 * m).astype(np.float32))
    w0p = torch.cat([pk.w0_pp[:2 * m], pk.w0_ctx], 0)   # P rows, then ctx
    g1, g2, got = _mlp_fixed_order(feat, w0p, pk.b0, pk.w1, pk.b1, pk.w2,
                                   raw.ep_biases[2])
    _, _, want = _mlp_fixed_order(feat, *[t for pair in zip(
        raw.ep_kernels, raw.ep_biases) for t in pair])
    assert torch.equal(got, want)
    assert not g1[:, 53:].any() and not g2[:, 42:].any()
    # the hoisted product's padded columns are exactly 0
    pre = torch.from_numpy(np.random.RandomState(2).randn(
        2, 3, 4, 2 * m).astype(np.float32))
    base = hoisted_base_plain(pk, pre, None)
    assert base.shape == (2, 3, 4, 64) and not base[..., 53:].any()


@pytest.mark.parametrize("n", [16, 128, 192])
def test_level_plans_at_padded_widths_keep_the_c_rules(n):
    """wavefront.cu's level_plan_ok and shared memory at Cheng2020's
    padded widths (N=128: H1 426 -> 432, H2 341 -> 352): every level's
    plan at B=64 and B=11 fits, and each product's columns are owned by
    exactly one block of a cluster."""
    pk_h1, pk_h2 = pack_weights(_ragged_weights(n)).w1.shape
    assert pk_h1 == -(-n * 10 // 3 // 16) * 16
    assert pk_h2 == -(-n * 8 // 3 // 16) * 16
    check_level_plans(n, pk_h1, pk_h2)


def test_multiple_of_16_widths_pack_unchanged():
    """mbt2018 / HESIC+ / Cheng2020 at N=192 widths (640, 512): nothing
    is padded."""
    rng = np.random.RandomState(3)
    m = 48

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    raw = ArWeights(t(5, 5, m, 2 * m), t(2 * m),
                    (t(4 * m, 160), t(160, 128), t(128, 2 * m)),
                    (t(160), t(128), t(2 * m)))
    pk = pack_weights(raw)
    for got, want in ((pk.w1, raw.ep_kernels[1]), (pk.w2, raw.ep_kernels[2]),
                      (pk.b0, raw.ep_biases[0]), (pk.b1, raw.ep_biases[1])):
        assert torch.equal(got, want)
    assert pk.w0_ctx.shape == (2 * m, 160)
