"""Port: the reference-layout container codecs (hesic_tpu_torch/models/
hesic_codec.py ``HESICCodec``, dsic_codec.py ``DSICCodec``,
hesic_plus_refcodec.py ``HESICPlusRefCodec``) against the JAX package's,
on the CPU, at the JAX tests' tiny configs (HESIC N16/M24/K2, DSIC
N16/M24/F6/C4/K2, HESIC+ N16/M24; one 64x64 pair), the JAX parameters
carried over by hesic_from_jax.

* The port's round trips through the two files are exact (decoded
  y1_hat/y2_hat equal to the encoder's), at the identity and a rotated
  homography; decoding is self-contained (H from the header) and equals
  decoding with H passed.
* The header agrees with the JAX container's field by field (H, W; per
  eye len(z), minmax, the nonzero-channel bitmap, the z string; the
  homography), the port coding z with JAX's EntropyBottleneck tables
  (the tables are float math: tests/test_torch_host_rans.py has their
  bound).
* ``_gmm_cdf_rows`` on identical inputs: symbols equal; rows within
  ROW_TOL = 4 counts of JAX's (torch.erfc and XLA:CPU's erfc differ in
  the last bit, which can flip the rounding of a bin; the cumulative
  sum carries each flip along the row: measured 1 count on 0.1-0.6% of
  the entries), and identical
  whether or not the channels are chunked.  ``_bucket_minmax`` equals
  JAX's.
* ``_walk_eye`` (HESIC+) on identical numpy inputs and weights: bodies
  byte-identical to JAX's, and each side's walk decodes the other's.
* Cross-decode at the coder layer (HESIC, DSIC): a JAX body decodes with
  the port's RangeDecoder on JAX's rows to JAX's latents, and a port body
  with JAX's RangeDecoder on the port's rows to the port's.
* bpp_real within BPP_REL = 3% of JAX's at the same weights and input.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.models as jmodels
from hesic_tpu import codecs as jcodecs
from hesic_tpu.models import hesic_codec as j_hc
from hesic_tpu.models import hesic_plus_refcodec as j_ref
from hesic_tpu_torch.codecs import RangeDecoder, RangeEncoder
from hesic_tpu_torch.models import hesic_codec, hesic_plus_refcodec
from hesic_tpu_torch.models.autoregressive import extract_ar_weights
from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.dsic_codec import DSICCodec
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_codec import HESICCodec, read_header
from hesic_tpu_torch.models.hesic_plus import HESICPlus
from hesic_tpu_torch.models.hesic_plus_refcodec import HESICPlusRefCodec
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

HW = 64
ROW_TOL = 4
BPP_REL = 0.03
SHAPES = [(1, HW, HW, 3), (1, HW, HW, 3), (1, 3, 3)]
# name: (JAX model, JAX codec, port model, port codec, takes H)
CASES = {
    "hesic": (lambda: jmodels.HESIC(N=16, M=24, K=2), jmodels.HESICCodec,
              lambda: HESIC(N=16, M=24, K=2, device="cpu"), HESICCodec,
              True),
    "dsic": (lambda: jmodels.DSIC(N=16, M=24, F=6, C=4, K=2),
             jmodels.DSICCodec,
             lambda: DSIC(N=16, M=24, F=6, C=4, K=2, device="cpu"),
             DSICCodec, False),
    "hesic-plus": (lambda: jmodels.HESICPlus(N=16, M=24),
                   jmodels.HESICPlusRefCodec,
                   lambda: HESICPlus(N=16, M=24, device="cpu"),
                   HESICPlusRefCodec, True),
}


def _rotated(deg=3.0, tx=2.0, ty=-1.5):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th), tx],
                     [np.sin(th), np.cos(th), ty], [0, 0, 1]],
                    np.float32)[None]


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, HW, HW, 3).astype(np.float32),
            rng.rand(1, HW, HW, 3).astype(np.float32))


def _args(takes_h, x1, x2, h):
    return (x1, x2, h) if takes_h else (x1, x2)


def _build(name, path):
    """(name, takes H, the JAX codec, the port's model, the port's codec
    coding z with JAX's tables, the JAX container on pair 0 at the rotated
    H: (header, body, its compress output))."""
    j_model, j_codec, t_model, t_codec, takes_h = CASES[name]
    base = j_codec.init(j_model(), SHAPES if takes_h else SHAPES[:2],
                        seed=0)
    base.update()
    tm = t_model()
    tm.load_state_dict(hesic_from_jax(
        jax.tree_util.tree_map(np.asarray, base.params), tm))
    cdc = t_codec(tm).update()
    for eb in tm.entropy_bottlenecks:
        cdc.tables[eb] = base.tables[eb]
    x1, x2 = _pair()
    out = base.compress(*_args(takes_h, jnp.asarray(x1), jnp.asarray(x2),
                               jnp.asarray(_rotated())), "pair", path)
    return name, takes_h, base, tm, cdc, (*out["strings"], out)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """name -> _build(name), each built once for the module."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _build(name, str(tmp_path_factory.mktemp(name)))
        return built[name]

    return get


@pytest.mark.parametrize("rotated", [False, True], ids=["identity",
                                                         "rotated"])
@pytest.mark.parametrize("name", list(CASES))
def test_round_trip_exact_and_self_contained(cases, name, tmp_path, rotated):
    _, takes_h, _, _, cdc, _ = cases(name)
    x1, x2 = _pair(1)
    h = _rotated() if rotated else np.eye(3, dtype=np.float32)[None]
    out = cdc.compress(*_args(takes_h, x1, x2, h), "pair", str(tmp_path))
    assert (tmp_path / "pair.npz").read_bytes() == out["strings"][0]
    assert (tmp_path / "pair.bin").read_bytes() == out["strings"][1]
    rec = cdc.decompress("pair", str(tmp_path))
    for key in ("y1_hat", "y2_hat"):
        assert torch.equal(rec[key], out[key]), key
    for key in ("x1_hat", "x2_hat"):
        assert tuple(rec[key].shape) == x1.shape
        assert bool(torch.isfinite(rec[key]).all())
    assert 0 < out["bpp_side"] < out["bpp_real"]
    if takes_h:
        np.testing.assert_array_equal(rec["h_matrix"], h)
        passed = cdc.decompress("pair", str(tmp_path), h_matrix=h)
        for key in ("y1_hat", "y2_hat", "x1_hat", "x2_hat"):
            assert torch.equal(passed[key], rec[key]), key


@pytest.mark.parametrize("name", list(CASES))
def test_header_fields_match_jax(cases, name, tmp_path):
    _, takes_h, _, tm, cdc, (j_header, _, _) = cases(name)
    x1, x2 = _pair()
    out = cdc.compress(*_args(takes_h, x1, x2, _rotated()), "pair",
                       str(tmp_path))
    got = read_header(out["strings"][0], tm.M, takes_h)
    want = read_header(j_header, tm.M, takes_h)
    assert got[0] == want[0] == (HW, HW)
    for eye, (g, w) in enumerate(zip(got[1], want[1])):
        assert g[0] == w[0], f"eye {eye + 1} minmax"
        np.testing.assert_array_equal(g[1], w[1], f"eye {eye + 1} bitmap")
        assert g[2] == w[2], f"eye {eye + 1} z string"
    if takes_h:
        np.testing.assert_array_equal(got[2], want[2])
    assert out["strings"][0] == j_header


def _gmm_inputs(seed, k=3, m=16, h=4, w=5):
    rng = np.random.RandomState(seed)
    sigma = (np.abs(rng.randn(1, h, w, m * k)) * 3).astype(np.float32)
    sigma[0, 0, 0, :4] = 0.01                  # below the scale bound
    means = (rng.randn(1, h, w, m * k) * 4).astype(np.float32)
    mix = rng.rand(k, m).astype(np.float32)      # a mixture per channel
    weights = (mix / mix.sum(0)).reshape(1, 1, 1, k * m)
    y_hat = np.round(rng.randn(1, h, w, m) * 5).astype(np.float32)
    return sigma, means, weights, y_hat, k


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed,minmax", [(0, 8), (1, 16), (2, 24)])
def test_gmm_cdf_rows_close_to_jax(seed, minmax, monkeypatch):
    sigma, means, weights, y_hat, k = _gmm_inputs(seed)
    j_rows, j_sym = j_hc._gmm_cdf_rows(*map(jnp.asarray, (
        sigma, means, weights, y_hat)), minmax, k)
    args = [_nchw(a) for a in (sigma, means, weights, y_hat)]
    rows, sym = hesic_codec._gmm_cdf_rows(*args, minmax, k)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(j_sym))
    assert rows.dtype == torch.int32 and rows.shape == j_rows.shape
    assert int(np.abs(rows.numpy() - np.asarray(j_rows)).max()) <= ROW_TOL
    assert (rows[..., 0] == 0).all() and (rows.diff(dim=-1) > 0).all()
    monkeypatch.setattr(hesic_codec, "CHUNK_BYTES", 1)   # one channel
    assert torch.equal(hesic_codec._gmm_cdf_rows(*args, minmax, k)[0], rows)


def test_bucket_minmax_equals_jax():
    for v in (0, 0.4, 1, 7, 8, 8.5, 9, 63, 64, 65, 1000):
        assert hesic_codec._bucket_minmax(v) == j_hc._bucket_minmax(v)
    y = np.array([[-3.0, 2.0], [0.0, 1.0]], np.float32)
    assert (hesic_plus_refcodec._minmax_of(y) == j_ref._minmax_of(y) == 3)


def test_walk_eye_bodies_byte_identical_to_jax(cases):
    _, _, base, tm, _, _ = cases("hesic-plus")
    rng = np.random.RandomState(3)
    m, h, w = tm.M, 3, 4
    pre = rng.randn(h, w, 2 * m).astype(np.float32)
    post = rng.randn(h, w, m).astype(np.float32)
    y = np.round(rng.randn(h, w, m) * 3).astype(np.float32)
    y[..., 5] = 0                              # a channel left out
    nz = np.flatnonzero(np.abs(y).sum(axis=(0, 1)) > 0)
    minmax = j_ref._minmax_of(y)
    bodies = []
    for eye, p in ((1, None), (2, post)):
        t_w = extract_ar_weights(tm, f"context_prediction{eye}",
                                 f"entropy_parameters{eye}")
        names = (f"context_prediction{eye}", f"entropy_parameters{eye}")
        t_enc, j_enc = RangeEncoder(), jcodecs.RangeEncoder()
        hesic_plus_refcodec._walk_eye(t_w, pre, p, minmax, nz, m, y_hat=y,
                                      enc=t_enc)
        j_ref._walk_eye(base.params, *names, pre, p, minmax, nz, m,
                        y_hat=y, enc=j_enc)
        t_body, j_body = t_enc.close(), j_enc.close()
        assert t_body == j_body, f"eye {eye}"
        np.testing.assert_array_equal(hesic_plus_refcodec._walk_eye(
            t_w, pre, p, minmax, nz, m, dec=RangeDecoder(j_body)), y)
        np.testing.assert_array_equal(j_ref._walk_eye(
            base.params, *names, pre, p, minmax, nz, m,
            dec=jcodecs.RangeDecoder(t_body)), y)
        bodies.append(t_body)
    assert bodies[0] != bodies[1]


def _eye_rows(gmms, eyes, k, rows_fn):
    """Each eye's rows of its nonzero channels, from the header's eyes and
    the eyes' GMM heads."""
    out = []
    for gmm, (minmax, flags, _) in zip(gmms, eyes):
        nz = np.flatnonzero(flags)
        rows = np.asarray(rows_fn(gmm, minmax, k))[nz]
        out.append((rows.reshape(-1, rows.shape[-1]), minmax, nz))
    return out


def _decode_rows(dec, eye_rows, shape):
    """Decode each eye's nonzero channels -> [(M', h, w) symbols]."""
    return [(dec.decode_rows(rows) - minmax).reshape(nz.size, *shape)
            for rows, minmax, nz in eye_rows]


@pytest.mark.parametrize("name", ["hesic", "dsic"])
def test_cross_decode_at_the_coder_layer(cases, name, tmp_path):
    _, takes_h, base, tm, cdc, (j_header, j_body, j_out) = cases(name)
    lat = (HW // 16, HW // 16)
    k, m = tm.K, tm.M
    h = _rotated()
    # JAX's container on JAX's rows, decoded by the port's range decoder
    _, eyes, _ = read_header(j_header, m, takes_h)
    z_hat = [base.eb_decompress(f"entropy_bottleneck{i + 1}", [e[2]],
                                (lat[0] // 4, lat[1] // 4))
             for i, e in enumerate(eyes)]
    y1 = j_out["y1_hat"]
    prior = (base.jit("left_prior")(base.jit("synthesis1")(y1),
                                    jnp.asarray(h)) if takes_h else y1)
    gmms = [base.jit("gmm1")(z_hat[0]), base.jit("gmm2")(z_hat[1], prior)]
    rows = _eye_rows(gmms, eyes, k, lambda g, mm, kk: j_hc.
                     _gmm_cdf_rows(*g, jnp.zeros(y1.shape), mm, kk)[0])
    got = _decode_rows(RangeDecoder(j_body), rows, lat)
    for eye, (syms, (_, _, nz)) in enumerate(zip(got, rows)):
        want = np.asarray(j_out[f"y{eye + 1}_hat"])[0].transpose(2, 0, 1)
        np.testing.assert_array_equal(syms, want[nz])
    # the port's container on the port's rows, by JAX's range decoder
    x1, x2 = _pair()
    out = cdc.compress(*_args(takes_h, x1, x2, h), "pair", str(tmp_path))
    header, body = out["strings"]
    _, eyes, _ = read_header(header, m, takes_h)
    with torch.no_grad():
        z_hat = [cdc.eb_decompress(f"entropy_bottleneck{i + 1}", [e[2]],
                                   (lat[0] // 4, lat[1] // 4))
                 for i, e in enumerate(eyes)]
        y1 = out["y1_hat"].permute(0, 3, 1, 2).contiguous()
        hm = torch.from_numpy(h)
        prior = (tm.left_prior(tm.synthesis1(y1).contiguous(), hm)
                 if takes_h else y1)
        gmms = [tm.gmm1(z_hat[0]), tm.gmm2(z_hat[1], prior.contiguous())]
        rows = _eye_rows(gmms, eyes, k, lambda g, mm, kk: hesic_codec.
                         _gmm_cdf_rows(*g, None, mm, kk)[0].numpy())
    got = _decode_rows(jcodecs.RangeDecoder(body), rows, lat)
    for eye, (syms, (_, _, nz)) in enumerate(zip(got, rows)):
        want = out[f"y{eye + 1}_hat"][0].permute(2, 0, 1).numpy()
        np.testing.assert_array_equal(syms, want[nz])


@pytest.mark.parametrize("name", list(CASES))
def test_bpp_close_to_jax(cases, name, tmp_path):
    _, takes_h, _, _, cdc, (_, _, j_out) = cases(name)
    x1, x2 = _pair()
    out = cdc.compress(*_args(takes_h, x1, x2, _rotated()), "pair",
                       str(tmp_path))
    assert abs(out["bpp_real"] / j_out["bpp_real"] - 1) < BPP_REL
    assert abs(out["bpp_side"] - j_out["bpp_side"]) < 1e-12
