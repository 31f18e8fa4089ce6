"""Port: the host autoregressive path of mbt2018 against the JAX package,
on the CPU: the Gaussian conditional's host side
(hesic_tpu_torch/entropy_models), the native coders
(hesic_tpu_torch/codecs/host_rans.py over its own rans.cpp), the host AR
paths (hesic_tpu_torch/models/autoregressive.py) and
``JointAutoregressiveCodec`` (hesic_tpu_torch/models/codec.py).

* The scale table and ``build_indexes`` equal the JAX package's
  (tolerance 0).
* ``gaussian_pmf_data``: lengths and offsets equal; PMF and tail mass
  within 2.4e-7 absolute (2 ULP at 1; torch.erfc and XLA:CPU's erfc
  differ in the last bit: measured 1.2e-7).  From the same PMF the tables
  are equal.  From each side's own PMF at most 4 of the 64 rows differ
  (measured 2), in at most 3% of the CDF entries in use, by at most 256
  counts (measured 1.9% and 134: a 1-ULP change flips one rounding,
  which the quantizer's renormalization and steal spread along the
  row).
* The reference streams of tests/fixtures/ref_rans_streams.npz decode
  and re-encode byte for byte, and the ``wide`` stream walks statefully
  in chunks of 97.
* ``ar_code`` of the port and of the JAX package on identical numpy
  weights, pre, post, tables and y: byte-identical strings, bit-equal
  y_hat, and each decodes the other's string; with and without post,
  and with large y that takes the bypass path.  This also guards the
  host library's build flags (-ffp-contract=off, -march=native); the
  library's file name carries the host's resolved target options.
* ``ar_decompress_reference`` (numpy) equals ``ar_decompress`` within
  1e-5 (its products sum in numpy's order: measured 1.5e-6 on values
  of magnitude ~10), and ``ar_encode_scan`` (torch) gives the native
  coder's y_hat within 1e-4.
* ``JointAutoregressiveCodec`` at N16/M24, 64x64, B=2, the JAX weights
  carried by hesic_from_jax: its own round trip is exact, also after
  the model's AR weights change and ``update(force=True)`` (a fresh
  codec decodes the new strings); z strings are
  byte-identical to JAX's at equal z symbols and tables (channel-major
  order); y_hat is within 1e-4 of JAX's on every cell not within 1e-4
  of a rounding boundary; bpp_real within 1%.  gc_compress gives JAX's
  strings at equal inputs and tables.
* The bench's ``--model mbt`` point runs on the CPU at a tiny size and
  every round trip is exact.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu import codecs as jcodecs
from hesic_tpu.entropy_models import build_indexes as j_build_indexes
from hesic_tpu.entropy_models import codec as jcodec
from hesic_tpu.entropy_models import entropy_models as jem
from hesic_tpu.models import JointAutoregressiveCodec as JCodec
from hesic_tpu.models import JointAutoregressiveHierarchicalPriors as JMbt
from hesic_tpu.models.autoregressive import ar_compress as j_ar_compress
from hesic_tpu_torch import bench
from hesic_tpu_torch.codecs import host_rans
from hesic_tpu_torch.entropy_models import (build_indexes, codec,
                                            gaussian_pmf_data,
                                            get_scale_table)
from hesic_tpu_torch.models.autoregressive import (ar_compress,
                                                   ar_decompress,
                                                   ar_decompress_reference,
                                                   ar_encode_scan,
                                                   extract_ar_weights)
from hesic_tpu_torch.models.codec import JointAutoregressiveCodec
from hesic_tpu_torch.models.priors import (
    JointAutoregressiveHierarchicalPriors)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

CFG = dict(N=16, M=24)


# ---- scale table, indexes, Gaussian PMFs and tables ----

def test_scale_table_equals_jax():
    np.testing.assert_array_equal(get_scale_table(), jem.get_scale_table())
    assert get_scale_table().dtype == np.float64
    np.testing.assert_array_equal(get_scale_table(0.2, 64, 16),
                                  jem.get_scale_table(0.2, 64, 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_indexes_equal_jax(seed):
    rng = np.random.RandomState(seed)
    scales = np.exp(rng.uniform(-4, 6, (2, 5, 7, 9))).astype(np.float32)
    scales[0, 0, 0, :4] = [0.0, -1.0, 0.11, 256.0]
    table = get_scale_table()
    got = build_indexes(torch.from_numpy(scales), table)
    want = np.asarray(j_build_indexes(jnp.asarray(scales), table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_pmf_data_close_to_jax():
    table = get_scale_table()
    got, want = gaussian_pmf_data(table), jem.gaussian_pmf_data(table)
    for g, w in zip(got[2:], want[2:]):          # lengths and offsets
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[:2], want[:2]):          # pmf and tail mass
        assert g.dtype == np.float32
        assert np.abs(g.astype(np.float64) - w).max() <= 2.4e-7


def test_gaussian_tables_from_same_pmf_equal_jax():
    pmf = jem.gaussian_pmf_data(get_scale_table())
    got, want = codec.tables_from_pmf(*pmf), jcodec.tables_from_pmf(*pmf)
    np.testing.assert_array_equal(got.quantized_cdf, want.quantized_cdf)
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    np.testing.assert_array_equal(got.offset, want.offset)


def test_gaussian_tables_from_own_pmf_close_to_jax():
    got = codec.gaussian_tables(get_scale_table())
    want = jcodec.gaussian_tables(jem.get_scale_table())
    np.testing.assert_array_equal(got.cdf_length, want.cdf_length)
    diff = np.abs(got.quantized_cdf - want.quantized_cdf)
    used = (np.arange(diff.shape[1])[None, :]
            < got.cdf_length[:, None])           # each row's CDF entries
    assert (diff.max(axis=1) > 0).sum() <= 4
    assert diff.max() <= 256 and (diff[used] > 0).mean() <= 0.03


# ---- the reference streams ----

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "ref_rans_streams.npz")
STREAM_CASES = ("small", "bypass", "wide", "tiny")


def _stream_case(name):
    f = np.load(FIXTURES)
    return tuple(f[f"{name}__{k}"] for k in (
        "symbols", "indexes", "cdfs", "cdf_sizes", "offsets")) + (
        f[f"{name}__stream"].tobytes(),)


@pytest.mark.parametrize("name", STREAM_CASES)
def test_reference_stream_decodes_and_reencodes(name):
    symbols, indexes, cdfs, sizes, offsets, stream = _stream_case(name)
    np.testing.assert_array_equal(host_rans.decode_with_indexes(
        stream, indexes, cdfs, sizes, offsets), symbols)
    assert host_rans.encode_with_indexes(symbols, indexes, cdfs, sizes,
                                         offsets) == stream


def test_reference_stream_walked_in_chunks():
    symbols, indexes, cdfs, sizes, offsets, stream = _stream_case("wide")
    dec = host_rans.RansDecoder()
    dec.set_stream(stream)
    out = [dec.decode_stream(indexes[lo:lo + 97], cdfs, sizes, offsets)
           for lo in range(0, len(symbols), 97)]
    np.testing.assert_array_equal(np.concatenate(out), symbols)


# ---- the native AR coder against the JAX package's ----

def test_host_library_is_keyed_on_the_host(monkeypatch):
    """The host library is built with -march=native, so its file name
    carries the host's resolved target options: a build directory
    copied from a host with another CPU holds no library this host
    loads."""
    from hesic_tpu_torch.codecs import build
    tag = build.host_tag()
    assert tag == "portable" or (len(tag) == 12 and set(tag) <= set(
        "0123456789abcdef"))
    path = build.build("rans")
    assert os.path.basename(path) == f"librans-{tag}.so"
    assert not build._stale("rans")
    monkeypatch.setattr(build, "host_tag", lambda: "0123456789ab")
    assert build.lib_path("rans") != path and build._stale("rans")
    assert build.lib_path("pmf") == os.path.join(build.BUILD_DIR,
                                                 "libpmf.so")


def _ar_inputs(seed, m=8, post=True, h=5, w=6, y_scale=3.0):
    rng = np.random.RandomState(seed)
    p, q = 2 * m, (m if post else 0)
    c1, c2 = 10 * m // 3, 8 * m // 3
    cin = p + 2 * m + q
    f = np.float32
    weights = dict(
        ctx_kernel=(rng.randn(5, 5, m, 2 * m) * 0.2).astype(f),
        ctx_bias=(rng.randn(2 * m) * 0.1).astype(f),
        ep_kernels=[(rng.randn(cin, c1) / np.sqrt(cin)).astype(f),
                    (rng.randn(c1, c2) / np.sqrt(c1)).astype(f),
                    (rng.randn(c2, 2 * m) / np.sqrt(c2)).astype(f)],
        ep_biases=[(rng.randn(c1) * 0.1).astype(f),
                   (rng.randn(c2) * 0.1).astype(f),
                   (rng.randn(2 * m) * 0.1 + 1.0).astype(f)])
    pre = rng.randn(h, w, p).astype(f)
    post_a = rng.randn(h, w, q).astype(f) if post else None
    y = (rng.randn(h, w, m) * y_scale).astype(f)
    return weights, pre, post_a, y


AR_CASES = {"post": dict(seed=0), "no post": dict(seed=1, post=False),
            "bypass": dict(seed=2, y_scale=400.0)}


@pytest.mark.parametrize("case", list(AR_CASES))
def test_ar_code_byte_identical_to_jax(case):
    weights, pre, post, y = _ar_inputs(**AR_CASES[case])
    table = get_scale_table()
    tables = jcodec.gaussian_tables(table)
    tw = host_rans.ArWeightsNative(**weights, scale_table=table)
    jw = jcodecs.rans.ArWeightsNative(**weights, scale_table=table)
    t_str, t_yhat = host_rans.ar_code(0, tw, pre, post, tables, y=y)
    j_str, j_yhat = jcodecs.rans.ar_code(0, jw, pre, post, tables, y=y)
    assert t_str == j_str
    np.testing.assert_array_equal(t_yhat, j_yhat)
    if case == "bypass":
        # residuals beyond every table's support are coded raw
        assert np.abs(y).max() > 1000
    np.testing.assert_array_equal(
        host_rans.ar_code(1, tw, pre, post, tables, stream=j_str), j_yhat)
    np.testing.assert_array_equal(
        jcodecs.rans.ar_code(1, jw, pre, post, tables, stream=t_str),
        t_yhat)


# ---- mbt2018's host codec ----

@pytest.fixture(scope="module")
def models():
    base = JCodec.init(JMbt(**CFG), [(1, 64, 64, 3)], seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    model = JointAutoregressiveHierarchicalPriors(**CFG, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return base, model


@pytest.fixture(scope="module")
def host_codec(models):
    return JointAutoregressiveCodec(models[1]).update()


def _images(b=2, seed=0):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _pre(cdc, out):
    z_hat = cdc.eb_decompress("entropy_bottleneck", out["strings"][1],
                              out["shape"])
    with torch.no_grad():
        return cdc.model.hyper_synthesis(z_hat)


def test_update_builds_gaussian_tables(host_codec):
    np.testing.assert_array_equal(host_codec.scale_table, get_scale_table())
    want = codec.gaussian_tables(get_scale_table())
    got = host_codec.tables["gaussian_conditional"]
    np.testing.assert_array_equal(got.quantized_cdf, want.quantized_cdf)
    assert set(host_codec.tables) == {"entropy_bottleneck",
                                      "gaussian_conditional"}


@pytest.mark.parametrize("seed", [0, 1])
def test_round_trip_exact(host_codec, seed):
    x = _images(seed=seed)
    out = host_codec.compress(x)
    rec = host_codec.decompress(out["strings"], out["shape"])
    torch.testing.assert_close(rec["y_hat"], out["y_hat"], rtol=0, atol=0)
    assert out["shape"] == (1, 1) and len(out["strings"][0]) == 2
    assert tuple(rec["x_hat"].shape) == x.shape
    assert 0 <= float(rec["x_hat"].min()) <= float(rec["x_hat"].max()) <= 1
    assert 0 < out["bpp_real"] < 64


def test_retrained_weights_decode_in_fresh_codec(models):
    """A codec whose model's AR weights change after it was built codes
    with the new weights: a fresh codec over the same model decodes its
    strings exactly."""
    model = copy.deepcopy(models[1])
    cdc = JointAutoregressiveCodec(model).update()
    x = _images(seed=5)
    before = cdc.compress(x)["strings"][0]
    with torch.no_grad():
        model.context_prediction.weight.mul_(1.5)
        model.entropy_parameters_0.bias.add_(0.25)
    cdc.update(force=True)
    out = cdc.compress(x)
    assert out["strings"][0] != before
    rec = JointAutoregressiveCodec(model).update().decompress(
        out["strings"], out["shape"])
    torch.testing.assert_close(rec["y_hat"], out["y_hat"], rtol=0, atol=0)


def test_numpy_reference_decoder_equals_native(host_codec):
    out = host_codec.compress(_images(seed=2))
    pre = _pre(host_codec, out)
    native = ar_decompress(host_codec, out["strings"][0], pre)
    ref = ar_decompress_reference(host_codec, out["strings"][0], pre)
    np.testing.assert_allclose(_nhwc(native), out["y_hat"].numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(ref.numpy(), native.numpy(), rtol=0,
                               atol=1e-5)


def test_torch_scan_matches_native(host_codec, models):
    x = _images(seed=3)
    out = host_codec.compress(x)
    pre = _pre(host_codec, out)
    with torch.no_grad():
        y = models[1].analysis(torch.from_numpy(x).permute(0, 3, 1, 2))
    _, idx, y_hat = ar_encode_scan(extract_ar_weights(models[1]), y, pre,
                                   None, host_codec.scale_table)
    np.testing.assert_allclose(_nhwc(y_hat), out["y_hat"].numpy(), rtol=0,
                               atol=1e-4)
    assert idx.dtype == torch.int32 and int(idx.min()) >= 0
    # the native encode of the same y and pre gives the same strings
    strs, _ = ar_compress(host_codec, y, pre)
    assert strs == out["strings"][0]


def _jax_flow(base, x):
    """The JAX codec's compress, step by step: (z, z_strings, y_hat)."""
    y = base.jit("analysis")(jnp.asarray(x))
    z = base.jit("hyper_analysis")(y)
    z_strings = base.eb_compress("entropy_bottleneck", z)
    z_hat = base.eb_decompress("entropy_bottleneck", z_strings,
                               z.shape[1:3])
    params = base.jit("hyper_synthesis")(z_hat)
    y_strings, y_hat = j_ar_compress(base, y, params)
    return np.asarray(z), z_strings, y_strings, np.asarray(y_hat)


def test_z_strings_byte_identical_to_jax(models, host_codec):
    base, _ = models
    z, j_strs, _, _ = _jax_flow(base, _images(seed=4))
    cdc = JointAutoregressiveCodec(models[1]).update()
    cdc.tables["entropy_bottleneck"] = base.tables["entropy_bottleneck"]
    t_strs = cdc.eb_compress("entropy_bottleneck",
                             torch.from_numpy(z.copy()).permute(0, 3, 1, 2))
    assert t_strs == j_strs
    z_hat = cdc.eb_decompress("entropy_bottleneck", j_strs, z.shape[1:3])
    np.testing.assert_array_equal(
        _nhwc(z_hat), np.asarray(base.eb_decompress(
            "entropy_bottleneck", j_strs, z.shape[1:3])))


@pytest.mark.parametrize("seed", [5, 6])
def test_matches_jax_codec(models, host_codec, seed):
    base, model = models
    x = _images(seed=seed)
    _, z_strs, y_strs, j_yhat = _jax_flow(base, x)
    out = host_codec.compress(x)
    j_bpp = sum(len(s) for s in z_strs + y_strs) * 8 / (2 * 64 * 64)
    assert abs(out["bpp_real"] / j_bpp - 1) < 0.01
    with torch.no_grad():
        raw = _nhwc(model.analysis(torch.from_numpy(x).permute(0, 3, 1, 2)))
    ty = out["y_hat"].numpy()
    # off the rounding margin: y - y_hat is the residual's rounding error
    keep = ~(np.abs(np.abs(raw - ty) - 0.5) < 1e-4)
    assert keep.mean() > 0.95
    np.testing.assert_allclose(ty[keep], j_yhat[keep], atol=1e-4, rtol=0)


def test_gc_strings_byte_identical_to_jax(models):
    base, model = models
    cdc = JointAutoregressiveCodec(model).update()
    cdc.tables["gaussian_conditional"] = base.tables["gaussian_conditional"]
    rng = np.random.RandomState(7)
    y = (rng.randn(2, 4, 4, 24) * 4).astype(np.float32)
    means = rng.randn(2, 4, 4, 24).astype(np.float32)
    scales = np.exp(rng.uniform(-2, 4, y.shape)).astype(np.float32)
    idx = j_build_indexes(jnp.asarray(scales), base.scale_table)
    j_strs = base.gc_compress("gaussian_conditional", y, idx, means=means)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a).transpose(0, 3, 1, 2)))

    t_idx = build_indexes(nchw(scales), cdc.scale_table)
    assert cdc.gc_compress("gaussian_conditional", nchw(y), t_idx,
                           nchw(means)) == j_strs
    got = cdc.gc_decompress("gaussian_conditional", j_strs, t_idx,
                            nchw(means))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(base.gc_decompress(
        "gaussian_conditional", j_strs, idx, means=means)))


def test_bench_mbt_point_on_cpu(models):
    args = bench.parse_args(["--model", "mbt", "--device", "cpu", "--size",
                             "64", "--batch", "2", "--batches", "2"])
    assert (args.calib_steps, args.pipeline, args.bf16) == (0, 0, 0)
    res = bench.bench(models[1], args)
    assert res["seconds"] > 0 and 0 < res["bpp_real"] < 64
    assert res["coder_s"] > 0
    assert bench.POINTS["mbt"][:4] == ("mbt2018", "images", 8, 2)
