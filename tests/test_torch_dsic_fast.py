"""Port: DSICFastCodec (hesic_tpu_torch/models/dsic_fast.py) on the CPU,
where every kernel runs as its plain twin, at the JAX tests' tiny config
(DSIC N=16, M=24, F=6, C=4, K=2, 64x64), the JAX codec's weights carried
over by hesic_from_jax and loaded strictly.

* Round trips are bit-exact: per-pair and batch containers, for a plain
  case and one forced into escapes; each pair's container decoded alone,
  and the list reversed, give the whole list's latents; the pipelined
  start/finish container equals the synchronous one byte for byte; the
  grid encoder launches once per eye.
* Against the JAX package's DSICFastCodec at the same weights and inputs:
  the header after the writer byte is equal (per-pair bytes 1-8, batch
  bytes 1-20); decoded latents are equal off the rounding margin (2e-4
  for y1, 2e-3 for y2, whose encoder runs the cost volumes); bpp_real is
  within 2%; with the JAX tables injected the z strings are
  byte-identical; a JAX container is refused, naming both writers.
* The bench loop (``hesic_tpu_torch.bench --model dsic``) runs exact with
  2 calibration steps and 2 batches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.models import DSIC as JDSIC
from hesic_tpu.models import DSICFastCodec as JCodec
from hesic_tpu_torch import bench
from hesic_tpu_torch.entropy_models import CdfTables
from hesic_tpu_torch.models import hesic_fast
from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.dsic_fast import DSICFastCodec
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

CFG = dict(N=16, M=24, F=6, C=4, K=2)
SHAPES = [(1, 64, 64, 3), (1, 64, 64, 3)]


@pytest.fixture(scope="module")
def codecs():
    jc = JCodec.init(JDSIC(**CFG), SHAPES, seed=0)
    jc.update()
    params = jax.tree_util.tree_map(np.asarray, jc.params)
    model = DSIC(**CFG, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model), strict=True)
    return jc, model


def _codec(model, **kw):
    return DSICFastCodec(model, codec_batch=2, **kw).update()


def _pair(b=2, seed=0, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    x1 = (rng.rand(b, 64, 64, 3) * scale - shift).astype(np.float32)
    x2 = (rng.rand(b, 64, 64, 3) * scale - shift).astype(np.float32)
    return x1, x2


def _enc_latents(codec, x1, x2):
    hd, _ = codec._homographies(None, len(x1))
    enc = codec.transforms_enc(codec._to_device(x1), codec._to_device(x2),
                               hd, 64)
    return [e.permute(0, 2, 3, 1).float().numpy() for e in enc[:2]]


def _assert_exact(codec, rec, x1, x2):
    y1, y2 = _enc_latents(codec, x1, x2)
    np.testing.assert_array_equal(rec["y1_hat"].numpy(), y1)
    np.testing.assert_array_equal(rec["y2_hat"].numpy(), y2)
    for key in ("x1_hat", "x2_hat"):
        assert tuple(rec[key].shape) == x1.shape
        assert torch.isfinite(rec[key]).all()


CASES = {"plain b2": (2, 32, 1.0, 0.0), "escapes b3": (3, 1, 4.0, 1.5)}


@pytest.mark.parametrize("batch_container", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_roundtrip_bit_exact(codecs, case, batch_container):
    _, model = codecs
    b, mm, scale, shift = CASES[case]
    codec = _codec(model, mm=mm)
    x1, x2 = _pair(b, seed=1, scale=scale, shift=shift)
    out = codec.compress_fast(x1, x2, batch_container=batch_container)
    assert out["blob"][0] == hesic_fast.writer_id("cpu")
    assert 0 < out["bpp_real"] < 40
    if case.startswith("escapes"):
        assert min(out["outliers"]) > 0, "case must produce escapes"
    rec = (codec.decompress_fast_batch(out["blob"]) if batch_container
           else codec.decompress_fast(out["blobs"]))
    _assert_exact(codec, rec, x1, x2)


def test_each_blob_alone_and_reversed(codecs):
    _, model = codecs
    codec = _codec(model)
    x1, x2 = _pair(3, seed=6)
    blobs = codec.compress_fast(x1, x2)["blobs"]
    whole = codec.decompress_fast(blobs)
    _assert_exact(codec, whole, x1, x2)
    rev = codec.decompress_fast(blobs[::-1])
    for key in ("y1_hat", "y2_hat"):
        np.testing.assert_array_equal(rev[key].numpy()[::-1],
                                      whole[key].numpy())
    for i, blob in enumerate(blobs):
        alone = codec.decompress_fast(blob)
        for key in ("y1_hat", "y2_hat"):
            np.testing.assert_array_equal(alone[key].numpy()[0],
                                          whole[key].numpy()[i])


def test_pipelined_container_equals_sync(codecs):
    _, model = codecs
    codec = _codec(model)
    batches = [_pair(2, seed=s) for s in (10, 11)]
    first = codec.compress_fast_start(*batches[0])
    assert first["mode"] == "sync"
    second = codec.compress_fast_start(*batches[1])
    assert second["mode"] == "async"
    outs = [codec.compress_fast_finish(h) for h in (first, second)]
    for out, bt in zip(outs, batches):
        ref = codec.compress_fast(*bt, batch_container=True)
        assert out["blob"] == ref["blob"]
        _assert_exact(codec, codec.decompress_fast_batch(out["blob"]), *bt)


def test_grid_encoder_launches_once_per_eye(codecs, monkeypatch):
    _, model = codecs
    calls = []
    encode = hesic_fast.rans_encode_grid_rows

    def counted(*args, **kwargs):
        calls.append(kwargs["cap"])
        return encode(*args, **kwargs)

    monkeypatch.setattr(hesic_fast, "rans_encode_grid_rows", counted)
    codec = _codec(model)
    x1, x2 = _pair(2, seed=7)
    out = codec.compress_fast(x1, x2, batch_container=True)
    assert len(calls) == 2
    _assert_exact(codec, codec.decompress_fast_batch(out["blob"]), x1, x2)


def _margin(y, eps):
    """Cells whose unrounded value lies within eps of a .5 boundary."""
    return np.abs(y - np.floor(y) - 0.5) < eps


@pytest.mark.parametrize("batch_container", [False, True])
def test_matches_jax_codec(codecs, batch_container):
    jc, model = codecs
    codec = _codec(model)
    x1, x2 = _pair(2, seed=4)
    j_out = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                             batch_container=batch_container)
    t_out = codec.compress_fast(x1, x2, batch_container=batch_container)
    head = 21 if batch_container else 9
    assert t_out["blob"][1:head] == j_out["blob"][1:head]
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.02
    if batch_container:
        j_rec = jc.decompress_fast_batch(j_out["blob"])
        t_rec = codec.decompress_fast_batch(t_out["blob"])
    else:
        j_rec = jc.decompress_fast(j_out["blobs"])
        t_rec = codec.decompress_fast(t_out["blobs"])
    # unrounded latents for the margin audit, from the port's transforms
    with torch.no_grad():
        y1, *taps = model.analysis1(codec._to_device(x1))
        ctx = model.contexts(torch.round(y1))
        y2 = model.analysis2(codec._to_device(x2), *taps, ctx)
    for key, raw, eps in (("y1_hat", y1, 2e-4), ("y2_hat", y2, 2e-3)):
        raw = raw.permute(0, 2, 3, 1).numpy()
        jy, ty = np.asarray(j_rec[key]), t_rec[key].numpy()
        keep = ~_margin(raw, eps)
        assert keep.mean() > 0.95
        np.testing.assert_array_equal(ty[keep], jy[keep])


def test_z_strings_equal_with_jax_tables(codecs):
    jc, model = codecs
    twin = _codec(model)
    twin.tables = {k: CdfTables(v.quantized_cdf, v.cdf_length, v.offset)
                   for k, v in jc.tables.items()}
    x1, x2 = _pair(1, seed=5)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2))["blob"]
    t_blob = twin.compress_fast(x1, x2)["blob"]
    off = 9
    for _ in range(2):
        n = int(np.frombuffer(j_blob, np.uint32, 1, off)[0])
        assert t_blob[off:off + 4 + n] == j_blob[off:off + 4 + n]
        off += 4 + n


def test_jax_container_raises_naming_both_writers(codecs):
    jc, model = codecs
    x1, x2 = _pair(1, seed=8)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2))["blob"]
    assert j_blob[0] == 3
    with pytest.raises(ValueError) as err:
        _codec(model).decompress_fast(j_blob)
    assert "the JAX package's format v3" in str(err.value)
    assert "torch-plain-fast-v3" in str(err.value)


@pytest.mark.parametrize("pipeline", [2, 0])
def test_bench_dsic_runs_exact_on_cpu(codecs, pipeline):
    _, model = codecs
    tiny = DSIC(**CFG, device="cpu", seed=1)
    tiny.load_state_dict(model.state_dict())
    args = bench.parse_args(["--model", "dsic", "--size", "64", "--batch",
                             "2", "--batches", "2", "--calib-steps", "2",
                             "--device", "cpu", "--pipeline",
                             str(pipeline)])
    assert args.mm == 16 and args.bf16 == 1
    res = bench.bench(tiny, args, calib_hw=64)
    assert res["pairs_per_sec"] > 0 and res["bpp_real"] > 0
    assert len(res["mm"]) == 2
