"""Port: the fast codecs' own tracing (hesic_tpu_torch/utils/tracing.py;
the spans and counters of models/hesic_fast.py, models/base.py and
models/dsic.py) on the CPU, at tiny widths with random weights (HESIC
N16/M24/K2, DSIC N16/M24/F6/C4/K2), batches of 2 pairs of 64x64 images
whose latents pass the grid cap mm 4, so that the escape paths run.

* A round trip of each codec (per-pair containers, the pipelined start
  and finish, the batch container) under torch.profiler enters every
  span the codec names, and DSIC's model spans.
* Every counter sample parses, and each equals what the shapes, the
  containers and the encoder's outputs give: ``h2d_bytes`` the uploaded
  arrays' bytes, ``d2h_bytes`` the fetched tensors' and words', ``latents``
  2 B M hy wy, ``escapes`` the encoder's outlier counts; ``count/batch``
  carries each encode's and decode's sequence number; there is no
  ``device_allocs`` sample off the card.
* The containers are byte-identical with and without a profiler.
* With no profiler, no span or counter enters ``record_function``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.dsic_fast import DSICFastCodec
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
from hesic_tpu_torch.utils import tracing

torch.set_num_threads(2)

B, M, SIZE, MM = 2, 24, 64, 4
CALLS = ("codec/compress_fast", "codec/compress_fast_start",
         "codec/compress_fast_finish", "codec/decompress_fast",
         "codec/decompress_fast_batch")
ENC = ("enc/transforms", "enc/wait-spreads", "enc/cond1", "enc/cond2",
       "enc/rans", "enc/compact", "enc/fetch", "enc/wait-copies",
       "enc/words-d2h", "enc/wait-words", "enc/outliers",
       "enc/wait-outliers", "enc/z-rans", "enc/container")
DEC = ("dec/parse", "dec/outliers-parse", "dec/z-rans", "dec/stage",
       "dec/upload", "dec/expand-words", "dec/corr-map", "dec/cond1",
       "dec/rans", "dec/cond2", "dec/synthesis", "dec/wait")
DSIC_SPANS = ("dsic/3-D branch", "dsic/GroupNorm", "dsic/dense_warp",
              "dsic/upsampling")
ARCHS = ("hesic", "dsic")


@pytest.fixture(scope="module")
def models():
    return {"hesic": HESIC(N=16, M=M, K=2, device="cpu", seed=0),
            "dsic": DSIC(N=16, M=M, F=6, C=4, K=2, device="cpu", seed=0)}


def _codec(models, arch):
    cls = HESICFastCodec if arch == "hesic" else DSICFastCodec
    return cls(models[arch], mm=MM, codec_batch=B).update()


def _inputs(arch):
    rng = np.random.RandomState(1)
    x1, x2 = ((rng.rand(B, SIZE, SIZE, 3) * 4 - 1.5).astype(np.float32)
              for _ in range(2))
    h = (np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))
         if arch == "hesic" else None)
    return x1, x2, h


def _trip(codec, x1, x2, h):
    """Per-pair encode and decode, two pipelined encodes in flight, the
    batch decode of the first: {"blobs", "batch_blob", "outliers"}."""
    out = codec.compress_fast(x1, x2, h)
    codec.decompress_fast(out["blobs"])
    first = codec.compress_fast_start(x1, x2, h)
    second = codec.compress_fast_start(x1, x2, h)
    fin = codec.compress_fast_finish(first)
    codec.compress_fast_finish(second)
    codec.decompress_fast_batch(fin["blob"])
    return {"blobs": out["blobs"], "batch_blob": fin["blob"],
            "outliers": out["outliers"], "batch_outliers": fin["outliers"]}


def _traced_trip(codec, x1, x2, h):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _trip(codec, x1, x2, h)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.is_user_annotation),
                   key=lambda s: s[1])
    return out, spans


def _calls(spans):
    """Each codec/... span in order: (name, {counter: [values]})."""
    out = []
    for name, lo, hi in spans:
        if not name.startswith("codec/"):
            continue
        counts = {}
        for n, a, _ in spans:
            if n.startswith("count/") and lo <= a <= hi:
                key, _, value = n[len("count/"):].partition("=")
                counts.setdefault(key, []).append(int(value))
        out.append((name, counts))
    return out


@pytest.fixture(scope="module")
def traced(models):
    runs = {}
    for arch in ARCHS:
        x1, x2, h = _inputs(arch)
        runs[arch] = _traced_trip(_codec(models, arch), x1, x2, h)
    return runs


@pytest.mark.parametrize("arch", ARCHS)
def test_every_span_is_entered(traced, arch):
    names = {n for n, _, _ in traced[arch][1]}
    want = set(CALLS + ENC + DEC) | (set(DSIC_SPANS) if arch == "dsic"
                                     else set())
    assert want <= names, sorted(want - names)
    assert not any(n.startswith("dsic/") for n in names) or arch == "dsic"


@pytest.mark.parametrize("arch", ARCHS)
def test_every_counter_parses(traced, arch):
    known = {"batch", "h2d_bytes", "d2h_bytes", "latents", "escapes"}
    for name, _, _ in traced[arch][1]:
        if name.startswith("count/"):
            key, eq, value = name[len("count/"):].partition("=")
            assert key in known and eq == "=" and int(value) >= 0, name


def _layout(codec, blobs):
    """(lanes, words a pair's eye holds in all, outliers of each eye) from
    the per-pair containers of a batch."""
    parsed = [codec._parse_pair(blob) for blob in blobs]
    lanes = parsed[0]["streams"][0][1].shape[0]
    words = [sum(p["streams"][e][0].size for p in parsed) for e in range(2)]
    outliers = [sum(p["outliers"][e][0].size for p in parsed)
                for e in range(2)]
    return lanes, words, outliers


@pytest.mark.parametrize("arch", ARCHS)
def test_counters_match_shapes_and_outputs(traced, models, arch):
    codec = _codec(models, arch)
    out, spans = traced[arch]
    x1, x2, h = _inputs(arch)
    lanes, words, outliers = _layout(codec, out["blobs"])
    hy = SIZE // 16
    zc = codec.eb_medians("entropy_bottleneck1").size
    z_ints = 2 * B * zc * (SIZE // 64) ** 2
    # the encoder's uploads: both images and the homographies (DSIC's
    # identity included)
    enc_h2d = [x1.nbytes, x2.nbytes, B * 9 * 4]
    # _fetch: counts, states, centres, spreads, out-of-grid counts, dead
    # bitmaps as int64, the z symbols as int32; then each eye's words
    meta = 4 * B * lanes + 2 * B * M + 2 + 2 * B + 2 * B * M
    enc_d2h = [8 * meta + 4 * z_ints, 2 * sum(words)]
    # the decoder's packed upload (int32 counts, states, z, centres,
    # bitmaps, H and the words two to an int), then the outlier records
    # (int64 index and value) of each eye that has any
    dec_h2d = [4 * (4 * B * lanes + z_ints + 4 * B * M + 9 * B
                    + sum(-(-w // 2) for w in words))]
    dec_h2d += [16 * n for n in outliers if n]
    assert sum(outliers) == sum(out["outliers"]) > 0
    encode = {"latents": [2 * B * M * hy * hy],
              "escapes": [sum(out["outliers"])]}
    want = [("codec/compress_fast", dict(encode, batch=[0], h2d_bytes=enc_h2d,
                                         d2h_bytes=enc_d2h)),
            ("codec/decompress_fast", {"batch": [0], "h2d_bytes": dec_h2d}),
            ("codec/compress_fast_start", {"batch": [1],
                                           "h2d_bytes": enc_h2d,
                                           "d2h_bytes": enc_d2h[:1]}),
            ("codec/compress_fast_start", {"batch": [2],
                                           "h2d_bytes": enc_h2d,
                                           "d2h_bytes": enc_d2h[:1]}),
            ("codec/compress_fast_finish", dict(encode, batch=[1],
                                                d2h_bytes=enc_d2h[1:])),
            ("codec/compress_fast_finish", dict(encode, batch=[2],
                                                d2h_bytes=enc_d2h[1:])),
            ("codec/decompress_fast_batch", {"batch": [1],
                                             "h2d_bytes": dec_h2d})]
    assert out["batch_outliers"] == out["outliers"]
    assert _calls(spans) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_containers_equal_with_and_without_profiler(traced, models, arch):
    out = _trip(_codec(models, arch), *_inputs(arch))
    assert out["blobs"] == traced[arch][0]["blobs"]
    assert out["batch_blob"] == traced[arch][0]["batch_blob"]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_profiler_no_record_function(models, arch, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.recording()
    _trip(_codec(models, arch), *_inputs(arch))
    with tracing.span("enc/z-rans"):
        tracing.count("escapes", 3)
    with tracing.call("codec/compress_fast", 0, "cpu"):
        pass


def test_helpers_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.recording()
        with tracing.call("codec/decompress_fast", 5, "cpu"):
            with tracing.span("dec/z-rans"):
                tracing.count("escapes", np.int64(7))
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.is_user_annotation]
    assert names == ["codec/decompress_fast", "count/batch=5", "dec/z-rans",
                     "count/escapes=7"]
    assert not tracing.recording()
    assert tracing.allocator_calls("cpu") is None
