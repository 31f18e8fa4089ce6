"""Port: the fast codec's batch container, pipelined encode and batch
decode (hesic_tpu_torch/models/hesic_fast.py), and the bench loop
(hesic_tpu_torch/bench.py), on the CPU, where every kernel runs as its
plain twin, at the tiny config of test_torch_hesic_fast.py (N=16, M=24,
K=2, 64x64, the JAX codec's weights carried over by hesic_from_jax).

* Round trip: decompress_fast_batch gives the encoder's own quantized
  latents for the identity H, a rotated H and a case forced into
  outliers, at b=2 and b=3 (codec_batch 2, so b=3 ends in a padded
  chunk).
* Against the JAX codec's compress_fast(batch_container=True): bytes
  1-20 (mm1, mm2, win, xwin/16, u32 H, W, b, lanes) are equal; bpp_real
  is within 2%; decoded latents are equal off the rounding margin (2e-4
  for y1, 2e-3 for y2), as test_torch_hesic_fast holds the per-pair
  path; with the JAX tables injected the z strings are byte-identical.
* The batch container's pieces (z strings, outlier records, bitmaps,
  centres, H, counts, states, words) equal the per-pair containers' of
  the same batch.
* Pipelined (JAX's TestPipelinedEncode): the first start is "sync", the
  later ones "async"; with two handles in flight each container equals
  its batch's synchronous batch container and decodes exactly.  A wide
  batch started after a narrow one carries the narrow grids and their
  escapes, decodes exactly, and the next batch takes the wide grids.
* The device-side word rebuild equals the per-pair decoder's host one;
  the words compacted and rebuilt, cap-major (HESIC) and lane-major
  (HESIC+), round-trip.
* Each decoder refuses the other's container.
* The bench loop runs end to end with 2 calibration steps and 2 batches.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.geometry.fast_warp import pick_warp_win as j_pick_win
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models import HESICFastCodec as JCodec
from hesic_tpu_torch import bench
from hesic_tpu_torch.codecs.device_rans import unpack_counts, unpack_stream
from hesic_tpu_torch.entropy_models import CdfTables
from hesic_tpu_torch.geometry import warp_perspective
from hesic_tpu_torch.models import hesic_fast
from hesic_tpu_torch.models.ar_device import _compact_lanes
from hesic_tpu_torch.models.base import expand_lanes, read_escape_record
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_fast import (HESICFastCodec, compact_words,
                                               expand_words, pick_mm)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

SHAPES = [(1, 64, 64, 3), (1, 64, 64, 3), (1, 3, 3)]
M = 24


@pytest.fixture(scope="module")
def codecs():
    jc = JCodec.init(JHESIC(N=16, M=M, K=2), SHAPES, seed=0)
    jc.update()
    params = jax.tree_util.tree_map(np.asarray, jc.params)
    model = HESIC(N=16, M=M, K=2, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return jc, model


def _codec(model, **kw):
    return HESICFastCodec(model, codec_batch=2, **kw).update()


def _pair(b=2, seed=0, deg=0.0, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    x1 = (rng.rand(b, 64, 64, 3) * scale - shift).astype(np.float32)
    x2 = (rng.rand(b, 64, 64, 3) * scale - shift).astype(np.float32)
    th = np.deg2rad(deg)
    h = np.array([[np.cos(th), -np.sin(th), 3.0 if deg else 0.0],
                  [np.sin(th), np.cos(th), -2.0 if deg else 0.0],
                  [0, 0, 1]], np.float32)
    return x1, x2, np.tile(h[None], (b, 1, 1))


def _enc_latents(codec, x1, x2, h, win):
    hd, _ = codec._homographies(h, len(x1))
    enc = codec.transforms_enc(codec._to_device(x1), codec._to_device(x2),
                               hd, win)
    return [e.permute(0, 2, 3, 1).float().numpy() for e in enc[:2]]


def _assert_exact(codec, blob, x1, x2, h):
    rec = codec.decompress_fast_batch(blob)
    y1, y2 = _enc_latents(codec, x1, x2, h, blob[3])
    np.testing.assert_array_equal(rec["y1_hat"].numpy(), y1)
    np.testing.assert_array_equal(rec["y2_hat"].numpy(), y2)
    for key in ("x1_hat", "x2_hat"):
        assert tuple(rec[key].shape) == x1.shape
        assert torch.isfinite(rec[key]).all()
    return rec


def _parse_batch(blob, m=M):
    """An independent reading of the batch layout (the JAX package's
    _containers): {"z": per pair (z1, z2) bytes, "outliers", "dead",
    "centres", "h", "streams": per eye (counts, states, words)}."""
    off = 1
    h_img, w_img, b, lanes = (int(v) for v in
                              np.frombuffer(blob, np.uint32, 4, off + 4))
    off += 20
    z = []
    for _ in range(b):
        pair = []
        for _ in range(2):
            n = int(np.frombuffer(blob, np.uint32, 1, off)[0])
            pair.append(blob[off + 4:off + 4 + n])
            off += 4 + n
        z.append(tuple(pair))
    outliers = []
    for _ in range(b):
        i1, v1, off = read_escape_record(blob, off)
        i2, v2, off = read_escape_record(blob, off)
        outliers.append(((i1, v1), (i2, v2)))
    nbytes = -(-m // 8)
    dead = np.frombuffer(blob, np.uint8, 2 * b * nbytes, off).reshape(
        b, 2, nbytes)
    off += 2 * b * nbytes
    centres = np.frombuffer(blob, np.int8, 2 * b * m, off).reshape(2, b, m)
    off += 2 * b * m
    h = np.frombuffer(blob, np.float32, 9 * b, off).reshape(b, 3, 3)
    off += 36 * b
    streams = []
    for _ in range(2):
        c, off = unpack_counts(blob, off, b * lanes)
        st = np.frombuffer(blob, np.uint32, b * lanes, off)
        off += 4 * b * lanes
        w = np.frombuffer(blob, np.uint16, int(c.sum()), off)
        off += 2 * int(c.sum())
        streams.append((c.reshape(b, lanes), st.reshape(b, lanes), w))
    assert off == len(blob)
    return {"z": z, "outliers": outliers, "dead": dead, "centres": centres,
            "h": h, "streams": streams, "hw": (h_img, w_img)}


CASES = {"identity b2": (2, 0.0, 1.0, 0.0), "rotated b3": (3, 6.0, 1.0, 0.0),
         "outliers b3": (3, 0.0, 50.0, 25.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_roundtrip_bit_exact(codecs, case):
    _, model = codecs
    b, deg, scale, shift = CASES[case]
    codec = _codec(model, mm=2 if case.startswith("outliers") else 32)
    x1, x2, h = _pair(b, seed=1, deg=deg, scale=scale, shift=shift)
    out = codec.compress_fast(x1, x2, h, batch_container=True)
    assert len(out["blobs"]) == 1 and 0 < out["bpp_real"] < 40
    assert out["blob"][0] == hesic_fast.writer_id("cpu")
    assert out["blob"][3] == j_pick_win(h, 64, 64)
    if case.startswith("outliers"):
        assert min(out["outliers"]) > 0, "case must produce outliers"
    _assert_exact(codec, out["blob"], x1, x2, h)


@pytest.mark.parametrize("deg", [0.0, 6.0])
def test_batch_header_matches_jax(codecs, deg):
    jc, model = codecs
    x1, x2, h = _pair(2, seed=4, deg=deg)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(h), batch_container=True)["blob"]
    t_blob = _codec(model).compress_fast(x1, x2, h,
                                         batch_container=True)["blob"]
    assert t_blob[1:21] == j_blob[1:21]


def _margin(y, eps):
    """Cells whose unrounded value lies within eps of a .5 boundary."""
    return np.abs(y - np.floor(y) - 0.5) < eps


@pytest.mark.parametrize("deg", [0.0, 6.0])
def test_batch_matches_jax_codec(codecs, deg):
    jc, model = codecs
    codec = _codec(model)
    x1, x2, h = _pair(2, seed=4, deg=deg)
    j_out = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                             jnp.asarray(h), batch_container=True)
    t_out = codec.compress_fast(x1, x2, h, batch_container=True)
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.02
    j_rec = jc.decompress_fast_batch(j_out["blob"])
    t_rec = codec.decompress_fast_batch(t_out["blob"])
    y1_raw = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray(x1), method="analysis1"))
    hd, _ = codec._homographies(h, 2)
    warped, _ = warp_perspective(codec._to_device(x1), hd, t_out["blob"][3])
    y2_raw = codec.model.analysis2(warped, codec._to_device(x2))
    y2_raw = y2_raw.permute(0, 2, 3, 1).numpy()
    for key, raw, eps in (("y1_hat", y1_raw, 2e-4),
                          ("y2_hat", y2_raw, 2e-3)):
        jy, ty = np.asarray(j_rec[key]), t_rec[key].numpy()
        keep = ~_margin(raw, eps)
        assert keep.mean() > 0.95
        np.testing.assert_array_equal(ty[keep], jy[keep])


def test_batch_z_strings_equal_with_jax_tables(codecs):
    jc, model = codecs
    twin = _codec(model)
    twin.tables = {k: CdfTables(v.quantized_cdf, v.cdf_length, v.offset)
                   for k, v in jc.tables.items()}
    x1, x2, h = _pair(3, seed=5)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(h), batch_container=True)["blob"]
    t_blob = twin.compress_fast(x1, x2, h, batch_container=True)["blob"]
    assert _parse_batch(t_blob)["z"] == _parse_batch(j_blob)["z"]


def test_batch_pieces_equal_per_pair_containers(codecs):
    _, model = codecs
    codec = _codec(model, mm=2)
    x1, x2, h = _pair(3, seed=2, deg=6.0, scale=50.0, shift=25.0)
    batch = _parse_batch(codec.compress_fast(x1, x2, h,
                                             batch_container=True)["blob"])
    pairs = codec.compress_fast(x1, x2, h)["blobs"]
    assert sum(o[0][0].size + o[1][0].size for o in batch["outliers"]) > 0
    for i, blob in enumerate(pairs):
        p = codec._parse_pair(blob)
        assert p["key"][4:] == batch["hw"]
        assert batch["z"][i] == tuple(blob[a:b] for a, b in p["ext"])
        for e in range(2):
            for got, want in zip(p["outliers"][e], batch["outliers"][i][e]):
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                p["dead"][e], np.unpackbits(batch["dead"][i, e])[:M] != 0)
            words, counts, states = p["streams"][e]
            bc, bst, bw = batch["streams"][e]
            np.testing.assert_array_equal(counts, bc[i])
            np.testing.assert_array_equal(states, bst[i])
            lo = int(bc[:i].sum())
            np.testing.assert_array_equal(words,
                                          bw[lo:lo + int(bc[i].sum())])
        np.testing.assert_array_equal(p["centres"], batch["centres"][:, i])
        np.testing.assert_array_equal(p["h"], batch["h"][i])


def test_pipelined_containers_equal_sync_and_decode(codecs):
    _, model = codecs
    codec = _codec(model)
    batches = [_pair(2, seed=s) for s in (10, 11, 12)]
    first = codec.compress_fast_start(*batches[0])
    assert first["mode"] == "sync"
    # two handles in flight: start(i + 1) before finish(i)
    handles = [first, codec.compress_fast_start(*batches[1])]
    assert handles[1]["mode"] == "async"
    outs = [codec.compress_fast_finish(handles[0])]
    handles.append(codec.compress_fast_start(*batches[2]))
    assert handles[2]["mode"] == "async"
    outs += [codec.compress_fast_finish(hd) for hd in handles[1:]]
    assert all(o.get("fallback", False) is False for o in outs)
    for out, bt in zip(outs, batches):
        ref = codec.compress_fast(*bt, batch_container=True)
        assert ref["blob"][1:3] == out["blob"][1:3], "grids must agree"
        assert out["blob"] == ref["blob"]
        _assert_exact(codec, out["blob"], *bt)


def test_wide_batch_after_narrow_carries_narrow_grids(codecs):
    _, model = codecs
    codec = _codec(model)
    narrow = _pair(2, seed=20, scale=0.05)
    wide = _pair(2, seed=21, scale=50.0, shift=25.0)
    seed_out = codec.compress_fast_finish(codec.compress_fast_start(*narrow))
    narrow_mm = tuple(seed_out["blob"][1:3])
    wide_ref = codec.compress_fast(*wide, batch_container=True)
    wide_mm = tuple(wide_ref["blob"][1:3])
    assert wide_mm != narrow_mm and max(wide_mm) > max(narrow_mm)
    codec.compress_fast(*narrow, batch_container=True)   # grids -> narrow
    out = codec.compress_fast_finish(codec.compress_fast_start(*wide))
    assert tuple(out["blob"][1:3]) == narrow_mm
    assert sum(out["outliers"]) > 0
    _assert_exact(codec, out["blob"], *wide)
    assert codec._next_mm == wide_mm
    nxt = codec.compress_fast_finish(codec.compress_fast_start(*narrow))
    assert tuple(nxt["blob"][1:3]) == wide_mm
    _assert_exact(codec, nxt["blob"], *narrow)


@pytest.mark.parametrize("layout", ["cap-major", "lane-major"])
def test_compact_expand_words_round_trip(layout):
    """HESIC's cap-major (B, CAP, ls) words through compact_words and
    expand_words, and HESIC+'s lane-major (L, cap) ones through
    _compact_lanes and the shared rebuild (base.expand_lanes): the
    exact-dense words in the container's order, and back."""
    rng = np.random.RandomState(3)
    b, cap, ls = 3, 7, 5
    words = torch.from_numpy(rng.randint(0, 1 << 16, (b, cap, ls)).astype(
        np.int32))
    counts = torch.from_numpy(rng.randint(0, cap + 1, (b, ls)).astype(
        np.int32))
    counts[1, 2] = 0
    total = int(counts.sum())
    if layout == "lane-major":      # the same lanes as one (b ls, cap)
        words = words.permute(0, 2, 1).reshape(b * ls, cap)
        counts = counts.reshape(-1)
        flat = _compact_lanes(words, counts, total)
        keep = np.arange(cap)[None, :] < counts.numpy()[:, None]
        want = np.where(keep, words.numpy(), 0)
        dense = want[keep]
        back = expand_lanes(flat.to(torch.int32) & 0xFFFF, counts, cap)
    else:
        flat = compact_words(words, counts)[:total]
        keep = np.arange(cap)[None, :, None] < counts.numpy()[:, None, :]
        want = np.where(keep, words.numpy(), 0)
        # exact-dense (pair, lane, slot) order
        dense = want.transpose(0, 2, 1)[keep.transpose(0, 2, 1)]
        back = expand_words(flat.to(torch.int32) & 0xFFFF, counts, cap)
    np.testing.assert_array_equal(flat.numpy().view(np.uint16), dense)
    np.testing.assert_array_equal(back.numpy(), want)


def _host_rebuild(blobs, m=M):
    """The cap-major (B, CAP, ls) word buffer rebuilt on the host from the
    per-pair containers' padded words (unpack_stream), CAP the longest
    lane's count."""
    eyes = ([], [])
    for blob in blobs:
        off = 1 + 8
        for _ in range(2):
            off += 4 + int(np.frombuffer(blob, np.uint32, 1, off)[0])
        for _ in range(2):
            off += 4 + 8 * int(np.frombuffer(blob, np.uint32, 1, off)[0])
        off += 2 * -(-m // 8) + 2 * m + 36
        for eye in eyes:
            w, _, _, off = unpack_stream(blob, off)
            eye.append(w)
        assert off == len(blob)
    out = []
    for ws in eyes:
        words = np.zeros((len(ws), max(w.shape[1] for w in ws),
                          ws[0].shape[0]), np.int32)
        for i, w in enumerate(ws):
            words[i, : w.shape[1], :] = w.T
        out.append(words)
    return out


def test_device_word_rebuild_equals_host_rebuild(codecs):
    """Both decoders rebuild the word buffer on the device (expand_words)
    from the exact-dense words: from the batch container's and from the
    per-pair containers' concatenated payloads, the result must equal
    the host rebuild of the per-pair containers."""
    _, model = codecs
    codec = _codec(model)
    x1, x2, h = _pair(3, seed=6, deg=6.0)
    batch = _parse_batch(codec.compress_fast(x1, x2, h,
                                             batch_container=True)["blob"])
    blobs = codec.compress_fast(x1, x2, h)["blobs"]
    parsed = [codec._parse_pair(bl) for bl in blobs]
    for e, want in enumerate(_host_rebuild(blobs)):
        c, _, w = batch["streams"][e]
        dev = expand_words(torch.from_numpy(w.astype(np.int32)),
                           torch.from_numpy(c.astype(np.int32)),
                           max(int(c.max()), 1))
        np.testing.assert_array_equal(dev.numpy(), want)
        streams = [(np.concatenate([p["streams"][i][0] for p in parsed]),
                    np.stack([p["streams"][i][1] for p in parsed]),
                    np.stack([p["streams"][i][2] for p in parsed]))
                   for i in range(2)]
        z = [np.zeros((3, 1, 1, 1), np.int32)] * 2
        cen = np.zeros((2, 3, M), np.int8)
        *_, up = codec._upload_decode(streams, z, cen, cen != 0,
                                      np.stack([p["h"] for p in parsed]))
        np.testing.assert_array_equal(up[e][0].numpy(), want)


def test_batch_container_refused_by_per_pair_decoder(codecs):
    _, model = codecs
    codec = _codec(model)
    blob = codec.compress_fast(*_pair(2, seed=7),
                               batch_container=True)["blob"]
    with pytest.raises(ValueError):
        codec.decompress_fast(blob)


def test_per_pair_container_refused_by_batch_decoder(codecs):
    _, model = codecs
    codec = _codec(model)
    for blob in codec.compress_fast(*_pair(2, seed=8))["blobs"]:
        with pytest.raises(ValueError):
            codec.decompress_fast_batch(blob)


def test_input_memory_order_does_not_change_containers(codecs):
    """Images in another memory order (width-major, as smooth_pairs makes
    them) or read-only go up in their own layout and give the same
    containers as C-ordered ones."""
    _, model = codecs
    codec = _codec(model)
    x1, x2, h = _pair(2, seed=9, deg=6.0)
    want = codec.compress_fast(x1, x2, h, batch_container=True)["blob"]
    wide = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)).transpose(
        0, 2, 1, 3) for x in (x1, x2)]
    assert not wide[0].flags["C_CONTIGUOUS"]
    frozen = [x.copy(order="K") for x in wide]
    for x in frozen:
        x.setflags(write=False)
    assert not frozen[0].flags["C_CONTIGUOUS"]
    for a, b in (wide, frozen):
        got = codec.compress_fast(a, b, h, batch_container=True)["blob"]
        assert got == want


def test_next_grids_follow_the_spreads(codecs):
    _, model = codecs
    codec = _codec(model)
    assert codec._next_mm is None
    x1, x2, h = _pair(2, seed=9)
    out = codec.compress_fast(x1, x2, h, batch_container=True)
    enc = codec.transforms_enc(codec._to_device(x1), codec._to_device(x2),
                               codec._homographies(h, 2)[0], out["blob"][3])
    want = (pick_mm(int(enc[6]), 32), pick_mm(int(enc[7]), 32))
    assert codec._next_mm == want == tuple(out["blob"][1:3])


@pytest.mark.parametrize("pipeline", [2, 0])
def test_bench_loop_runs_exact_on_cpu(codecs, pipeline):
    _, model = codecs
    tiny = HESIC(N=16, M=M, K=2, device="cpu", seed=1)
    tiny.load_state_dict(model.state_dict())
    args = bench.parse_args(["--size", "64", "--batch", "2", "--batches",
                             "2", "--calib-steps", "2", "--device", "cpu",
                             "--pipeline", str(pipeline), "--h", "real"])
    assert isinstance(args, argparse.Namespace)
    res = bench.bench(tiny, args, calib_hw=64)
    assert res["pairs_per_sec"] > 0 and res["bpp_real"] > 0
    assert len(res["mm"]) == 2
