"""Port: HESIC+'s wavefront device codec on the fast codecs' protocol
(hesic_tpu_torch/models/ar_device.py: ``compress_fast``,
``compress_fast_start`` / ``compress_fast_finish``,
``decompress_fast_batch``), on the CPU at tiny widths with random weights
(HESIC+ N16/M24, 4 channel groups), batches of 2 pairs of 64x64 images.

* Starts and finishes interleaved as the benchmark's pipelined loop
  interleaves them (the next batch's start before this batch's finish,
  a decode between) give ``compress``'s containers byte for byte, and
  both give the container as its layout is written down (the class
  docstring), assembled here from the teacher chain, kernel 4's plain
  twin and numpy; with and without escapes, and when an eye's escapes
  pass the start's slab (ESCAPE_CAP: the finish's synchronous gather,
  counted).
* ``decompress_fast_batch`` decodes to the encoder's latents and to
  ``decompress``'s outputs, exactly.
* The dispatch paths read nothing back from a tensor:
  tests/test_torch_pipelined.py holds every fast codec to it.
* Under torch.profiler every span and counter the module docstring names
  is entered, and the counters hold what the shapes and containers give.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hesic_tpu_torch.models import ar_device
from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec, schedule
from hesic_tpu_torch.models.hesic_plus import HESICPlus

torch.set_num_threads(2)

B, M, SIZE, GROUPS = 2, 24, 64, 4
CALLS = ("codec/compress_fast", "codec/compress_fast_start",
         "codec/compress_fast_finish", "codec/decompress_fast_batch")
ENC = ("enc/transforms", "enc/scan1", "enc/reencode", "enc/scan2",
       "enc/pairs-rans", "enc/fetch", "enc/wait-counts", "enc/words-d2h",
       "enc/wait-words", "enc/escapes", "enc/z-rans", "enc/pack")
DEC = ("dec/parse", "dec/z-rans", "dec/upload", "dec/expand", "dec/scan1",
       "dec/reencode", "dec/scan2", "dec/synthesis")
COUNTERS = ("batch", "h2d_bytes", "d2h_bytes", "latents", "escapes",
            "escape_fallbacks", "scan_levels")


@pytest.fixture(scope="module")
def model():
    return HESICPlus(N=16, M=M, device="cpu", seed=0)


def _codec(model, mm=4):
    return HESICPlusDeviceCodec(model, mm=mm, groups=GROUPS).update()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    x1, x2 = ((rng.rand(B, SIZE, SIZE, 3) * 4 - 1.5).astype(np.float32)
              for _ in range(2))
    th = 0.02 * seed
    h = np.array([[np.cos(th), -np.sin(th), seed], [np.sin(th), np.cos(th),
                                                    -1.0], [0, 0, 1]],
                 np.float32)
    return x1, x2, np.tile(h[None], (B, 1, 1))


def _layout(codec, x1, x2, h):
    """The container of one batch as the class docstring lays it out:
    backend byte 3 (the CPU twin) | u32 B, H, W, zh, zw | per eye its
    escapes (u32 n | u32 flat NHWC index[n] | i32 value[n]) | B z1
    strings | B z2 strings (u32 length | bytes) | B x 9 f32 homographies
    | per eye the packed stream of one kernel 4 launch over its teacher
    pass."""
    from hesic_tpu_torch.codecs.device_rans import pack_stream
    from hesic_tpu_torch.codecs.pairs_rans import rans_encode_pairs
    ht = torch.as_tensor(h)
    y1, y2, z1, z2 = codec.transforms_enc(codec._to_device(x1),
                                          codec._to_device(x2), ht)
    eyes = codec._chain(z1, z2, y1.permute(0, 2, 3, 1),
                        y2.permute(0, 2, 3, 1), None, None, None, None, ht,
                        True)[:2]
    parts = [bytes([3]), np.array([B, SIZE, SIZE, *z1.shape[2:]],
                                  np.uint32).tobytes()]
    for eye in eyes:
        flat = eye[3].reshape(-1).numpy()
        idx = np.flatnonzero(np.abs(flat) > codec.mm)
        parts += [np.uint32(idx.size).tobytes(),
                  idx.astype(np.uint32).tobytes(),
                  flat[idx].astype(np.int32).tobytes()]
    for name, z in (("entropy_bottleneck1", z1), ("entropy_bottleneck2", z2)):
        for s in codec.eb_encode_symbols(name, z.permute(0, 2, 3, 1).numpy()):
            parts += [np.uint32(len(s)).tobytes(), s]
    parts.append(h.astype(np.float32).tobytes())
    hy = SIZE // 16
    valid = ar_device.wavefront_valid_mask(hy, hy, B, GROUPS, M)
    for starts, freqs, _, _ in eyes:
        words, counts, states = rans_encode_pairs(starts, freqs, valid,
                                                  starts.shape[0])
        parts.append(pack_stream(words.numpy(), counts.numpy(),
                                 states.numpy().astype(np.uint32)))
    return b"".join(parts)


def _loop(codec, batches):
    """The pipelined loop's order: start(0); then per i decode(i-1),
    start(i+1), finish(i).  Returns the containers and the decodes."""
    blobs, recs = [], []
    handle, prev = codec.compress_fast_start(*batches[0]), None
    for i in range(len(batches)):
        if prev is not None:
            recs.append(codec.decompress_fast_batch(prev))
        nxt = (codec.compress_fast_start(*batches[i + 1])
               if i + 1 < len(batches) else None)
        prev = codec.compress_fast_finish(handle)["blob"]
        blobs.append(prev)
        handle = nxt
    recs.append(codec.decompress_fast_batch(prev))
    return blobs, recs


@pytest.mark.parametrize("mm,escape_cap", [(4, None), (1, None), (1, 3)],
                         ids=["grid", "escapes", "fallback"])
def test_pipelined_containers_are_compress(model, mm, escape_cap,
                                           monkeypatch):
    if escape_cap:
        monkeypatch.setattr(ar_device, "ESCAPE_CAP", escape_cap)
    codec = _codec(model, mm)
    batches = [_inputs(s) for s in (1, 2, 3)]
    want = [codec.compress(*b) for b in batches]
    blobs, recs = _loop(codec, batches)
    for w, blob, rec, b in zip(want, blobs, recs, batches):
        assert blob == w["strings"][0] == _layout(codec, *b)
        for key in ("y1_hat", "y2_hat"):
            assert torch.equal(rec[key], w[key])
    if mm == 1:      # escapes in every eye; past the slab with cap 3
        assert all(min(w["escapes"]) > 3 for w in want)


def test_fast_decode_is_decompress(model):
    codec = _codec(model, mm=1)
    x1, x2, h = _inputs(4)
    out = codec.compress_fast(x1, x2, h, batch_container=True)
    assert set(out) >= {"blob", "blobs", "bpp_real", "enctime", "escapes"}
    assert out["blobs"] == [out["blob"]] and min(out["escapes"]) > 0
    rec = codec.decompress_fast_batch(out["blob"])
    old = codec.decompress([out["blob"]])
    y1, y2, _, _ = codec.coded_latents(codec._to_device(x1),
                                       codec._to_device(x2),
                                       torch.as_tensor(h))
    assert torch.equal(rec["y1_hat"], y1) and torch.equal(rec["y2_hat"], y2)
    for key in ("x1_hat", "x2_hat", "y1_hat", "y2_hat"):
        assert torch.equal(rec[key], old[key]), key
    assert rec["x1_hat"].shape == (B, SIZE, SIZE, 3)
    with pytest.raises(ValueError, match="parse ends"):
        codec.decompress_fast_batch(out["blob"] + b"\0")


def _traced(codec, x1, x2, h):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = codec.compress_fast(x1, x2, h)
        handle = codec.compress_fast_start(x1, x2, h)
        codec.decompress_fast_batch(out["blob"])
        fin = codec.compress_fast_finish(handle)
    return out, fin, sorted(((e.name, e.time_range.start)
                             for e in prof.events() if e.is_user_annotation),
                            key=lambda s: s[1])


def test_spans_and_counters(model, monkeypatch):
    monkeypatch.setattr(ar_device, "ESCAPE_CAP", 3)
    codec = _codec(model, mm=1)
    x1, x2, h = _inputs(6)
    codec.compress(x1, x2, h)       # the level scan's mask goes up once
    out, fin, spans = _traced(codec, x1, x2, h)
    assert fin["blob"] == out["blob"]
    names = {n for n, _ in spans}
    assert set(CALLS + ENC + DEC) <= names, sorted(set(CALLS + ENC + DEC)
                                                   - names)
    counts = {}
    for name, _ in spans:
        if name.startswith("count/"):
            key, eq, value = name[len("count/"):].partition("=")
            assert key in COUNTERS and eq == "=" and int(value) >= 0, name
            counts.setdefault(key, []).append(int(value))
    assert set(COUNTERS) <= set(counts), sorted(set(COUNTERS) - set(counts))
    # after compress's, two encodes (compress_fast, start + finish); one
    # decode
    assert counts["batch"] == [1, 2, 0, 2]
    hy = SIZE // 16
    assert counts["latents"] == [2 * B * M * hy * hy] * 2
    assert counts["escapes"] == [sum(out["escapes"])] * 2
    # every eye past the slab of 3 takes the fallback
    assert counts["escape_fallbacks"] == [2, 2]
    # three chains (two teacher, one decode), two passes each
    assert counts["scan_levels"] == [schedule(hy, hy)[0]] * 6
    # the decode's one upload, after each encode's images and homographies
    assert len(counts["h2d_bytes"]) == 7
    assert counts["h2d_bytes"][:3] == [x1.nbytes, x2.nbytes, 36 * B]
    # each encode's fetch (counts, states, slabs as int64; z as int32),
    # then its counted words, 2 bytes each
    lanes = B * schedule(hy, hy)[3] * (M // GROUPS)
    zc = codec.eb_medians("entropy_bottleneck1").size
    fetch = 8 * (4 * lanes + 2 * (2 * ar_device.ESCAPE_CAP + 1)) \
        + 4 * 2 * B * zc * (SIZE // 64) ** 2
    assert counts["d2h_bytes"] == [fetch, _word_bytes(out["blob"])] * 2


def _word_bytes(blob):
    """The bytes of both packed streams' words."""
    from hesic_tpu_torch.codecs.device_rans import unpack_stream_dense
    b = int(np.frombuffer(blob, np.uint32, 1, 1)[0])
    off = 21
    for _ in range(2):
        off += 4 + 8 * int(np.frombuffer(blob, np.uint32, 1, off)[0])
    for _ in range(2 * b):
        off += 4 + int(np.frombuffer(blob, np.uint32, 1, off)[0])
    off += 36 * b
    total = 0
    for _ in range(2):
        flat, _, _, off = unpack_stream_dense(blob, off)
        total += 2 * flat.size
    return total
