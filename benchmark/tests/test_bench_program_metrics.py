"""The readers of the program's own spans and counters (host_busy_ms_per_
pair, z_coder_ms_per_pair, copy_kib_per_pair, device_allocs_per_batch,
escape_ppm) on a synthetic trace whose numbers are known, and on a tiny
codec's trace on the CPU."""

import numpy as np
import pytest

from benchmark import profiling, program_spans, run

# a 1000 us stretch, 4 pairs: a decode, a start and a finish inside it, a
# second finish cut by its end; samples outside the window do not count
RANGES = [
    (profiling.WINDOW_RANGE, 0.0, 1000.0),
    ("count/escapes=1000", -5.0, -5.0),
    ("codec/decompress_fast_batch", 0.0, 300.0),
    ("count/batch=7", 1.0, 1.0),
    ("dec/z-rans", 50.0, 150.0),
    ("count/h2d_bytes=4096", 160.0, 160.0),
    ("count/device_allocs=2", 299.0, 299.0),
    ("codec/compress_fast_start", 300.0, 400.0),
    ("count/device_allocs=1", 399.0, 399.0),
    ("codec/compress_fast_finish", 450.0, 950.0),
    ("enc/wait-copies", 450.0, 650.0),
    ("count/d2h_bytes=2048", 660.0, 660.0),
    ("enc/wait-words", 700.0, 750.0),
    ("count/latents=1000000", 800.0, 800.0),
    ("count/escapes=25", 800.0, 800.0),
    ("enc/z-rans", 850.0, 900.0),
    ("count/device_allocs=3", 949.0, 949.0),
    ("codec/compress_fast_finish", 980.0, 1100.0),
    ("dec/wait", 990.0, 1010.0),
    ("count/h2d_bytes=999999", 1050.0, 1050.0),
]
TRACE = {"window": (0.0, 1000.0), "kernels": [], "copies": [],
         "ranges": RANGES}
CTX = {"trace": TRACE, "traced_pairs": 4}
NAMES = ("host_busy_ms_per_pair", "z_coder_ms_per_pair", "copy_kib_per_pair",
         "device_allocs_per_batch", "escape_ppm")


def read(name, ctx=CTX):
    return run.load_file(f"benchmark/metrics/{name}.py").read(ctx)


def test_host_busy():
    # calls 400 + 500 + 20 us, less the waits 200 + 50 + 10 us
    assert read("host_busy_ms_per_pair") == pytest.approx(0.660 / 4)


def test_z_coder():
    assert read("z_coder_ms_per_pair") == pytest.approx(0.150 / 4)
    # the encoder's z coding absent (the program before its span had this
    # name): nothing
    ctx = dict(CTX, trace=dict(TRACE, ranges=[
        r for r in RANGES if r[0] != "enc/z-rans"]))
    assert read("z_coder_ms_per_pair", ctx) is None


def test_copies():
    assert read("copy_kib_per_pair") == pytest.approx(6.0 / 4)


def test_allocs_per_batch():
    # 2 + 1 + 3 calls over the two finishes in the window
    assert read("device_allocs_per_batch") == pytest.approx(3.0)


def test_escapes():
    assert read("escape_ppm") == pytest.approx(25.0)


@pytest.mark.parametrize("name", NAMES)
def test_silent_without_the_program_spans(name):
    ctx = dict(CTX, trace=dict(TRACE, ranges=RANGES[:1]))
    assert read(name, ctx) is None


@pytest.mark.parametrize("name,wait", [
    ("dec/wait", True), ("enc/wait-copies", True), ("enc/wait-words", True),
    ("enc/words-d2h", False), ("codec/compress_fast", False),
    ("wait-x", False), ("dec/waiting", False)])
def test_wait_names(name, wait):
    assert program_spans.is_wait(name) is wait


def test_counts_parse_in_the_window():
    assert program_spans.counts(TRACE, "h2d_bytes") == [4096]
    assert program_spans.counts(TRACE, "batch") == [7]


def test_readers_on_a_tiny_codec():
    """A tiny HESIC fast codec's pipelined round trips traced on the CPU:
    the readers find the program's spans and counters."""
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec

    model = HESIC(N=16, M=24, K=2, device="cpu", seed=0)
    codec = HESICFastCodec(model, mm=4, codec_batch=2).update()
    rng = np.random.RandomState(1)
    x1, x2 = ((rng.rand(2, 64, 64, 3) * 4 - 1.5).astype(np.float32)
              for _ in range(2))
    h = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    blob = codec.compress_fast_finish(
        codec.compress_fast_start(x1, x2, h))["blob"]
    with profiling.traced(lambda: None) as tr:
        handle = codec.compress_fast_start(x1, x2, h)
        codec.decompress_fast_batch(blob)
        out = codec.compress_fast_finish(handle)
    ctx = {"trace": tr["trace"], "traced_pairs": 2}
    values = {name: read(name, ctx) for name in NAMES}
    assert values["device_allocs_per_batch"] is None      # no card
    assert values["host_busy_ms_per_pair"] > values["z_coder_ms_per_pair"]
    assert values["z_coder_ms_per_pair"] > 0
    hy = 64 // 16
    assert values["escape_ppm"] == pytest.approx(
        1e6 * sum(out["outliers"]) / (2 * 2 * 24 * hy * hy))
    assert values["escape_ppm"] > 0
    assert values["copy_kib_per_pair"] > 0
