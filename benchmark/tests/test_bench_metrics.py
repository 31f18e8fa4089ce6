"""The per-layer readers on a synthetic trace whose numbers are known."""

import pytest

from benchmark import peaks, profiling, run

# a 1000 us stretch: two streams, 600 us busy in their union
TRACE = {
    "window": (0.0, 1000.0),
    "kernels": [("gmm_freq_kernel", 0.0, 100.0),
                ("cudnn_conv_fprop", 100.0, 400.0),
                ("elementwise_kernel", 350.0, 450.0),      # overlaps
                ("grid_rans_encode_kernel", 500.0, 550.0),
                ("grid_rans_decode_kernel", 550.0, 600.0)],
    "copies": [("Memcpy HtoD (Pinned -> Device)", 900.0, 950.0)],
    "ranges": [("enc/z-rans+unpack", 600.0, 900.0),
               ("dec/parse", 950.0, 1000.0)],
}
CODER = {"gmm": [(64, 192, 5, 1024, 4), (64, 192, 5, 1024, 8)],
         "rans": [(10 ** 7, 64 * 192 * 1024, 64 * 128)] * 2}
CTX = {"trace": TRACE, "traced_pairs": 4, "flops_per_pair": 2.0e11,
       "coder": CODER}


def read(name, ctx=CTX):
    return run.load_file(f"benchmark/metrics/{name}.py").read(ctx)


def test_busy_and_gaps():
    assert profiling.busy_us(TRACE) == 600.0
    assert profiling.gaps(TRACE) == [(450.0, 500.0), (600.0, 900.0),
                                     (950.0, 1000.0)]


def test_idle():
    assert read("idle_pct.batch") == pytest.approx(40.0)


def test_transforms_ms_per_pair():
    assert read("transforms_ms_per_pair") == pytest.approx(0.4 / 4)


def test_rooflines():
    bound = sum(peaks.gmm_freq_bound_s(*g) for g in CODER["gmm"])
    assert read("gmm_freq_roofline") == pytest.approx(100 * bound / 1e-4)
    rb = 2 * (4 * 10 ** 7 + 4 * 64 * 192 * 1024 + 12 * 64 * 128) / 3.35e12
    assert read("grid_rans_roofline") == pytest.approx(100 * rb / 1e-4)


def test_roofline_silent_without_its_kernel():
    ctx = dict(CTX, trace=dict(TRACE, kernels=TRACE["kernels"][1:3]))
    assert read("gmm_freq_roofline", ctx) is None
    assert read("grid_rans_roofline", ctx) is None


def test_mfu():
    # 4 pairs' FLOPs in the 1000 us stretch
    assert read("mfu_pct") == pytest.approx(100 * 2e11 * 4 / 1e-3
                                            / 989.4e12)


def test_gmm_bound_by_operations():
    s = 9
    ops = 64 * 192 * 1024 * (5 * (s + 1) * 57 + 5 * s * 3 + s * 8 + 5 * 11)
    assert peaks.gmm_freq_bound_s(64, 192, 5, 1024, 4) == pytest.approx(
        ops / 33.5e12)


def test_breakdown():
    bd = profiling.breakdown(TRACE)
    assert bd["device_ops"][0] == ["cudnn_conv_fprop", 300e-6]
    assert bd["idle_gaps"][0] == ["enc/z-rans+unpack", pytest.approx(3e-4)]
    assert dict(bd["idle_gaps"])["no host range"] == pytest.approx(5e-5)
