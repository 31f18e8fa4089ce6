"""HESIC+ on the wavefront coder (``benchmark/coders/wavefront.py``) at a
tiny size on the CPU: the plain reference against the program on one
state dict; the coder's lanes and code lengths against the container; a
coder stating lanes 2% long and the fp8 control each make the cell not
correct; the three readers of kernels 4-5 on a synthetic trace.  The
cell's tiny widths (N 16, M 24; 8 groups of 3 channels) and its fault
points for the shared fault tests are ``benchmark/conftest.py``'s."""

import pytest
import torch

from benchmark import limits, pairs, run, weights
from benchmark.tests import tiny

CONFIG = "hesicplus-n128-m192"
CELL = "hesicplus.rig-batch64"

P = {"alpha": 1.0, "chroma": 0.3, "mean": 0.45, "std": 0.2, "margin": 16,
     "gain": 0.03, "offset": 0.02, "noise_std": 0.01,
     "homography": {"rot_deg": 1.5, "shift_px": 8}}


def cfg():
    return dict(run.read_json(f"benchmark/configs/{CONFIG}.json"),
                widths=tiny.WIDTHS[CONFIG])


def both(seed=3):
    """The reference and the program (float32) on one drawn state dict."""
    ref = run.load_file(f"benchmark/reference/{CONFIG}.py")
    rmodel = ref.build(cfg(), "cpu")
    weights.draw(rmodel, seed)
    prog = run.program_class(cfg()["program"]["model"])(
        **cfg()["widths"], dtype=None, device="cpu", seed=0)
    prog.load_state_dict(rmodel.state_dict())
    return ref, rmodel, prog


def close(a, b):
    return torch.allclose(a, b, atol=1e-4, rtol=1e-4)


def test_reference_matches_program():
    from hesic_tpu_torch.geometry.warp import warp_perspective_train
    ref, r, p = both()
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(1, 3, "cpu"),
                                 "cpu")
    with torch.no_grad():
        y1, y2 = ref.analysis(r, x1, x2, h)
        assert close(y1, p.analysis1(x1))
        assert close(y2, p.analysis2(warp_perspective_train(x1, h), x2))
        z1, z2 = ref.hyper(r, y1, y2)
        for eye, y, z in ((1, y1, z1), (2, y2, z2)):
            med = getattr(p, f"entropy_bottleneck{eye}").medians()
            got = getattr(p, f"hyper_analysis{eye}")(y)
            assert torch.equal(z, torch.round(got - med[None, :, None,
                                                        None]))
            pre = ref.hyper_params(r, eye, z)
            assert close(pre, getattr(p, f"hyper_synthesis{eye}")(
                z + med[None, :, None, None]))
        yh1, yh2 = torch.round(y1), torch.round(y2)
        post = ref.left_prior(r, yh1, h)
        assert torch.equal(post, p.left_prior(p.synthesis1(yh1), h))
        for eye, yh, extra in ((1, yh1, []), (2, yh2, [post])):
            ctx = getattr(p, f"context_prediction{eye}")(yh)
            assert close(getattr(r, f"context_prediction{eye}")(yh), ctx)
            pre = ref.hyper_params(r, eye, z1 if eye == 1 else z2)
            s, mu = ref.eye_params(r, eye, pre, yh, *extra)
            g = getattr(p, f"entropy_params{eye}")(torch.cat([pre, ctx]
                                                              + extra, 1))
            assert g.shape[1] == 2 * 24
            assert close(s, g[:, :24]) and close(mu, g[:, 24:])
        a1, a2 = ref.synthesis(r, yh1, yh2, h)
        b1 = p.synthesis1(yh1)
        assert close(a1, b1)
        assert close(a2, p.synthesis2(yh2, warp_perspective_train(b1, h)))


def test_level_scan_is_the_raster_recursion():
    """The control's level scan gives latents whose residuals around the
    means of their own causal context are integers."""
    ref, r, _ = both()
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(2, 3, "cpu"),
                                 "cpu")
    with torch.no_grad():
        y1, _ = ref.analysis(r, x1, x2, h)
        z1 = ref.hyper_eye(r, 1, y1)
        yh = ref.level_scan(r, 1, y1, z1)
        _, mu = ref.eye_params(r, 1, ref.hyper_params(r, 1, z1), yh)
    res = yh - mu
    assert (res - torch.round(res)).abs().max() < 1e-4
    assert torch.equal(torch.round(res), torch.round(y1 - mu))


def program_codec(prog, mm=16):
    c = cfg()
    return run.coder(c).build(run.program_class(c["program"]["codec"]),
                              prog, dict(c, mm=mm), {"batch": 2})


def test_coder_lanes_give_the_stated_bits():
    """The program's own teacher intervals, laid out in the coder's lane
    order and coded by its rANS, give each lane the code length the
    container states."""
    from benchmark.coders import wavefront as wf
    _, _, p = both()
    codec = program_codec(p)
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(4, 3, "cpu"),
                                 "cpu")
    nhwc = [t.permute(0, 2, 3, 1).contiguous() for t in (x1, x2)]
    blob = codec.compress_fast(*nhwc, h.numpy())["blob"]
    rate = wf.stated(blob, cfg())
    y1, y2, z1, z2 = codec.transforms_enc(x1, x2, h)
    eyes = codec._chain(z1, z2, *(t.permute(0, 2, 3, 1) for t in (y1, y2)),
                        None, None, None, None, h, True)[:2]
    hy = 64 // 16
    at, ok = (torch.as_tensor(a) for a in wf.lane_map(hy, hy, 24, 8))
    lanes = at.shape[1]
    for e, (starts, freqs, _, _) in enumerate(eyes):
        img = [torch.ones(2, 24 * hy * hy, dtype=torch.int64),
               torch.zeros(2, 24 * hy * hy, dtype=torch.int64)]
        for b in range(2):
            for t in range(at.shape[0]):
                keep = ok[t]
                cols = b * lanes + torch.nonzero(keep)[:, 0]
                img[0][b, at[t][keep]] = freqs[t, cols].long()
                img[1][b, at[t][keep]] = starts[t, cols].long()
        got = wf.rans_bits(*(i.reshape(2, 24, hy, hy) for i in img), hy, hy,
                           8)
        assert torch.allclose(got, rate["bits"][:, e], rtol=0, atol=1e-6)


def tiny_run(coder=None, limits_=None, **kw):
    over = tiny.override(CELL)
    if coder:
        over["config"]["coder"] = coder
    if limits_:
        over["config"]["limits"] = dict(over["config"]["limits"], **limits_)
    return run.run_cell(tiny.args(CELL, **kw), device="cpu",
                        check_chip=False, override=over)


def test_lanes_stated_long_are_not_correct(monkeypatch):
    """The container's lanes 2% longer than the reference's coder gives:
    the left eye's gap reads 2% against the cell's own limit."""
    import types
    cell_limit = run.cell(CELL)["config"]["limits"]["rate_gap_left_pct"]
    assert cell_limit < 2.0
    real = run.coder(cfg())
    long = types.ModuleType("long_coder")
    for name in ("build", "encoded", "quantise", "stated", "control_stated",
                 "work"):
        setattr(long, name, getattr(real, name))
    long.reference_bits = lambda ref, model, batch, d: d["bits"] / 1.02
    load = run.load_file
    monkeypatch.setattr(run, "load_file", lambda rel: long if rel ==
                        "benchmark/coders/long.py" else load(rel))
    assert tiny_run()["correct"] is True
    bad = tiny_run(coder="long", limits_={"rate_gap_left_pct": cell_limit})
    chk = bad["checks"]["rate_gap_left_pct"]
    assert chk["value"] == pytest.approx(2.0) and chk["limit"] == cell_limit
    assert bad["correct"] is False and bad["failed"] > 0


def test_control_fails_through_the_coder():
    v = limits.control_checks(CELL, 2 ** 31 + 78, device="cpu",
                              override=tiny.override(CELL))
    assert v["correct"] is False


def test_calibration_is_reproducible():
    ref = run.load_file(f"benchmark/reference/{CONFIG}.py")
    recipe = dict(cfg()["calibration"], steps=2, size=64, batch=2, images=P)
    states = []
    for _ in range(2):
        m = ref.build(cfg(), "cpu")
        weights.draw(m, 5)
        losses = weights.calibrate(ref, m, recipe, 5)
        states.append(m.state_dict())
    assert losses[-1] < losses[0]
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_round_trip_counts_twelve_taps():
    """The reference's FLOP count takes the context model's 12 kept taps,
    not 25: its count of one context model is 2 x 12 M x 2M a latent."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = run.load_file(f"benchmark/reference/{CONFIG}.py")
    r = ref.build(cfg(), "cpu")
    y = torch.zeros(1, 24, 4, 4)
    with FlopCounterMode(display=False) as fc:
        r.context_prediction1(y)
    assert fc.get_total_flops() == 2 * 12 * 24 * 48 * 16


# a 1000 us stretch, 2 pairs: two level scans, kernel 5's launches (the
# hoisted product among them) and kernel 4's
TRACE = {
    "window": (0.0, 1000.0),
    "kernels": [("wavefront_hoist_kernel", 0.0, 10.0),
                ("void wavefront_ctx_kernel<32>", 10.0, 110.0),
                ("wavefront_coder_kernel", 110.0, 150.0),
                ("pairs_rans_encode_kernel", 200.0, 250.0),
                ("cudnn_conv", 300.0, 400.0)],
    "copies": [],
    "ranges": [("bench/traced-stretch", 0.0, 1000.0),
               ("enc/scan1", 0.0, 60.0), ("dec/scan2", 500.0, 540.0)],
}
CODER = {"wavefront": [(6.7e9, 0.0), (0.0, 3.35e9)], "pairs": [3.35e8]}
CTX = {"trace": TRACE, "traced_pairs": 2, "coder": CODER}


def read(name, ctx=CTX):
    return run.load_file(f"benchmark/metrics/{name}.py").read(ctx)


def test_readers():
    # 0.1 ms + 0.1 ms of bound over 150 us of wavefront kernels
    assert read("wavefront_roofline") == pytest.approx(100 * 2e-4 / 1.5e-4)
    assert read("pairs_rans_roofline") == pytest.approx(100 * 1e-4 / 5e-5)
    assert read("scan_ms_per_pair") == pytest.approx(0.150 / 2)


@pytest.mark.parametrize("name", ["wavefront_roofline", "pairs_rans_roofline",
                                  "scan_ms_per_pair"])
def test_readers_silent_without_their_source(name):
    bare = dict(CTX, trace=dict(TRACE, kernels=TRACE["kernels"][4:],
                                ranges=TRACE["ranges"][:1]), coder={})
    assert read(name, bare) is None


def test_stretch_on_a_tiny_codec_reads_the_program():
    """A traced tiny run: the host readers find the codec's spans and
    counters (the device readers read nothing off the card)."""
    out = tiny_run(trace=1)
    assert out["correct"] is True
    got = out["metrics"]
    assert got["host_busy_ms_per_pair"]["value"] > 0
    assert got["z_coder_ms_per_pair"]["value"] > 0
    assert got["copy_kib_per_pair"]["value"] > 0
    assert got["escape_ppm"]["value"] >= 0
    assert "wavefront_roofline" not in got
