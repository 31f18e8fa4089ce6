"""The plain references agree with the program at tiny widths in float32
on the CPU, on one state dict: the weights map name for name, and the
analyses, the syntheses and the GMM heads compute the same functions."""

import pytest
import torch

from benchmark import pairs, run, weights
from benchmark.tests import tiny

P = {"alpha": 1.0, "chroma": 0.3, "mean": 0.45, "std": 0.2, "margin": 16,
     "gain": 0.03, "offset": 0.02, "noise_std": 0.01,
     "homography": {"rot_deg": 1.5, "shift_px": 8}}


def both(config):
    cfg = dict(run.read_json(f"benchmark/configs/{config}.json"),
               widths=tiny.WIDTHS[config])
    ref = run.load_file(f"benchmark/reference/{config}.py")
    rmodel = ref.build(cfg, "cpu")
    weights.draw(rmodel, 3)
    prog = run.program_class(cfg["program"]["model"])(
        **cfg["widths"], dtype=None, device="cpu", seed=0)
    prog.load_state_dict(rmodel.state_dict())
    return ref, rmodel, prog


def test_hesic_matches_program():
    ref, r, p = both("hesic-n128-m192")
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(1, 3, "cpu"),
                                 "cpu")
    with torch.no_grad():
        y1, y2 = ref.analysis(r, x1, x2, h)
        from hesic_tpu_torch.geometry.warp import warp_perspective_train
        assert torch.allclose(y1, p.analysis1(x1), atol=1e-4)
        assert torch.allclose(y2, p.analysis2(warp_perspective_train(x1, h),
                                              x2), atol=1e-4)
        yh1, yh2 = torch.round(y1), torch.round(y2)
        a1, a2 = ref.synthesis(r, yh1, yh2, h)
        b1 = p.synthesis1(yh1)
        b2 = p.synthesis2(yh2, warp_perspective_train(b1, h))
        assert torch.allclose(a1, b1, atol=1e-4)
        assert torch.allclose(a2, b2, atol=1e-4)
        z = torch.round(r.h_a1(y1))
        assert torch.allclose(z, torch.round(p.hyper_analysis1(y1)))
        for got, want in zip(r.h_s1(z), p.gmm1(z)):
            assert torch.allclose(got, want, atol=1e-4)
        for got, want in zip(r.h_s2(z, yh1), p.gmm2(z, yh1)):
            assert torch.allclose(got, want, atol=1e-4)


def test_dsic_matches_program():
    ref, r, p = both("dsic-n128-m192")
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(2, 3, "cpu"),
                                 "cpu")
    with torch.no_grad():
        y1, y2 = ref.analysis(r, x1, x2, h)
        py1, g1, g2, g3 = p.analysis1(x1)
        assert torch.allclose(y1, py1, atol=1e-4)
        ctx = p.contexts(torch.round(py1))
        assert torch.allclose(y2, p.analysis2(x2, g1, g2, g3, ctx),
                              atol=1e-4)
        yh1, yh2 = torch.round(y1), torch.round(y2)
        a1, a2 = ref.synthesis(r, yh1, yh2, h)
        b1, g4, g5, g6 = p.synthesis1(yh1)
        b2 = p.synthesis2(yh2, g4, g5, g6, p.contexts(yh1))
        assert torch.allclose(a1, b1, atol=1e-4)
        assert torch.allclose(a2, b2, atol=1e-4)


@pytest.mark.parametrize("config", ["hesic-n128-m192", "dsic-n128-m192"])
def test_calibration_is_reproducible(config):
    cfg = dict(run.read_json(f"benchmark/configs/{config}.json"),
               widths=tiny.WIDTHS[config])
    ref = run.load_file(f"benchmark/reference/{config}.py")
    recipe = dict(cfg["calibration"], steps=2, size=64, batch=2, images=P)
    states = []
    for _ in range(2):
        m = ref.build(cfg, "cpu")
        weights.draw(m, 5)
        losses = weights.calibrate(ref, m, recipe, 5)
        states.append(m.state_dict())
    assert losses[-1] < losses[0]
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_coder_emulation_matches_container():
    """Rows built from the program's own left head and the coder run over
    them give each lane the code length its batch container states."""
    from benchmark import judge
    _, r, p = both("hesic-n128-m192")
    cfg = dict(run.read_json("benchmark/configs/hesic-n128-m192.json"),
               widths=tiny.WIDTHS["hesic-n128-m192"])
    grid = run.coder(cfg)
    codec = grid.build(run.program_class(cfg["program"]["codec"]), p, cfg,
                       {"batch": 2})
    x1, x2, h = pairs.make_pairs(2, 64, P, pairs.generator(4, 3, "cpu"),
                                 "cpu")
    nhwc = [t.permute(0, 2, 3, 1).contiguous() for t in (x1, x2)]
    blob = codec.compress_fast(*nhwc, h.numpy(), batch_container=True)[
        "blob"]
    rec = codec.decompress_fast_batch(blob)
    rate = grid.stated(blob, cfg)
    z1 = grid.encoded(codec, {"x1": nhwc[0], "x2": nhwc[1], "h": h},
                      blob)[2]
    with torch.no_grad():
        head = p.gmm1(z1 + codec._median("entropy_bottleneck1"))
        rows = grid.code_rows(judge.nchw(rec["y1_hat"]), head, 2,
                              rate["params"][0])
        got = grid.rans_bits([rows], rate["bits"].shape[2])[:, 0]
    assert torch.allclose(got, rate["bits"][:, 0], rtol=0, atol=1e-6)
