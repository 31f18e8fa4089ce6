"""The check catches a broken timed path: with each fault the cells can
have planted under the program's decoder, a run at a tiny size comes
out not correct (the look for a card is skipped); so it does with the
GMM conditioning widened on both sides, which still decodes exactly;
and the control, the reference computed in fp8 in the program's place,
fails the limits."""

import pytest
import torch

from benchmark import limits, run
from benchmark.tests import tiny

CELLS = tiny.cells()


def altered(out, state):
    """One decoded latent altered where it is produced."""
    out["y2_hat"][0, 0, 0, 0] += 1
    return out


def unchanged(out, state):
    """The decoder hands back its first output every time."""
    return state.setdefault("first", out)


def half(out, state):
    """Half of the batch left out: its first half stands for all of it."""
    b = out["y1_hat"].shape[0]
    k = b // 2
    return {key: torch.cat([v[:k], v[:k]] * 2)[:b] for key, v in
            out.items()}


def reconstruction(out, state):
    """The right reconstruction altered where it is produced."""
    out["x2_hat"] = out["x2_hat"] * 1.1
    return out


@pytest.mark.parametrize("fault", [altered, unchanged, half,
                                   reconstruction],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
    wl, cfg = cell
    orig = HESICFastCodec._decode_device
    state = {}

    def broken(self, *a, **k):
        return fault(orig(self, *a, **k), state)

    monkeypatch.setattr(HESICFastCodec, "_decode_device", broken)
    out = run.run_cell(tiny.args(wl), device="cpu", check_chip=False,
                       override=tiny.override(wl))
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_conditioning_fault_is_not_correct(cell, monkeypatch):
    from hesic_tpu_torch.models import dsic_fast, hesic_fast
    wl, cfg = cell
    orig = hesic_fast._gmm_freq_fast

    def wide(sigma, *a, **k):
        return orig(sigma * 2, *a, **k)

    for mod in (hesic_fast, dsic_fast):
        monkeypatch.setattr(mod, "_gmm_freq_fast", wide)
    out = run.run_cell(tiny.args(wl), device="cpu", check_chip=False,
                       override=tiny.override(wl))
    assert out["checks"]["inexact_pairs"]["value"] == 0
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_control_is_not_correct(cell):
    wl, cfg = cell
    v = limits.control_checks(wl, 2 ** 31 + 77, device="cpu",
                              override=tiny.override(wl))
    assert v["correct"] is False


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_unjudged_draw_is_not_correct(cell):
    """A window that ends after its first iteration never decodes the
    second drawn one: its pairs count as failed."""
    wl, cfg = cell
    out = run.run_cell(tiny.args(wl, seconds=0.0), device="cpu",
                       check_chip=False, override=tiny.override(wl))
    assert out["checks"]["unjudged_pairs"]["value"] == 2
    assert out["correct"] is False and out["failed"] >= 2


@pytest.mark.parametrize("wl", [w for w, _ in CELLS])
def test_draw_falls_on_distinct_pool_batches(wl):
    """Every seed's draw holds distinct pool batches, and a seed whose
    first draw did keeps it."""
    import numpy as np
    traffic = run.cell(wl)["traffic"]
    kept = 0
    for seed in range(2 ** 31 - 200, 2 ** 31 + 200):
        draw = run.kept_indices(traffic, seed)
        assert len(draw) == traffic["check"]
        assert len({i % traffic["pool"] for i in draw}) == len(draw)
        first = {int(i) for i in np.random.default_rng(
            [seed, run.STREAM_SAMPLE]).choice(traffic["check_from"],
                                              traffic["check"],
                                              replace=False)}
        if len({i % traffic["pool"] for i in first}) == len(first):
            assert draw == first
            kept += 1
    assert 0 < kept < 400
