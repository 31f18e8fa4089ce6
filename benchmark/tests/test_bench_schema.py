"""The result's last line: its keys and types, on the CPU at a tiny size;
and no result without a card."""

import pytest

from benchmark import run
from benchmark.tests import tiny

CELLS = tiny.cells()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_result_schema(cell, trace):
    wl, cfg = cell
    out = run.run_cell(tiny.args(wl, trace=trace), device="cpu",
                       check_chip=False,
                       override=tiny.override(wl))
    assert list(out)[:3] == ["correct", "attempted", "failed"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = {m["name"] for m in run.metrics_of(
        run.read_json("BENCHMARK.json"),
        "per_layer" if trace else "end_to_end", wl)}
    got = set(out["metrics"])
    # on the CPU the device trace is empty: the rooflines read nothing
    assert got <= want and (trace or got == want)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(
            m["value"], (int, float))
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    for chk in out["checks"].values():
        assert set(chk) == {"value", "limit"}


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "hesic.rig-batch64", "--seed", "1",
                  "--seconds", "1"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
