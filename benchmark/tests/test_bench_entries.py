"""Every BENCHMARK.json entry resolves to its files, and every per-layer
metric has a reader and moves a metric its cells report."""

import json
import os

import pytest

from benchmark import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


def exists(rel):
    return os.path.isfile(os.path.join(run.ROOT, rel))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(wl):
    cfg = run.read_json(CONFIGS[wl["config"]]["file"])
    traffic = run.read_json(f"benchmark/traffic/{wl['traffic']}.json")
    assert cfg["name"] == wl["config"]
    assert exists(f"benchmark/reference/{cfg['name']}.py")
    assert exists(f"benchmark/loops/{traffic['loop']}.py")
    assert exists(f"benchmark/coders/{cfg.get('coder', 'grid')}.py")
    from benchmark import judge
    assert set(cfg["limits"]) <= set(judge.NAMES)
    assert {"y_mismatch_pct", "x_rel_err_pct"} <= set(cfg["limits"])
    assert cfg["reduced"] == CONFIGS[wl["config"]]["reduced"]
    e2e = run.metrics_of(BENCH, "end_to_end", wl["name"])
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert run.metrics_of(BENCH, "per_layer", wl["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_resolves(m):
    mod = run.load_file(f"benchmark/metrics/{m['name']}.py")
    assert callable(mod.read)
    for w in m.get("workloads", [x["name"] for x in BENCH["workloads"]]):
        assert m["moves"] in [e["name"] for e in
                              run.metrics_of(BENCH, "end_to_end", w)]


def test_paths_hold_the_command():
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
