"""A cell shrunk to what a CPU test can hold: tiny widths, 64x64 pairs,
two calibration steps."""

import argparse

WIDTHS = {"hesic-n128-m192": {"N": 16, "M": 24, "K": 2},
          "dsic-n128-m192": {"N": 16, "M": 24, "F": 6, "C": 8, "K": 2}}
# At 64x64 a pair's z has one position a channel, so one z symbol off is
# 3.1% of them, and the right eye's few latents move with each prior
# cell: sound runs there read z_mismatch_pct up to 6.3, rate_gap_pct up
# to 3.3 and rate_gap_left_pct up to 0.04.
TINY_LIMITS = {"z_mismatch_pct": 10.0, "rate_gap_pct": 5.0,
               "rate_gap_left_pct": 1.0}


def override(workload: str) -> dict:
    """The workload's cell at tiny widths, 64x64 pairs, batches of 2
    pairs, a pool of 2."""
    from benchmark import run
    c = run.cell(workload)
    config = c["config"]["name"]
    limits = {k: TINY_LIMITS.get(k, v)
              for k, v in c["config"]["limits"].items()}
    return {"config": {"widths": WIDTHS[config], "limits": limits,
                       "calibration": dict(c["config"]["calibration"],
                                           steps=2, size=64, batch=2)},
            "traffic": {"size": 64, "batch": 2, "pool": 2, "check": 2,
                        "check_from": 2, "trace_iterations": 2}}


def cells() -> list:
    """(workload, configuration) of every cell of BENCHMARK.json."""
    from benchmark import run
    return [(w["name"], w["config"]) for w in
            run.read_json("BENCHMARK.json")["workloads"]]


def args(workload: str, seed: int = 2 ** 31 + 5, seconds: float = 1.0,
         trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
