"""The readings the check's limits are set from, on the card, in one
process: the program's sound runs over many seeds (each a short window at
the cell's own load, judged as a benchmark run judges it) and the
control's (the reference computed in fp8 in the program's place, on the
same kept batches), and the FLOP cross-check.

    python3 benchmark/limits.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--flops 1]

Prints one JSON line per reading: {"side": "program" | "control",
"seed", "checks"}; with --flops 1 one line with the reference's FLOPs a
pair and the program's own count (``device_flops``) at the cell's size.
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import judge, run, weights  # noqa: E402


def cell(workload: str, override=None) -> tuple:
    """(configuration, traffic, reference module) of a cell."""
    c = run.cell(workload)
    for key, extra in (override or {}).items():
        c[key] = dict(c[key], **extra)
    cfg = c["config"]
    return cfg, c["traffic"], run.load_file(
        f"benchmark/reference/{cfg['name']}.py")


def control_checks(workload: str, seed: int, device="cuda",
                   override=None, state=None) -> dict:
    """The control's numbers for one seed: the configuration's weights, the
    seed's pool, the kept batches' fp8 reference outputs judged against
    the float32 reference."""
    import torch
    cfg, traffic, ref = cell(workload, override)
    dev = torch.device(device)
    if state is None:
        state = weights.state(cfg, dev)
    model = ref.build(cfg, dev)
    model.load_state_dict(state)
    model.requires_grad_(False)
    cod = run.coder(cfg)
    pool = run.make_pool(traffic, seed, dev)
    idx = sorted({i % len(pool) for i in run.kept_indices(traffic, seed)})
    ctrl = judge.control_outputs(ref, model, pool, idx, cod, cfg, traffic)
    numbers = judge.reference_numbers(ref, model, pool, ctrl, cod)
    bad = [torch.zeros(len(numbers), dtype=torch.bool)]
    return judge.verdict(bad, numbers, cfg["limits"], 0)


def flop_lines(workload: str, device="cuda") -> dict:
    """The reference's FLOPs of one pair's round trip and the program's
    ``device_flops`` per pair, at the cell's size."""
    import torch
    cfg, traffic, ref = cell(workload)
    s = traffic["size"]
    count = run.reference_flops(ref, ref.build(cfg, torch.device(device)), s)
    prog = cfg["program"]
    net = run.program_class(prog["model"])(
        **cfg["widths"], dtype=getattr(torch, cfg["dtype"]), device=device,
        seed=0)
    codec = run.coder(cfg).build(run.program_class(prog["codec"]), net, cfg,
                                 dict(traffic, batch=1))
    got = codec.device_flops(s, s)
    return {"reference_flops_per_pair": count,
            "program_flops_per_pair": got["flops_per_pair"],
            "program_per_program": got["per_program"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--flops", type=int, default=0)
    a = p.parse_args(argv)
    state = weights.state(cell(a.workload)[0], "cuda")
    for s in filter(None, a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=int(s),
                                  seconds=a.seconds, trace=0)
        out = run.run_cell(args, state=state)
        print(json.dumps({"side": "program", "seed": int(s),
                          "checks": out["checks"],
                          "readings": out["readings"],
                          "failed": out["failed"],
                          "metrics": out["metrics"]}), flush=True)
    for s in filter(None, a.control_seeds.split(",")):
        v = control_checks(a.workload, int(s), state=state)
        print(json.dumps({"side": "control", "seed": int(s),
                          "checks": v["checks"],
                          "readings": v["readings"]}), flush=True)
    if a.flops:
        print(json.dumps(flop_lines(a.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
