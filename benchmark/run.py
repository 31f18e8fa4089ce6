"""The benchmark of hesic_tpu_torch: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``benchmark/configs/<config>.json``: the program's model
and codec classes, widths, dtype, the codec's grid cap, the calibration
recipe, the limits of the check and, optionally, its coder), its traffic
(``benchmark/traffic/<mix>.json``: the loop, batch, pool and image
parameters), the loop (``benchmark/loops/<loop>.py``), the plain
reference (``benchmark/reference/<config>.py``), the coder
(``benchmark/coders/<coder>.py``, ``grid`` where the configuration names
none) and each per-layer metric (``benchmark/metrics/<metric>.py``).

The coder holds all that the benchmark knows of a codec's container and
entropy coder (``benchmark/coders/__init__.py`` states its hooks): how
the codec is built, what its encoder coded for a kept decode, how the
reference's latents are quantised, the code lengths the container states
and those its coder gives the decoded latents under the reference's
conditioning, the same for the fp8 control, and the coder work the
rooflines read.  A configuration on another container brings its own
coder as a new file.

A run: the benchmark's own inputs first, timed apart (the weights, drawn
from the configuration's ``weights_seed`` and calibrated by the
reference in a checkout's first run of the configuration only, then kept
in ``benchmark/_cache/``; and the pool of pairs, made on the device from
``--seed``); then the program's set-up (``setup_s``: import, model build
and weight load, ``update()``, warm-up of every shape the window uses,
and in a checkout's first run the kernels' build); the window of
``--seconds``;
the check of what the window produced (``benchmark/judge.py``, under the
reference's own backend settings; the program runs under its own); with
``--trace 1`` a stretch of the window under torch.profiler and the
per-layer metrics.  The last line of standard output is one JSON object;
the compared numbers and their limits are the last lines of standard
error and the result's last key.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), and 3 when jax, jaxlib, flax or hesic_tpu is loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hesic_tpu")
STREAM_TRAFFIC, STREAM_SAMPLE = 3, 4


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def read_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def load_file(rel: str):
    """A module of the benchmark's folder by its path (names may hold
    '-' and '.')."""
    path = os.path.join(ROOT, rel)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no file {rel}")
    name = "benchmark._by_name." + rel.replace("/", "__").replace(
        "-", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def program_class(spec: str):
    """'package.module:Class' of the program."""
    module, cls = spec.split(":")
    return getattr(importlib.import_module(module), cls)


def coder(cfg: dict):
    """The configuration's coder module (``benchmark/coders/``)."""
    return load_file(f"benchmark/coders/{cfg.get('coder', 'grid')}.py")


def cell(name: str) -> dict:
    """The cell's entries: {"bench", "workload", "config", "traffic"}."""
    bench = read_json("BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {"bench": bench, "workload": wl, "config": read_json(conf["file"]),
            "traffic": read_json(f"benchmark/traffic/{wl['traffic']}.json")}


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (default: sys.modules) that the
    benchmark must not load, compared whole (hesic_tpu_torch is not
    hesic_tpu)."""
    tops = {n.split(".")[0] for n in list(names or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def metrics_of(bench: dict, key: str, workload: str) -> list:
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def make_pool(traffic: dict, seed: int, device) -> list:
    """The traffic's pool: `pool` distinct batches of `batch` pairs, NHWC
    float32 on the device, with their homographies on the host."""
    from benchmark import pairs
    gen = pairs.generator(seed, STREAM_TRAFFIC, device)
    out = []
    for _ in range(traffic["pool"]):
        x1, x2, h = pairs.make_pairs(traffic["batch"], traffic["size"],
                                     traffic["images"], gen, device)
        out.append({"x1": x1.permute(0, 2, 3, 1).contiguous(),
                    "x2": x2.permute(0, 2, 3, 1).contiguous(),
                    "h": h.cpu().numpy()})
    return out


def kept_indices(traffic: dict, seed: int) -> set:
    """The window's iterations whose decodes the check judges, drawn from
    the seed: `check` of the first `check_from` ones, on as many distinct
    batches of the pool; a draw that falls twice on one pool batch is
    drawn again from the same stream."""
    import numpy as np
    if traffic["check"] > traffic["pool"]:
        raise ValueError("the check draws more batches than the pool has")
    rng = np.random.default_rng([int(seed), STREAM_SAMPLE])
    while True:
        draw = {int(i) for i in rng.choice(traffic["check_from"],
                                           traffic["check"], replace=False)}
        if len({i % traffic["pool"] for i in draw}) == len(draw):
            return draw


def reference_flops(ref, model, size: int) -> float:
    """FlopCounterMode's count of the reference's programs of one pair's
    encode and decode (``round_trip``) at size x size."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    dev = next(model.parameters()).device
    one = torch.zeros((1, 3, size, size), device=dev)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.round_trip(model, one, one, torch.eye(3, device=dev)[None])
    return float(fc.get_total_flops())


def run_cell(args, device: str = "cuda", check_chip: bool = True,
             override: dict = None, state: dict = None) -> dict:
    """One run of a cell; returns the result's JSON object (checks last).
    `check_chip` False skips the look for a card, and `override`
    ({"config": {...}, "traffic": {...}}, merged key by key) shrinks the
    cell: the CPU tests.  `state`: the configuration's weights when the
    caller has them already (``weights.state``)."""
    import torch

    from benchmark import judge, profiling, weights

    c = cell(args.workload)
    for key, extra in (override or {}).items():
        c[key] = dict(c[key], **extra)
    bench, wl, cfg, traffic = (c["bench"], c["workload"], c["config"],
                               c["traffic"])
    if check_chip and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < wl["chips"]):
        log(f"no CUDA card for {wl['name']} (it needs {wl['chips']})")
        raise SystemExit(2)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ---- the benchmark's inputs (timed apart) ----
    t = time.perf_counter()
    ref = load_file(f"benchmark/reference/{cfg['name']}.py")
    cod = coder(cfg)
    if state is None:
        state = weights.state(cfg, dev)
    pool = make_pool(traffic, args.seed, dev)
    sync()
    log(f"inputs_s {time.perf_counter() - t:.3f} (weights and a pool of "
        f"{len(pool)} x {traffic['batch']} pairs)")

    # ---- the program's set-up ----
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    prog = cfg["program"]
    model = program_class(prog["model"])(
        **cfg["widths"], dtype=getattr(torch, cfg["dtype"]), device=device,
        seed=0)
    model.load_state_dict(state)
    model.requires_grad_(False)
    codec = cod.build(program_class(prog["codec"]), model, cfg, traffic)
    loop = load_file(f"benchmark/loops/{traffic['loop']}.py")
    loop.warm_up(codec, pool, sync)
    setup_s = time.perf_counter() - t
    log(f"setup_s {setup_s:.3f}")

    # ---- the window ----
    keep = kept_indices(traffic, args.seed)
    res = loop.window(codec, pool, args.seconds, keep,
                      traffic["trace_iterations"] if args.trace else 0, sync)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    pixels = 2 * traffic["size"] ** 2
    e2e = dict(res["metrics"], setup_s=setup_s,
               bpp=res["bits"] / (res["pairs"] * pixels),
               peak_mem_gib=peak / 2 ** 30)
    log(f"window {res['seconds']:.3f} s, {res['pairs']} pairs: "
        + ", ".join(f"{k} {v}" for k, v in e2e.items()))

    # ---- the check: exactness by the program, then the reference ----
    t = time.perf_counter()
    bad, zs = judge.encoder_side(cod, codec, pool, res["kept"])
    decoded = judge.program_outputs(cod, res["kept"], cfg, zs)
    del codec, model, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rmodel = ref.build(cfg, dev)
    rmodel.load_state_dict(state)
    rmodel.requires_grad_(False)
    numbers = judge.reference_numbers(ref, rmodel, pool, decoded, cod)
    unjudged = (len(keep) - len(res["kept"])) * traffic["batch"]
    v = judge.verdict(bad, numbers, cfg["limits"], unjudged)
    log(f"check_s {time.perf_counter() - t:.3f} ({v['pairs_checked']} "
        f"pairs)")

    out = {"correct": v["correct"], "attempted": res["pairs"],
           "failed": v["failed"]}
    wanted = metrics_of(bench, "per_layer" if args.trace else "end_to_end",
                        wl["name"])
    values = {}
    if args.trace:
        ctx = {"trace": res["trace"], "traced_pairs": res["traced_pairs"],
               "flops_per_pair": reference_flops(ref, rmodel,
                                                 traffic["size"]),
               "coder": cod.work(ref, rmodel, pool, res["programs"], cfg)}
        log(f"reference FLOPs a pair {ctx['flops_per_pair']:.6e}")
        for m in wanted:
            val = load_file(f"benchmark/metrics/{m['name']}.py").read(ctx)
            if val is not None:
                values[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in wanted:
            values[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out["metrics"] = values
    out["device"] = {"platform": "gpu" if cuda else device,
                     "kind": (torch.cuda.get_device_name(dev) if cuda
                              else device),
                     "count": 1, "memory_peak_bytes": int(peak)}
    if args.trace:
        tr = res["trace"]
        out["device"]["busy_s"] = profiling.busy_us(tr) / 1e6
        out["device"]["window_s"] = (tr["window"][1] - tr["window"][0]) / 1e6
        out["breakdown"] = profiling.breakdown(tr)
    out["readings"] = v["readings"]      # numbers no limit compares
    out["checks"] = v["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = run_cell(args)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process, and forbidden: {', '.join(found)}")
        return 3
    for name, chk in out["checks"].items():
        log(f"check {name} {chk['value']} limit {chk['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
