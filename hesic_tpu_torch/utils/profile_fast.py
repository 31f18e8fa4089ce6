"""Where the time goes in one codec round trip, or one training step, on
the card.

Usage (on a machine with a CUDA card):

    python -m hesic_tpu_torch.utils.profile_fast [--model hesic|hesic-plus
        |mbt --batch B --mm MM --homography identity|rotated
        --calib-steps S]
    python -m hesic_tpu_torch.utils.profile_fast --model train [--batch B]
    python -m hesic_tpu_torch.utils.profile_fast --model hesic-batch
        [--batch B --mm MM --homography identity|rotated]
    python -m hesic_tpu_torch.utils.profile_fast --model dsic-batch
        [--batch B --mm MM]
    python -m hesic_tpu_torch.utils.profile_fast --model mbt-host
        [--batch B --calib-steps S]

``--model hesic`` (the default) builds HESIC N=128/M=192/K=5 and traces
``HESICFastCodec.compress_fast`` + ``decompress_fast`` (batch 8, grid cap
mm 32 by default).  ``--model hesic-plus`` builds HESIC+ N=192/M=192 and
traces ``HESICPlusDeviceCodec.compress`` + ``decompress`` (batch 11,
mm 16, 8 channel groups, word cap 64 by default: bench.py's HESIC+
point).  ``--model mbt`` builds mbt2018 N=192/M=192 (float32) and traces
``JointAutoregressiveDeviceCodec.compress`` + ``decompress`` on the
first eyes (batch 11, mm 16, 8 groups: bench.py's ar-device point).
HESIC and HESIC+ use bf16 transforms; every model has seed 0 and is
calibrated as bench.py does for ``--calib-steps`` steps (default 60 for
mbt, 0 for the others: random weights; the images are then the next
draws of bench.py's generator, as its loop codes them).  The codec is
warmed up with one round trip on 512x512 images, times one untraced
round trip, then trace one with ``torch.profiler`` (CPU and CUDA
activities).  Prints the card, the encode and decode wall times, traced
and untraced (tracing adds host time to every launch), the device time
by kernel group (the port's kernels 1-5, cuDNN convolutions, other
PyTorch kernels), the device's busy and idle shares of the traced wall
time, the codec's host spans (HESIC's ``codec/...``, ``enc/...`` and
``dec/...``), and the ten longest kernels by name, then one JSON line with
the same numbers.  Kernel 5's
launches group as its hoisted product, its level kernel (the context
product and the MLP, one cluster launch a level) and its coder.  Device time is the sum of the kernels' own times
on the card (one stream, so kernels do not overlap).

``--model train`` builds HESIC N=128/M=192/K=5 with bf16 transforms (seed
0) under the codecs' determinism policy, and its train step (RD loss at
lambda 1e-2 plus the aux loss, Adam 1e-4 / 1e-3) on 512x512 smooth pairs
(batch 8 by default, identity H).  It runs two warm-up steps, times one
untraced step, then traces one.  The device time is split by the
operations that launched it: convolutions forward (cuDNN, deconvolutions
included) and backward, the warp's gather and its backward (a
scatter-add), the likelihoods' work (the bottlenecks' and mixtures'
forwards, inside their own ``likelihoods`` spans, and the backward of
every operation they ran, matched by autograd sequence number), the Adam
update, and the rest.

``--model hesic-batch`` profiles the port's bench loop
(``hesic_tpu_torch.bench``): HESIC N=128/M=192/K=5, bf16, calibrated as
bench.py does (60 steps), batch 64 and grid cap mm 16 by default, the
batch container.  After the bench's warm-up it fills the pipeline
(batch 0 encoded, batch 1 started), waits for the device, and times one
mode-2 iteration (decode of batch 0, start of batch 2, finish of batch
1, then a synchronize) untraced and then traced.  Prints the wall time,
the device's busy time (the union of its kernels and copies over every
stream) and idle share of the traced wall time, the kernel time of
kernels 1-3, softmax, cuDNN and the rest (memsets left out), the copies
by direction and host memory (pinned or pageable), the codec's host
spans (``codec/...``, ``enc/...``, ``dec/...``: models/hesic_fast.py's,
utils/tracing.py),
the host time in CUDA runtime calls (a launch that blocks on a full
queue, or a synchronize, shows there), and the longest kernels, then one
JSON line with the same numbers.

``--model dsic-batch`` does the same for bench.py's DSIC point: DSIC
N=128/M=192/F=21/C=32/K=5, bf16, calibrated (60 steps, no homography),
batch 32 and mm 16 by default.  Its kernels are grouped by the operation
that launched them: the 3-D branch (``Conv3D``: the folded band
convolution and its band weight), ``GroupNorm``, ``dense_warp`` and the
align-corners upsampling (the model's own ``dsic/...`` spans,
models/dsic.py), then by name: kernels 1-3, softmax, cuDNN 2-D
convolutions and the rest.  Before the trace it times, on cost volume
1's 3-D branch input at that batch (scale 8), the folded band
convolution against ``F.conv3d`` on the unfolded layout (CUDA events,
under the codec's determinism policy), and prints both.

``--model mbt-host`` profiles the bench's host AR point
(``hesic_tpu_torch.bench --model mbt``, bench.py's ar point): mbt2018
N=192/M=192 float32, seed 0, random weights unless ``--calib-steps``,
``JointAutoregressiveCodec`` on the first eyes of a batch of 8 smooth
512x512 pairs (bench.py's generator).  After one warm-up round trip it
times one untraced and traces one round trip (encode then decode).
Prints the wall time, the seconds inside the native coder (the thread
pool's wall time, encode and decode) against the rest, the device's busy
time (the sum of its kernels' times) and idle share of the traced wall
time, the kernel groups and the longest kernels, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..bench import card_line, rotated_homography
from ..training.recipe import (calibrate, calibrate_single, smooth_pairs,
                               train_batch, trainer)

SIZE = 512     # image side, pixels


_GROUPS = (("kernel 1 gmm_freq", ("gmm_freq_kernel",)),
           ("kernel 2 grid_rans_encode", ("grid_rans_encode_kernel",)),
           ("kernel 3 grid_rans_decode", ("grid_rans_decode_kernel",)),
           ("kernel 4 pairs_rans_encode", ("pairs_rans_encode_kernel",)),
           ("kernel 5 hoisted product", ("wavefront_hoist_kernel",)),
           ("kernel 5 level", ("wavefront_level_kernel",)),
           ("kernel 5 coder", ("wavefront_coder_kernel",)),
           ("cuDNN convolutions", ("conv", "cudnn", "xmma", "gemm",
                                   "fprop", "dgrad", "wgrad")))


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in _GROUPS:
        if any(k in low for k in keys):
            return label
    return "other PyTorch kernels"


def _codec(model: str, batch: int, mm: int, calib_steps: int, rng):
    """The model's codec at its published widths (seed 0; calibrated for
    `calib_steps` steps on `rng`'s draws) as a round trip fn(x1, x2, h) ->
    (encode dict, decode dict, per-eye outlier or escape counts)."""
    import torch
    if model == "hesic":
        from ..models.hesic import HESIC
        from ..models.hesic_fast import HESICFastCodec
        net = HESIC(N=128, M=192, K=5, dtype=torch.bfloat16, device="cuda",
                    seed=0)
    elif model == "mbt":
        from ..models.priors import JointAutoregressiveHierarchicalPriors
        net = JointAutoregressiveHierarchicalPriors(N=192, M=192,
                                                    device="cuda", seed=0)
    else:
        from ..models.hesic_plus import HESICPlus
        net = HESICPlus(N=192, M=192, dtype=torch.bfloat16, device="cuda",
                        seed=0)
    if calib_steps:
        cal = calibrate_single if net.single_image else calibrate
        cal(net, rng, calib_steps)
        net.requires_grad_(False)
    if model == "hesic":
        codec = HESICFastCodec(net, mm=mm, codec_batch=batch).update()

        def trip(x1, x2, h):
            out = codec.compress_fast(x1, x2, h)
            return out, codec.decompress_fast(out["blobs"]), out["outliers"]
    elif model == "mbt":
        from ..models.ar_device import JointAutoregressiveDeviceCodec
        codec = JointAutoregressiveDeviceCodec(net, mm=mm,
                                               groups=8).update()

        def trip(x1, x2, h):
            out = codec.compress(x1)
            return (out, codec.decompress(out["strings"]),
                    (out["escapes"], 0))
    else:
        from ..models.ar_device import HESICPlusDeviceCodec
        codec = HESICPlusDeviceCodec(net, mm=mm, groups=8, cap=64).update()

        def trip(x1, x2, h):
            out = codec.compress(x1, x2, h)
            return out, codec.decompress(out["strings"]), out["escapes"]
    return trip


def _kernels_of(evs):
    """The kernels (name, duration us) launched by profiler events and
    their children."""
    return [k for e in evs
            for k in list(e.kernels) + _kernels_of(e.cpu_children)]


def _top(kernels, n: int):
    """The `n` kernel names with the most device time: [(name, ms,
    launches)]."""
    by = {}
    for k in kernels:
        ms, c = by.get(k.name, (0.0, 0))
        by[k.name] = (ms + k.duration / 1e3, c + 1)
    return sorted(((name, ms, c) for name, (ms, c) in by.items()),
                  key=lambda t: -t[1])[:n]


def _step_breakdown(events) -> dict:
    """Kernels of one traced train step by the operations that launched
    them: {group: kernels}; "other kernels" holds the rest.  The
    likelihoods are the entropy models' own ``likelihoods`` spans."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA

    likes = [e for e in events if e.name == "likelihoods"]

    def inside(e):
        return any(r.thread == e.thread
                   and r.time_range.start <= e.time_range.start
                   and e.time_range.end <= r.time_range.end for r in likes)

    seqs = {e.sequence_nr for e in events
            if e.sequence_nr >= 0 and e.name != "likelihoods" and inside(e)}
    backward = [e for e in events
                if e.name.startswith("autograd::engine::evaluate_function")]
    groups = {
        "convolutions, forward": [e for e in events
                                  if e.name == "aten::convolution"],
        "convolutions, backward": [e for e in events
                                   if e.name == "aten::convolution_backward"],
        "warp gather, forward": [e for e in events
                                 if e.name == "aten::gather"],
        "warp scatter-add (gather backward)": [
            e for e in backward if e.name.endswith("GatherBackward0")],
        "likelihoods, forward": likes,
        "likelihoods, backward": [e for e in backward
                                  if e.sequence_nr in seqs],
        "Adam update": [e for e in events
                        if e.name.startswith("Optimizer.step#")],
    }
    out = {k: _kernels_of(v) for k, v in groups.items()}
    grouped = {id(k) for ks in out.values() for k in ks}
    kernels = _kernels_of(e for e in events if e.device_type != cuda
                          and e.cpu_parent is None)
    out["other kernels"] = [k for k in kernels if id(k) not in grouped]
    return out


def train_main(batch: int) -> int:
    """Profile one warm bf16 train step (see the module docstring)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models.base import deterministic_backends
    from ..models.hesic import HESIC

    if not torch.cuda.is_available():
        print("profile_fast: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    deterministic_backends()
    model = HESIC(N=128, M=192, K=5, dtype=torch.bfloat16, device="cuda",
                  seed=0)
    _, step, gen = trainer(model)
    data = train_batch(np.random.RandomState(0), batch, SIZE, "cuda")

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(data, gen)
        torch.cuda.synchronize()
        return metrics, (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        timed_step()
    _, plain_ms = timed_step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        metrics, wall_ms = timed_step()
    events = prof.events()
    # the device-side spans of profiler ranges (the likelihoods' hooks,
    # Optimizer.step) are not kernels: they cover the gaps between them
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    n_kernels = len(device)
    groups = _step_breakdown(events)

    print(f"card: {card}")
    print(f"train, HESIC N128/M192/K5 bf16, batch {batch} pairs "
          f"{SIZE}x{SIZE}, identity H: loss {float(metrics['loss']):.4f}, "
          f"step {plain_ms:.2f} ms wall untraced, {wall_ms:.2f} ms traced")
    if not n_kernels:
        print("device time: not measured (the profiler saw no CUDA "
              "kernels)")
        return 1
    sums = {label: (sum(k.duration for k in ks) / 1e3, len(ks))
            for label, ks in groups.items()}
    print(f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall: busy "
          f"share {busy_ms / wall_ms:.3f}, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; {n_kernels} kernels, "
          f"{sum(v[0] for v in sums.values()):.2f} ms of them attributed "
          f"to the operations that launched them")
    for label, (g_ms, n) in sums.items():
        print(f"  {label:<36s} {g_ms:9.3f} ms  {n:6d} launches  "
              f"{g_ms / busy_ms:6.1%} of device time")
        for name, k_ms, c in _top(groups[label], 3):
            print(f"      {k_ms:9.3f} ms  {c:5d}x  {name[:80]}")
    print(json.dumps({
        "card": card, "model": "train", "batch": batch, "size": SIZE,
        "step_ms": plain_ms, "traced_step_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": {k: v[0] for k, v in sums.items()},
        "launches": {k: v[1] for k, v in sums.items()}}))
    return 0


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _tally(labelled) -> dict:
    """{label: [ms, count]} over (label, profiler event) pairs."""
    out = {}
    for label, e in labelled:
        g = out.setdefault(label, [0.0, 0])
        g[0] += (e.time_range.end - e.time_range.start) / 1e3
        g[1] += 1
    return out


def _range_groups(events, ranges) -> dict:
    """{group: [ms, launches]} of the device kernels of a trace: those
    launched inside a span of `ranges` (the model's own ``dsic/...``
    spans) under its name less the prefix, the rest by kernel name (kernels 1-3, softmax, cuDNN convolutions, other).
    The port's own kernels are launched through ctypes, outside any
    PyTorch operation, so every kernel is first tallied by name from the
    device's events, and the ranges' kernels are then moved to their
    ranges.  Copies and memsets are left out."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA

    def by_name(name):
        return "softmax" if "softmax" in name.lower() else _group(name)

    def kernel(name):
        return not name.startswith(("Memcpy", "Memset"))

    out = {}

    def add(label, ms, n):
        g = out.setdefault(label, [0.0, 0])
        g[0] += ms
        g[1] += n

    for e in events:
        if (e.device_type == cuda and not e.is_user_annotation
                and kernel(e.name)):
            add(by_name(e.name),
                (e.time_range.end - e.time_range.start) / 1e3, 1)
    seen = set()
    for label in ranges:
        for k in _kernels_of(e for e in events if e.name == label):
            if id(k) in seen or not kernel(k.name):
                continue
            seen.add(id(k))
            add(by_name(k.name), -k.duration / 1e3, -1)
            add(label[len("dsic/"):], k.duration / 1e3, 1)
    return out


def _copy_kind(name: str) -> str:
    """'HtoD pinned', 'DtoH pageable', ... for a profiler copy event."""
    direction = next((d for d in ("HtoD", "DtoH", "DtoD") if d in name),
                     "other")
    memory = ("pageable" if "Pageable" in name
              else "pinned" if "Pinned" in name else "device")
    return f"{direction} {memory}"


# DSIC's spans (models/dsic.py), each a kernel group of its own
_DSIC_RANGES = ("dsic/3-D branch", "dsic/GroupNorm", "dsic/dense_warp",
                "dsic/upsampling")


def _fold_forms(model, batch: int) -> dict:
    """Cost volume 1's first Conv3D at `batch` (scale 8 of 512x512 pairs:
    (batch, C*F0, 256, 256) bf16 folded) as the folded band convolution
    and as F.conv3d on (batch, F0, C, 256, 256): ms each (CUDA events, 3
    calls after a warm-up), their max |d| and the FLOPs each does."""
    import torch
    import torch.nn.functional as F

    conv = model.cost_volume1.Conv3D_0
    o, i, k = conv.weight.shape[:3]
    c, hw = model.C, SIZE // 2
    gen = torch.Generator(device="cuda").manual_seed(4)
    x5 = torch.randn(batch, i, c, hw, hw, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    xf = x5.transpose(1, 2).reshape(batch, c * i, hw, hw)
    w5 = conv.weight.detach().to(torch.bfloat16)
    wf = conv.band_weight(c).detach().to(torch.bfloat16)
    forms = {"folded band conv2d": lambda: F.conv2d(xf, wf, padding=2),
             "conv3d": lambda: F.conv3d(x5, w5, padding=2)}
    out = {}
    for name, fn in forms.items():
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(3):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out[name] = t0.elapsed_time(t1) / 3
    d = (forms["folded band conv2d"]().reshape(batch, c, o, hw, hw)
         .transpose(1, 2).float() - forms["conv3d"]().float()).abs().max()
    pix = batch * hw * hw
    return {"ms": out, "max_abs_diff": float(d),
            "flop": {"folded band conv2d": 2 * pix * (c * o) * (c * i) * k * k,
                     "conv3d": 2 * pix * c * o * i * k ** 3}}


def batch_main(batch: int, mm: int, homography: str,
               arch: str = "hesic") -> int:
    """Profile one pipelined bench iteration (see the module docstring)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import bench
    from ..training.recipe import calibrate

    if not torch.cuda.is_available():
        print("profile_fast: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    args = bench.parse_args(["--model", arch])
    model = bench.build_model(args)
    rng = np.random.RandomState(0)
    calibrate(model, rng)
    codec = bench.make_codec(model, mm, batch)
    pool = bench.make_pool(rng, 3, batch, SIZE, "cuda")
    h = bench.homographies("real" if homography == "rotated"
                           else "identity", batch)
    forms, ranges = None, ()
    if arch == "dsic":
        forms = _fold_forms(model, batch)
        ranges = _DSIC_RANGES
    bench.warm_up(codec, pool, h)
    state = {"prev": codec.compress_fast_finish(
        codec.compress_fast_start(*pool[0], h))["blob"],
        "handle": codec.compress_fast_start(*pool[1], h), "next": 2}

    def iteration():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.decompress_fast_batch(state["prev"])
        nxt = codec.compress_fast_start(*pool[state["next"] % 3], h)
        out = codec.compress_fast_finish(state["handle"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        state.update(prev=out["blob"], handle=nxt, next=state["next"] + 1)
        return out, ms

    _, plain_ms = iteration()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall_ms = iteration()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events
              if e.device_type == cuda and not e.is_user_annotation]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in device]) / 1e3
    groups = _range_groups(events, ranges)
    copies = _tally((_copy_kind(e.name), e) for e in device
                    if e.name.startswith("Memcpy"))
    host_side = [e for e in events if e.device_type != cuda]
    host = _tally((e.name, e) for e in host_side
                  if e.name.startswith(("codec/", "enc/", "dec/")))
    runtime = _tally((e.name, e) for e in host_side
                     if e.name.startswith("cu")
                     and not e.name.startswith(("cudnn", "cublas")))
    by_name = _tally((e.name, e) for e in device)

    print(f"card: {card}")
    if forms:
        print(f"3-D branch forms, cost volume 1's first Conv3D at batch "
              f"{batch} (scale 8, 256x256, bf16, deterministic cuDNN): "
              + "; ".join(f"{k} {v:.3f} ms ({forms['flop'][k]:.3e} FLOP)"
                          for k, v in forms["ms"].items())
              + f"; max |d| {forms['max_abs_diff']:.3e}")
        homography = "identity (DSIC takes none)"
    print(f"{arch}-batch, batch {batch} pairs {SIZE}x{SIZE}, H {homography},"
          f" mm cap {mm}, calibrated: one pipelined iteration (decode, "
          f"start, finish) {plain_ms:.2f} ms wall untraced, {wall_ms:.2f} "
          f"ms traced; bpp_real {out['bpp_real']:.6f}, grids "
          f"{out['blob'][1]}/{out['blob'][2]}, outliers "
          f"{out['outliers'][0]}/{out['outliers'][1]}")
    if not device:
        print("device time: not measured (the profiler saw no CUDA "
              "activity)")
        return 1
    print(f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall (union "
          f"over streams): idle share {1 - busy_ms / wall_ms:.3f}")
    for title, table in (("kernels", groups), ("copies", copies),
                         ("host ranges", host)):
        print(f"{title}:")
        for label, (ms, n) in sorted(table.items(), key=lambda kv: -kv[1][0]):
            print(f"  {label:<28s} {ms:9.3f} ms  {n:6d}x")
    print("CUDA runtime calls (host time):")
    for name, (ms, n) in sorted(runtime.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"  {name:<28s} {ms:9.3f} ms  {n:6d}x")
    print("longest kernels:")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    print(json.dumps({
        "card": card, "model": f"{arch}-batch", "batch": batch,
        "size": SIZE, "homography": homography, "mm_cap": mm,
        "fold_forms_ms": forms and forms["ms"],
        "bpp_real": out["bpp_real"], "iteration_ms": plain_ms,
        "traced_iteration_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "kernels_ms": {k: v[0] for k, v in groups.items()},
        "launches": {k: v[1] for k, v in groups.items()},
        "copies_ms": {k: v[0] for k, v in copies.items()},
        "copies": {k: v[1] for k, v in copies.items()},
        "host_ms": {k: v[0] for k, v in host.items()},
        "runtime_ms": {k: v[0] for k, v in runtime.items()}}))
    return 0


def host_main(batch: int, calib_steps: int) -> int:
    """Profile one round trip of the host AR codec at the bench's mbt
    point (see the module docstring)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..models.autoregressive import host_threads
    from ..models.codec import JointAutoregressiveCodec
    from ..models.priors import JointAutoregressiveHierarchicalPriors

    if not torch.cuda.is_available():
        print("profile_fast: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    rng = np.random.RandomState(0)
    net = JointAutoregressiveHierarchicalPriors(N=192, M=192, device="cuda",
                                                seed=0)
    if calib_steps:
        calibrate_single(net, rng, calib_steps)
        net.requires_grad_(False)
    codec = JointAutoregressiveCodec(net).update()
    x, _ = smooth_pairs(rng, batch, SIZE)

    def trip():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = codec.compress(x)
        rec = codec.decompress(out["strings"], out["shape"])
        wall = time.perf_counter() - t0
        if not torch.equal(rec["y_hat"], out["y_hat"]):
            raise AssertionError("decoded y_hat differs from the encoder's")
        return out, rec, wall

    trip()
    _, _, plain_s = trip()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, rec, wall_s = trip()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.events()
              if e.device_type == cuda and not e.is_user_annotation]
    kernels = _tally((e.name, e) for e in device)
    groups = _tally((_group(e.name), e) for e in device)
    busy_ms = sum(ms for ms, _ in kernels.values())
    wall_ms = wall_s * 1e3
    coder_ms = (out["coder_s"] + rec["coder_s"]) * 1e3

    print(f"card: {card}")
    print(f"mbt-host, mbt2018 N192/M192 f32, batch {batch} images "
          f"{SIZE}x{SIZE}, {calib_steps} calibration steps, "
          f"{host_threads(batch)} coder threads (os.cpu_count() "
          f"{os.cpu_count()}): bpp_real {out['bpp_real']:.6f}; round trip "
          f"{plain_s * 1e3:.2f} ms wall untraced, {wall_ms:.2f} ms traced "
          f"(encode {out['enctime'] * 1e3:.2f}, decode "
          f"{rec['dectime'] * 1e3:.2f})")
    print(f"native coder {coder_ms:.2f} ms (encode "
          f"{out['coder_s'] * 1e3:.2f}, decode {rec['coder_s'] * 1e3:.2f}) "
          f"of {wall_ms:.2f} ms wall: coder share "
          f"{coder_ms / wall_ms:.3f}; the rest {wall_ms - coder_ms:.2f} ms")
    if not kernels:
        print("device time: not measured (the profiler saw no CUDA "
              "kernels)")
        return 1
    print(f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall: busy "
          f"share {busy_ms / wall_ms:.3f}, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:<28s} {ms:9.3f} ms  {n:6d} launches  "
              f"{ms / busy_ms:6.1%} of device time")
    print("longest kernels:")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    print(json.dumps({
        "card": card, "model": "mbt-host", "batch": batch, "size": SIZE,
        "calib_steps": calib_steps, "host_threads": host_threads(batch),
        "cpu_count": os.cpu_count(), "bpp_real": out["bpp_real"],
        "round_trip_ms": plain_s * 1e3, "traced_round_trip_ms": wall_ms,
        "coder_ms": coder_ms, "encode_coder_ms": out["coder_s"] * 1e3,
        "decode_coder_ms": rec["coder_s"] * 1e3,
        "rest_ms": wall_ms - coder_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": {k: v[0] for k, v in groups.items()},
        "launches": {k: v[1] for k, v in groups.items()}}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("hesic", "hesic-plus", "mbt",
                                       "train", "hesic-batch", "dsic-batch",
                                       "mbt-host"),
                   default="hesic")
    p.add_argument("--batch", type=int, default=None,
                   help="pairs per batch (default 8 for hesic, train and "
                        "mbt-host, 11 for hesic-plus and mbt, 64 for "
                        "hesic-batch, 32 for dsic-batch)")
    p.add_argument("--mm", type=int, default=None,
                   help="grid half-width cap (default 32 for hesic, 16 "
                        "for the others)")
    p.add_argument("--homography", choices=("identity", "rotated"),
                   default="identity")
    p.add_argument("--calib-steps", type=int, default=None,
                   help="calibration steps of hesic, hesic-plus, mbt and "
                        "mbt-host (default 60 for mbt, 0 for the others)")
    args = p.parse_args(argv)
    if args.model == "train":
        return train_main(args.batch or 8)
    if args.model == "hesic-batch":
        return batch_main(args.batch or 64, args.mm or 16, args.homography)
    if args.model == "dsic-batch":
        return batch_main(args.batch or 32, args.mm or 16, "identity",
                          "dsic")
    if args.model == "mbt-host":
        return host_main(args.batch or 8, args.calib_steps or 0)
    ar = args.model in ("hesic-plus", "mbt")
    b = args.batch or (11 if ar else 8)
    mm = args.mm or (16 if ar else 32)
    calib_steps = (args.calib_steps if args.calib_steps is not None
                   else 60 if args.model == "mbt" else 0)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_fast: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    rng = np.random.RandomState(0)
    trip = _codec(args.model, b, mm, calib_steps, rng)
    x1, x2 = smooth_pairs(rng, b, SIZE)
    hm = (np.eye(3, dtype=np.float32) if args.homography == "identity"
          else rotated_homography())
    h = np.tile(hm[None], (b, 1, 1))

    trip(x1, x2, h)
    torch.cuda.synchronize()
    # the same round trip untraced: tracing adds host time to every launch
    plain, plain_rec, _ = trip(x1, x2, h)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        out, rec, outliers = trip(x1, x2, h)
    wall_ms = (out["enctime"] + rec["dectime"]) * 1e3

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # the codec's spans also appear on the device as
    # user annotations spanning their kernels: they are not device work
    device = [e for e in events
              if e.device_type == cuda and not e.is_user_annotation]
    kernels = _tally((e.name, e) for e in device)
    groups = _tally((_group(e.name), e) for e in device)
    host = _tally((e.name, e) for e in events if e.device_type != cuda
                  and e.name.startswith(("codec/", "enc/", "dec/")))
    busy_ms = sum(ms for ms, _ in kernels.values())

    print(f"card: {card}")
    print(f"{args.model}, batch {b} {SIZE}x{SIZE}, H "
          f"{args.homography}, mm cap {mm}, {calib_steps} calibration "
          f"steps: bpp_real "
          f"{out['bpp_real']:.6f}, outliers/escapes "
          f"{outliers[0]}/{outliers[1]}, encode "
          f"{out['enctime'] * 1e3:.2f} ms, decode "
          f"{rec['dectime'] * 1e3:.2f} ms wall traced; untraced encode "
          f"{plain['enctime'] * 1e3:.2f} ms, decode "
          f"{plain_rec['dectime'] * 1e3:.2f} ms wall")
    if not kernels:
        print("device time: not measured (the profiler saw no CUDA "
              "kernels)")
        return 1
    print(f"device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall: busy "
          f"share {busy_ms / wall_ms:.3f}, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for label, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:<28s} {ms:9.3f} ms  {n:6d} launches  "
              f"{ms / busy_ms:6.1%} of device time")
    print("host ranges:")
    for label, (ms, n) in sorted(host.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:<28s} {ms:9.3f} ms  {n:6d}x")
    print("longest kernels:")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    print(json.dumps({
        "card": card, "model": args.model, "batch": b, "size": SIZE,
        "homography": args.homography, "mm_cap": mm,
        "calib_steps": calib_steps,
        "bpp_real": out["bpp_real"], "encode_ms": out["enctime"] * 1e3,
        "decode_ms": rec["dectime"] * 1e3,
        "untraced_encode_ms": plain["enctime"] * 1e3,
        "untraced_decode_ms": plain_rec["dectime"] * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": {k: v[0] for k, v in groups.items()},
        "launches": {k: v[1] for k, v in groups.items()},
        "host_ms": {k: v[0] for k, v in host.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
