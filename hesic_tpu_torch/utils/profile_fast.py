"""Where the time goes in one codec round trip on the card.

Usage (on a machine with a CUDA card):

    python -m hesic_tpu_torch.utils.profile_fast [--model hesic|hesic-plus
        --batch B --mm MM --homography identity|rotated]

``--model hesic`` (the default) builds HESIC N=128/M=192/K=5 and traces
``HESICFastCodec.compress_fast`` + ``decompress_fast`` (batch 8, grid cap
mm 32 by default).  ``--model hesic-plus`` builds HESIC+ N=192/M=192 and
traces ``HESICPlusDeviceCodec.compress`` + ``decompress`` (batch 11,
mm 16, 8 channel groups, word cap 64 by default: bench.py's HESIC+
point).  Both use bf16 transforms and random weights from seed 0, warm
the codec up with one round trip on 512x512 pairs, time one untraced
round trip, then trace one with ``torch.profiler`` (CPU and CUDA
activities).  Prints the card, the encode and decode wall times, traced
and untraced (tracing adds host time to every launch), the device time
by kernel group (the port's kernels 1-5, cuDNN convolutions, other
PyTorch kernels), the device's busy and idle shares of the traced wall
time, and the ten longest
kernels by name, then one JSON line with the same numbers.  Kernel 5's
launches group as its hoisted product, its context stage, its three MLP
stages and its coder.  Device time is the sum of the kernels' own times
on the card (one stream, so kernels do not overlap).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

SIZE = 512     # image side, pixels


def smooth_pairs(rng, batch: int, hw: int):
    """`batch` stereo pairs (B, hw, hw, 3) float32: a low-pass random field
    and a shifted copy as the second eye (the JAX bench's _smooth_pair)."""
    x1, x2 = [], []
    for _ in range(batch):
        base = (0.5 + 0.25 * rng.randn(hw // 16 + 2, hw // 16 + 2, 3)
                ).astype(np.float32)
        base = np.clip(base, 0, 1)
        base = np.repeat(np.repeat(base, 2, 0), 2, 1)
        idx = np.linspace(0, base.shape[0] - 1.001, hw)
        xi = idx.astype(np.int32)
        fi = (idx - xi).astype(np.float32)
        rows = (base[xi] * (1 - fi)[:, None, None]
                + base[xi + 1] * fi[:, None, None])
        up = (rows[:, xi] * (1 - fi)[None, :, None]
              + rows[:, xi + 1] * fi[None, :, None])
        x1.append(up)
        x2.append(np.roll(up, 3, axis=1) * 0.98 + 0.01)
    return (np.stack(x1).astype(np.float32),
            np.stack(x2).astype(np.float32))


def rotated_homography() -> np.ndarray:
    """A rig-like H: 1.5 degree rotation plus a (6, -4) pixel shift."""
    th = np.deg2rad(1.5)
    return np.array([[np.cos(th), -np.sin(th), 6.0],
                     [np.sin(th), np.cos(th), -4.0],
                     [0.0, 0.0, 1.0]], np.float32)


_GROUPS = (("kernel 1 gmm_freq", ("gmm_freq_kernel",)),
           ("kernel 2 grid_rans_encode", ("grid_rans_encode_kernel",)),
           ("kernel 3 grid_rans_decode", ("grid_rans_decode_kernel",)),
           ("kernel 4 pairs_rans_encode", ("pairs_rans_encode_kernel",)),
           ("kernel 5 hoisted product", ("wavefront_hoist_kernel",)),
           ("kernel 5 ctx", ("wavefront_ctx_kernel",)),
           ("kernel 5 MLP", ("wavefront_layer0_kernel",
                             "wavefront_layer1_kernel",
                             "wavefront_layer2_kernel")),
           ("kernel 5 coder", ("wavefront_coder_kernel",)),
           ("cuDNN convolutions", ("conv", "cudnn", "xmma", "gemm",
                                   "fprop", "dgrad", "wgrad")))


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in _GROUPS:
        if any(k in low for k in keys):
            return label
    return "other PyTorch kernels"


def _codec(model: str, batch: int, mm: int):
    """The model's codec at its published widths (bf16 transforms, seed
    0) as a round trip fn(x1, x2, h) -> (encode dict, decode dict,
    per-eye outlier or escape counts)."""
    import torch
    if model == "hesic":
        from ..models.hesic import HESIC
        from ..models.hesic_fast import HESICFastCodec
        net = HESIC(N=128, M=192, K=5, dtype=torch.bfloat16, device="cuda",
                    seed=0)
        codec = HESICFastCodec(net, mm=mm, codec_batch=batch).update()

        def trip(x1, x2, h):
            out = codec.compress_fast(x1, x2, h)
            return out, codec.decompress_fast(out["blobs"]), out["outliers"]
    else:
        from ..models.ar_device import HESICPlusDeviceCodec
        from ..models.hesic_plus import HESICPlus
        net = HESICPlus(N=192, M=192, dtype=torch.bfloat16, device="cuda",
                        seed=0)
        codec = HESICPlusDeviceCodec(net, mm=mm, groups=8, cap=64).update()

        def trip(x1, x2, h):
            out = codec.compress(x1, x2, h)
            return out, codec.decompress(out["strings"]), out["escapes"]
    return trip


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("hesic", "hesic-plus"),
                   default="hesic")
    p.add_argument("--batch", type=int, default=None,
                   help="pairs per batch (default 8 for hesic, 11 for "
                        "hesic-plus)")
    p.add_argument("--mm", type=int, default=None,
                   help="grid half-width cap (default 32 for hesic, 16 "
                        "for hesic-plus)")
    p.add_argument("--homography", choices=("identity", "rotated"),
                   default="identity")
    args = p.parse_args(argv)
    plus = args.model == "hesic-plus"
    b = args.batch or (11 if plus else 8)
    mm = args.mm or (16 if plus else 32)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_fast: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trip = _codec(args.model, b, mm)
    x1, x2 = smooth_pairs(np.random.RandomState(0), b, SIZE)
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

    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        ms, n = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (ms + t / 1e3, n + e.count)
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    busy_ms = sum(ms for ms, _ in kernels.values())

    print(f"card: {card}")
    print(f"{args.model}, batch {b} pairs {SIZE}x{SIZE}, H "
          f"{args.homography}, mm cap {mm}: bpp_real "
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
    print("longest kernels:")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    print(json.dumps({
        "card": card, "model": args.model, "batch": b, "size": SIZE,
        "homography": args.homography, "mm_cap": mm,
        "bpp_real": out["bpp_real"], "encode_ms": out["enctime"] * 1e3,
        "decode_ms": rec["dectime"] * 1e3,
        "untraced_encode_ms": plain["enctime"] * 1e3,
        "untraced_decode_ms": plain_rec["dectime"] * 1e3,
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": {k: v[0] for k, v in groups.items()},
        "launches": {k: v[1] for k, v in groups.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
