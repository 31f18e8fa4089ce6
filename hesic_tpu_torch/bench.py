"""End-to-end encode + decode throughput of a fast codec on the card: the
port's counterpart of bench.py's codec points, HESIC's (``main``) and
DSIC's (``bench_dsic``, ``BENCH_MODE=dsic``).

Usage (on a machine with a CUDA card):

    python -m hesic_tpu_torch.bench [--model hesic|dsic --size 512
        --batch B --batches N --calib-steps 60 --mm 16 --bf16 1
        --h identity|real --pipeline 2|0 --pool 4]

``--model hesic`` (the default) builds HESIC N=128/M=192/K=5 and codes
batches of 64 over 6 timed batches; ``--model dsic`` builds DSIC
N=128/M=192/F=21/C=32/K=5 and codes batches of 32 over 4 (bench.py's
DSIC point; DSIC takes no homography, so ``--h`` must stay identity,
which gives the containers of bench.py's H-less calls).
Either model has bf16 transforms and seed 0 and is calibrated as
bench.py does (``training.recipe.calibrate``: 60 steps at 256x256, batch
4), and its fast codec has grid cap ``--mm`` and ``codec_batch`` =
``--batch``.  A pool of ``--pool`` distinct batches of smooth pairs is
uploaded untimed and stays on the device.  Warm-up: every pool batch
through the synchronous batch encode and ``decompress_fast_batch``, then
one untimed pipelined epoch.  The pipelined re-encode of a batch must
equal its synchronous batch container byte for byte.  Then the timed
loop over ``--batches`` batches (the pool cycled): ``--pipeline 2``
dispatches, each iteration, decode(i-1), then ``compress_fast_start``
(i+1), then ``compress_fast_finish`` (i) (bench.py's thread-pool encode
of the DSIC point maps here too); ``--pipeline 0`` runs encode then
decode, batch after batch.  Outside the timed window every container of
the loop must have decoded to the encoder's latents.  ``--h real`` is
bench.py's ``BENCH_H=real`` homography (1.5 degree rotation, shift (6,
-4)).

Prints one JSON line: ``metric`` (stereo_pairs_per_sec_<size>px_encdec,
or dsic_pairs_per_sec_<size>px_encdec), ``value`` (pairs/s), ``unit``,
``model``, ``bpp_real`` (mean over the loop), ``batches``, ``batch``, ``h``,
``pipeline``, ``peak_memory_gib`` (``torch.cuda.max_memory_allocated``),
the grid widths and outlier counts of the loop's containers, and
``card`` (name and power limit).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .models.dsic import DSIC
from .models.dsic_fast import DSICFastCodec
from .models.hesic import HESIC
from .models.hesic_fast import HESICFastCodec
from .training.recipe import calibrate, smooth_pairs

# per model: (metric prefix, batch, timed batches), bench.py's points
POINTS = {"hesic": ("stereo", 64, 6), "dsic": ("dsic", 32, 4)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=tuple(POINTS), default="hesic")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=None,
                   help="pairs per batch (default 64 for hesic, 32 for "
                        "dsic)")
    p.add_argument("--batches", type=int, default=None,
                   help="timed batches (default 6 for hesic, 4 for dsic)")
    p.add_argument("--calib-steps", type=int, default=60)
    p.add_argument("--mm", type=int, default=16)
    p.add_argument("--bf16", type=int, choices=(0, 1), default=1)
    p.add_argument("--h", choices=("identity", "real"), default="identity")
    p.add_argument("--pipeline", type=int, choices=(0, 2), default=2)
    p.add_argument("--pool", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for a rehearsal")
    args = p.parse_args(argv)
    _, batch, batches = POINTS[args.model]
    args.batch = args.batch or batch
    args.batches = args.batches or batches
    if args.model == "dsic" and args.h != "identity":
        p.error("DSIC takes no homography: --h must be identity")
    return args


def build_model(args):
    """The model of `args` at its published widths (bf16 transforms unless
    --bf16 0, seed 0) on args.device."""
    dtype = torch.bfloat16 if args.bf16 else None
    if args.model == "dsic":
        return DSIC(N=128, M=192, F=21, C=32, K=5, dtype=dtype,
                    device=args.device, seed=0)
    return HESIC(N=128, M=192, K=5, dtype=dtype, device=args.device, seed=0)


def make_codec(model, mm: int, codec_batch: int):
    """The fast codec of `model` (HESIC or DSIC), tables built."""
    cls = DSICFastCodec if isinstance(model, DSIC) else HESICFastCodec
    return cls(model, mm=mm, codec_batch=codec_batch).update()


def rotated_homography() -> np.ndarray:
    """bench.py's real H (``BENCH_H=real``), rig-like: a 1.5 degree
    rotation plus a (6, -4) pixel shift."""
    th = np.deg2rad(1.5)
    return np.array([[np.cos(th), -np.sin(th), 6.0],
                     [np.sin(th), np.cos(th), -4.0],
                     [0.0, 0.0, 1.0]], np.float32)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def homographies(kind: str, batch: int) -> np.ndarray:
    """(batch, 3, 3) float32: the identity, or bench.py's real H."""
    hm = (rotated_homography() if kind == "real"
          else np.eye(3, dtype=np.float32))
    return np.tile(hm[None], (batch, 1, 1))


def make_pool(rng, n: int, batch: int, size: int, device) -> list:
    """`n` distinct batches of smooth pairs, (x1, x2) NHWC float32 tensors
    on `device`."""
    return [tuple(torch.from_numpy(a).to(device)
                  for a in smooth_pairs(rng, batch, size))
            for _ in range(n)]


def _sync(codec):
    if codec.device.type == "cuda":
        torch.cuda.synchronize(codec.device)


def warm_up(codec, pool, h) -> None:
    """Every pool batch through the synchronous batch encode and the batch
    decode, then one pipelined epoch over the pool."""
    for x1, x2 in pool:
        out = codec.compress_fast(x1, x2, h, batch_container=True)
        codec.decompress_fast_batch(out["blob"])
    for x1, x2 in pool:
        codec.compress_fast_finish(codec.compress_fast_start(x1, x2, h))
    _sync(codec)


def check_pipelined_bytes(codec, x1, x2, h) -> None:
    """The synchronous batch encode picks the grids the next pipelined
    start uses, so the pipelined re-encode of the same batch must give
    the same container, byte for byte."""
    ref = codec.compress_fast(x1, x2, h, batch_container=True)
    again = codec.compress_fast_finish(codec.compress_fast_start(x1, x2, h))
    if again["blob"] != ref["blob"]:
        raise AssertionError("the pipelined encode diverged from the "
                             "synchronous batch container")
    codec.decompress_fast_batch(ref["blob"])
    _sync(codec)


def timed_loop(codec, batches, h, pipeline: int) -> dict:
    """The timed loop over `batches` [(x1, x2)]: mode 2 dispatches
    decode(i-1), start(i+1), finish(i) each iteration; mode 0 encodes then
    decodes each batch.  Returns {"seconds", "containers", "decoded":
    per batch (y1_hat, y2_hat), "last": the last decode}."""
    blobs, decoded = [], []
    n = len(batches)
    _sync(codec)
    t0 = time.perf_counter()
    if pipeline == 2:
        handle = codec.compress_fast_start(*batches[0], h)
        prev = None
        for i in range(n):
            if prev is not None:
                rec = codec.decompress_fast_batch(prev)
                decoded.append((rec["y1_hat"], rec["y2_hat"]))
            nxt = (codec.compress_fast_start(*batches[i + 1], h)
                   if i + 1 < n else None)
            out = codec.compress_fast_finish(handle)
            blobs.append(out)
            handle, prev = nxt, out["blob"]
        rec = codec.decompress_fast_batch(prev)
        decoded.append((rec["y1_hat"], rec["y2_hat"]))
    else:
        for x1, x2 in batches:
            out = codec.compress_fast(x1, x2, h, batch_container=True)
            blobs.append(out)
            rec = codec.decompress_fast_batch(out["blob"])
            decoded.append((rec["y1_hat"], rec["y2_hat"]))
    _sync(codec)
    return {"seconds": time.perf_counter() - t0, "containers": blobs,
            "decoded": decoded, "last": rec}


def check_exact(codec, batches, h, loop) -> None:
    """Raise unless every container of the loop decoded to its encoder's
    own quantized latents, and the last decode is finite and of the
    input's shape."""
    for i, ((x1, x2), out, (y1, y2)) in enumerate(zip(
            batches, loop["containers"], loop["decoded"])):
        hd, _ = codec._homographies(h, x1.shape[0])
        enc = codec.transforms_enc(codec._to_device(x1),
                                   codec._to_device(x2), hd, out["blob"][3])
        for key, got, want in (("y1_hat", y1, enc[0]), ("y2_hat", y2,
                                                         enc[1])):
            want = want.permute(0, 2, 3, 1).float()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"timed batch {i}: decoded {key} "
                                     f"differs from the encoder's latents "
                                     f"at {bad} cells")
    for key in ("x1_hat", "x2_hat"):
        x = loop["last"][key]
        if tuple(x.shape) != tuple(batches[-1][0].shape):
            raise AssertionError(f"{key} shape {tuple(x.shape)}")
        if not torch.isfinite(x).all():
            raise AssertionError(f"{key} not finite")


def run(codec, pool, h, n_batches: int, pipeline: int = 2) -> dict:
    """Warm-up, the byte-identity check, the timed loop over `n_batches`
    batches (the pool cycled) and the exactness check.  Returns the loop's
    numbers."""
    batches = [pool[i % len(pool)] for i in range(n_batches)]
    warm_up(codec, pool, h)
    check_pipelined_bytes(codec, *pool[0], h)
    loop = timed_loop(codec, batches, h, pipeline)
    check_exact(codec, batches, h, loop)
    outs = loop["containers"]
    batch = pool[0][0].shape[0]
    return {
        "pairs_per_sec": n_batches * batch / loop["seconds"],
        "seconds": loop["seconds"],
        "bpp_real": float(np.mean([o["bpp_real"] for o in outs])),
        "mm": [list(o["blob"][1:3]) for o in outs],
        "outliers": [list(o["outliers"]) for o in outs],
    }


def bench(model, args, calib_hw: int = 256) -> dict:
    """Calibrate `model`, build the codec and the pool, and run the bench
    point of `args` (parse_args).  Returns run()'s numbers."""
    rng = np.random.RandomState(0)
    if args.calib_steps > 0:
        calibrate(model, rng, args.calib_steps, hw=calib_hw)
    codec = make_codec(model, args.mm, args.batch)
    pool = make_pool(rng, min(args.batches, args.pool), args.batch,
                     args.size, codec.device)
    return run(codec, pool, homographies(args.h, args.batch), args.batches,
               args.pipeline)


def main(argv=None) -> int:
    args = parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("bench: no CUDA device; run with --device cpu for a "
              "rehearsal", file=sys.stderr)
        return 1
    model = build_model(args)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = bench(model, args)
    print(json.dumps({
        "metric": f"{POINTS[args.model][0]}_pairs_per_sec_{args.size}px_"
                  f"encdec",
        "value": res["pairs_per_sec"],
        "unit": "pairs/s/chip",
        "model": args.model,
        "bpp_real": res["bpp_real"],
        "batches": args.batches,
        "batch": args.batch,
        "h": args.h,
        "pipeline": args.pipeline,
        "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                            if cuda else None),
        "mm": res["mm"],
        "outliers": res["outliers"],
        "card": card_line() if cuda else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
