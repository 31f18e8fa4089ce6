"""End-to-end encode + decode throughput of a codec on the card: the
port's counterpart of bench.py's codec points, HESIC's (``main``),
DSIC's (``bench_dsic``, ``BENCH_MODE=dsic``), mbt2018's wavefront device
codec (``bench_ar_device``, ``BENCH_MODE=ar-device``), HESIC+'s
(``bench_hesic_plus_device``, ``BENCH_MODE=hesic-plus-device``) and
mbt2018's host AR codec (``bench_ar``, ``BENCH_MODE=ar``), and of its
train point (``bench_train``, ``BENCH_MODE=train``).

Usage (on a machine with a CUDA card):

    python -m hesic_tpu_torch.bench [--model hesic|dsic|mbt-device|
        hesic-plus-device|mbt|train --size 512 --batch B --batches N
        --calib-steps 60 --mm 16 --groups 8 --bf16 0|1
        --h identity|real --pipeline 2|1|0 --pool P --steps 12
        --peak-tflops 989.4]

The fast codecs.  ``--model hesic`` (the default) builds HESIC
N=128/M=192/K=5 and codes batches of 64 over 6 timed batches; ``--model
dsic`` builds DSIC N=128/M=192/F=21/C=32/K=5 and codes batches of 32 over
4 (bench.py's DSIC point; DSIC takes no homography, so ``--h`` must stay
identity, which gives the containers of bench.py's H-less calls).
Either model has bf16 transforms and seed 0 and is calibrated as
bench.py does (``training.recipe.calibrate``: 60 steps at 256x256, batch
4), and its fast codec has grid cap ``--mm`` and ``codec_batch`` =
``--batch``.  A pool of ``--pool`` (4) distinct batches of smooth pairs
is uploaded untimed and stays on the device.  Warm-up: every pool batch
through the synchronous batch encode and ``decompress_fast_batch``, then
one untimed pipelined epoch.  The pipelined re-encode of a batch must
equal its synchronous batch container byte for byte.  Then the timed
loop over ``--batches`` batches (the pool cycled): ``--pipeline 2``
dispatches, each iteration, decode(i-1), then ``compress_fast_start``
(i+1), then ``compress_fast_finish`` (i) (bench.py's thread-pool encode
of the DSIC point maps here too); ``--pipeline 0`` runs encode then
decode, batch after batch.  ``--h real`` is bench.py's ``BENCH_H=real``
homography (1.5 degree rotation, shift (6, -4)).

The wavefront device codecs.  ``--model mbt-device`` builds mbt2018
N=192/M=192 (float32) and ``--model hesic-plus-device`` HESIC+
N=192/M=192 (bf16 transforms), both seed 0, calibrated as bench.py does
(``calibrate_single`` for mbt2018, ``calibrate`` for HESIC+), coded by
their wavefront device codecs at mm 16, 8 channel groups (HESIC+'s
with bench.py's cap 64, which reaches no container), in
batches of 11 over 4 timed batches of one pool batch (``--pool`` 1, the
images bench.py draws after its calibration).  Warm-up: every pool
batch round trip, whose decoded latents must equal the encoder's; then
one encode on a worker thread while the main thread decodes must give
the synchronous container byte for byte.  The timed loop is bench.py's:
``--pipeline 1`` encodes batch i+1 on one worker thread while the main
thread decodes batch i; ``--pipeline 0`` encodes, then decodes.

The host AR codec.  ``--model mbt`` builds mbt2018 N=192/M=192
(float32, seed 0) with random weights, as bench.py's ar point has them
(``--calib-steps`` calibrates it when given), and codes the first eyes
of one batch of 8 smooth pairs through ``JointAutoregressiveCodec``
(models/codec.py: the transforms on the card, the raster-causal
recursion in the native host coder, one thread an image): one untimed
round trip, then 2 timed batches of encode then decode (``--pipeline``
0, bench.py's loop).  Every round trip must decode to the encoder's
y_hat (tolerance 0).

Outside the timed window every container of the loop must have decoded
to the encoder's latents, or the run raises.  Prints one JSON line:
``metric`` (stereo_pairs_per_sec_<size>px_encdec,
dsic_pairs_per_sec_<size>px_encdec,
mbt2018_device_images_per_sec_<size>px_encdec,
hesic_plus_device_pairs_per_sec_<size>px_encdec or
mbt2018_images_per_sec_<size>px_encdec), ``value`` (pairs or images a
second), ``unit``, ``model``, ``bpp_real`` (mean over the loop; the host
codec's counts its y and z strings' bytes), ``batches``, ``batch``,
``h``, ``pipeline``, ``peak_memory_gib``
(``torch.cuda.max_memory_allocated``), the fast codecs' grid widths and
outlier counts, the device codecs' grid, groups and escape counts, or
the host codec's ``host_threads`` (the coder pool's width),
``cpu_count`` (``os.cpu_count()``) and seconds in the native coder, and
``card`` (name and power limit).

The MFU fields.  ``--model hesic``, ``dsic`` and ``hesic-plus-device``
add, after the timed loop and outside it, the codec's ``device_flops``
at the point's shapes (HESIC's at the warp windows the bench's H picks,
as bench.py): ``flops_per_pair`` and ``flops_per_program``, PyTorch's
count of matmuls and convolutions (``flops_counter``: torch
FlopCounterMode, not XLA's cost analysis; kernels 1-5 are not counted,
as XLA did not count the Pallas kernels), ``tflops_per_sec`` (flops a
pair times pairs/s) and ``mfu_pct_bf16``, its share of ``peak_tflops``
(``--peak-tflops``, default 989.4: the H100 SXM5's dense bf16 Tensor
Core rate, half the data sheet's 1,979 with sparsity).  A count that
fails raises, and so does a share above 100%.  On the CPU (a rehearsal)
the rate and the share are null: they are the card's.  mbt2018's points
have no MFU field, as bench.py's have none.

The train point.  ``--model train`` builds HESIC N=128/M=192/K=5 (seed
0) at ``--size`` 512 and trains it on ``--batch`` 8 smooth pairs
(``training.recipe.train_batch(RandomState(0), ...)``, identity H) with
``training.recipe.trainer`` (Adam 1e-4 / aux 1e-3, lambda 1e-2, noise
seeded 7), first in float32, then with bf16 transforms: one untimed
warm-up step, whose FLOPs FlopCounterMode counts (the forward's and the
backward's matmuls and convolutions; Adam's elementwise update is not
counted), then ``--steps`` 12 timed steps.  A non-finite loss raises.
Prints bench.py's keys: ``metric`` (hesic_train_pairs_per_sec_<size>px_
bf16), ``value`` (bf16 pairs/s), ``unit``, ``vs_baseline`` (the bf16 /
f32 step rate), ``batch``, ``bf16`` and ``f32`` (each ``steps_per_sec``,
``pairs_per_sec``, ``tflops_per_sec``, ``mfu_pct_bf16``,
``flops_per_step``), ``bf16_speedup``, then ``peak_memory_gib``,
``flops_counter``, ``flops_scope``, ``peak_tflops``, ``backends`` (the
cuDNN and matmul flags the steps ran under: PyTorch's defaults in a
process of its own) and ``card``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .geometry import pick_warp_win, pick_warp_xwin
from .models.ar_device import (HESICPlusDeviceCodec,
                               JointAutoregressiveDeviceCodec)
from .models.autoregressive import host_threads
from .models.base import counted_flops
from .models.codec import JointAutoregressiveCodec
from .models.dsic import DSIC
from .models.dsic_fast import DSICFastCodec
from .models.hesic import HESIC
from .models.hesic_fast import HESICFastCodec
from .models.hesic_plus import HESICPlus
from .models.priors import JointAutoregressiveHierarchicalPriors
from .training.recipe import (calibrate, calibrate_single, smooth_pairs,
                              train_batch, trainer)

# per model: (metric prefix, what a batch item is, batch, timed batches,
# pipelined mode, pool), bench.py's points; the train point times steps
POINTS = {"hesic": ("stereo", "pairs", 64, 6, 2, 4),
          "dsic": ("dsic", "pairs", 32, 4, 2, 4),
          "mbt-device": ("mbt2018_device", "images", 11, 4, 1, 1),
          "hesic-plus-device": ("hesic_plus_device", "pairs", 11, 4, 1, 1),
          "mbt": ("mbt2018", "images", 8, 2, 0, 1),
          "train": ("hesic_train", "pairs", 8, 1, 0, 1)}
# the wavefront device codecs' points
DEVICE_POINTS = ("mbt-device", "hesic-plus-device")
# mbt2018's points
MBT_POINTS = ("mbt-device", "mbt")
# the points with MFU fields (bench.py's _mfu_fields)
MFU_POINTS = ("hesic", "dsic", "hesic-plus-device")
FLOPS_COUNTER = "torch FlopCounterMode"
# the H100 SXM5's dense bf16 Tensor Core TFLOP/s (NVIDIA's data sheet
# gives 1,979 with sparsity)
PEAK_TFLOPS = 989.4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=tuple(POINTS), default="hesic")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=None,
                   help="pairs or images per batch (default 64 for "
                        "hesic, 32 for dsic, 11 for the device codecs, 8 "
                        "for mbt)")
    p.add_argument("--batches", type=int, default=None,
                   help="timed batches (default 6 for hesic, 2 for mbt, "
                        "4 for the others)")
    p.add_argument("--calib-steps", type=int, default=None,
                   help="calibration steps (default 60; 0 for mbt)")
    p.add_argument("--mm", type=int, default=16)
    p.add_argument("--groups", type=int, default=8,
                   help="channel groups of the device codecs")
    p.add_argument("--bf16", type=int, choices=(0, 1), default=None,
                   help="bf16 transforms (default 1; mbt2018 is float32)")
    p.add_argument("--h", choices=("identity", "real"), default="identity")
    p.add_argument("--pipeline", type=int, choices=(0, 1, 2), default=None,
                   help="2 (fast codecs) or 1 (device codecs) pipelined, "
                        "0 encode then decode (the only mode of mbt)")
    p.add_argument("--pool", type=int, default=None,
                   help="distinct batches cycled (default 4, 1 for the "
                        "device codecs)")
    p.add_argument("--steps", type=int, default=12,
                   help="timed steps of the train point")
    p.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS,
                   help="the card's peak TFLOP/s the MFU share is of "
                        "(default: the H100 SXM5's dense bf16 rate)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for a rehearsal")
    args = p.parse_args(argv)
    _, _, batch, batches, mode, pool = POINTS[args.model]
    args.batch = args.batch or batch
    args.batches = args.batches or batches
    args.pool = args.pool or pool
    args.pipeline = mode if args.pipeline is None else args.pipeline
    if args.pipeline not in (0, mode):
        p.error(f"--model {args.model} runs --pipeline {mode} or 0")
    if args.calib_steps is None:
        # bench.py's ar point codes with random weights
        args.calib_steps = 0 if args.model == "mbt" else 60
    mbt = args.model in MBT_POINTS
    if args.bf16 is None:
        args.bf16 = 0 if mbt else 1
    if mbt and args.bf16:
        p.error("mbt2018 is float32: --bf16 must be 0")
    if (args.model in ("dsic", "train") or mbt) and args.h != "identity":
        p.error(f"{args.model} takes no homography: --h must be identity")
    return args


def build_model(args):
    """The model of `args` at its published widths (bf16 transforms unless
    --bf16 0, seed 0) on args.device."""
    dtype = torch.bfloat16 if args.bf16 else None
    if args.model == "dsic":
        return DSIC(N=128, M=192, F=21, C=32, K=5, dtype=dtype,
                    device=args.device, seed=0)
    if args.model in MBT_POINTS:
        return JointAutoregressiveHierarchicalPriors(
            N=192, M=192, device=args.device, seed=0)
    if args.model == "hesic-plus-device":
        return HESICPlus(N=192, M=192, dtype=dtype, device=args.device,
                         seed=0)
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


# ---- the wavefront device codecs (bench.py's ar-device and
# hesic-plus-device points) ----

def make_device_codec(model, mm: int, groups: int):
    """The wavefront device codec of `model` (mbt2018 or HESIC+), tables
    built; HESIC+'s with bench.py's cap 64, which reaches no container."""
    if model.single_image:
        return JointAutoregressiveDeviceCodec(model, mm=mm,
                                              groups=groups).update()
    return HESICPlusDeviceCodec(model, mm=mm, groups=groups,
                                cap=64).update()


def device_args(codec, x1, x2, h) -> tuple:
    """The arguments of `codec`'s compress for a pool batch: mbt2018
    codes the first eyes alone."""
    if isinstance(codec, JointAutoregressiveDeviceCodec):
        return (x1,)
    return (x1, x2, h)


def latent_keys(codec) -> tuple:
    if isinstance(codec, (JointAutoregressiveDeviceCodec,
                          JointAutoregressiveCodec)):
        return ("y_hat",)
    return ("y1_hat", "y2_hat")


def check_decoded(codec, out, rec, label: str) -> None:
    """Raise unless `rec` decoded to `out`'s own latents, and its
    reconstructions are finite."""
    for key in latent_keys(codec):
        if not torch.equal(rec[key], out[key]):
            bad = int((rec[key] != out[key]).sum())
            raise AssertionError(f"{label}: decoded {key} differs from the "
                                 f"encoder's latents at {bad} cells")
    for key, x in rec.items():
        if key.startswith("x") and not torch.isfinite(x).all():
            raise AssertionError(f"{label}: {key} not finite")


def check_threaded_bytes(codec, args) -> None:
    """An encode on a worker thread while the main thread decodes must
    give the synchronous container, byte for byte."""
    ref = codec.compress(*args)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(codec.compress, *args)
        rec = codec.decompress(ref["strings"])
        again = fut.result()
    if again["strings"] != ref["strings"]:
        raise AssertionError("the threaded encode diverged from the "
                             "synchronous container")
    check_decoded(codec, ref, rec, "threaded round trip")


def device_timed_loop(codec, batches, pipeline: int) -> dict:
    """bench.py's timed loop over `batches` (compress arguments): mode 1
    encodes batch i+1 on one worker thread while the main thread decodes
    batch i; mode 0 encodes then decodes each batch.  Returns {"seconds",
    "containers", "decoded": each decode's latents, "last": the last
    decode}."""
    outs, decoded = [], []
    keys = latent_keys(codec)

    def decode(out):
        rec = codec.decompress(out["strings"])
        outs.append(out)
        decoded.append({k: rec[k] for k in keys})
        return rec

    _sync(codec)
    t0 = time.perf_counter()
    if pipeline == 1:
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(codec.compress, *batches[0])
            for i in range(len(batches)):
                out = fut.result()
                if i + 1 < len(batches):
                    fut = ex.submit(codec.compress, *batches[i + 1])
                rec = decode(out)
    else:
        for args in batches:
            rec = decode(codec.compress(*args))
    _sync(codec)
    return {"seconds": time.perf_counter() - t0, "containers": outs,
            "decoded": decoded, "last": rec}


def warm_up_device(codec, pool, h) -> None:
    """Every pool batch's round trip, whose decoded latents must equal the
    encoder's, then the threaded byte check on the first."""
    for i, (x1, x2) in enumerate(pool):
        args = device_args(codec, x1, x2, h)
        out = codec.compress(*args)
        check_decoded(codec, out, codec.decompress(out["strings"]),
                      f"warm-up batch {i}")
    check_threaded_bytes(codec, device_args(codec, *pool[0], h))


def check_device_loop(codec, loop) -> None:
    """Raise unless every container of a timed loop decoded to its
    encoder's latents and the last decode is finite."""
    for i, (out, dec) in enumerate(zip(loop["containers"],
                                       loop["decoded"])):
        check_decoded(codec, out, dec, f"timed batch {i}")
    check_decoded(codec, loop["containers"][-1], loop["last"],
                  "the last batch")


def run_device(codec, pool, h, n_batches: int, pipeline: int = 1) -> dict:
    """The warm-up, the timed loop over `n_batches` batches (the pool
    cycled) and its exactness check.  Returns the loop's seconds, mean
    bpp_real and escapes."""
    warm_up_device(codec, pool, h)
    batches = [device_args(codec, *pool[i % len(pool)], h)
               for i in range(n_batches)]
    loop = device_timed_loop(codec, batches, pipeline)
    check_device_loop(codec, loop)
    outs = loop["containers"]
    return {"seconds": loop["seconds"],
            "bpp_real": float(np.mean([o["bpp_real"] for o in outs])),
            "escapes": [o["escapes"] for o in outs]}


# ---- the host AR codec (bench.py's ar point) ----

def host_round_trip(codec, x, label: str) -> dict:
    """One round trip of images `x` through the host AR codec: the decoded
    y_hat must equal the encoder's (tolerance 0) and x_hat be finite and
    of the input's shape.  Returns the encode's dict, the decode's
    coder seconds added as 'dec_coder_s'."""
    out = codec.compress(x)
    rec = codec.decompress(out["strings"], out["shape"])
    check_decoded(codec, out, rec, label)
    if tuple(rec["x_hat"].shape) != tuple(x.shape):
        raise AssertionError(f"{label}: x_hat shape "
                             f"{tuple(rec['x_hat'].shape)}")
    return {**out, "dec_coder_s": rec["coder_s"]}


def run_host(codec, x, n_batches: int) -> dict:
    """bench.py's ar loop: one untimed round trip of `x`, then
    `n_batches` timed round trips (encode then decode), every one exact.
    Returns the loop's seconds, mean bpp_real and seconds in the native
    coder (encode and decode)."""
    host_round_trip(codec, x, "warm-up")
    outs = []
    _sync(codec)
    t0 = time.perf_counter()
    for i in range(n_batches):
        outs.append(host_round_trip(codec, x, f"timed batch {i}"))
    _sync(codec)
    return {"seconds": time.perf_counter() - t0,
            "bpp_real": float(np.mean([o["bpp_real"] for o in outs])),
            "coder_s": sum(o["coder_s"] + o["dec_coder_s"] for o in outs)}


def mfu_fields(codec, size: int, pairs_per_sec: float, peak: float,
               **kw) -> dict:
    """bench.py's _mfu_fields in the port: `codec`'s device_flops at size x
    size (its keyword arguments `kw`), the TFLOP/s at `pairs_per_sec` and
    its share of `peak` TFLOP/s, both null off the card.  Raises where the
    count is not positive or the share reads above 100%."""
    fl = codec.device_flops(size, size, **kw)
    per_pair = fl["flops_per_pair"]
    tflops = share = None
    if codec.device.type == "cuda":
        tflops = per_pair * pairs_per_sec / 1e12
        share = 100.0 * tflops / peak
    if not per_pair > 0 or (share is not None and not share <= 100.0):
        raise RuntimeError(f"MFU of {type(codec).__name__}: {per_pair} "
                           f"FLOPs a pair at {pairs_per_sec} pairs/s give "
                           f"{share}% of {peak} TFLOP/s")
    return {"flops_per_pair": per_pair,
            "flops_per_program": fl["per_program"],
            "tflops_per_sec": tflops, "mfu_pct_bf16": share,
            "flops_counter": FLOPS_COUNTER, "peak_tflops": peak}


def bench(model, args, calib_hw: int = 256) -> dict:
    """Calibrate `model`, build the codec and the pool, and run the bench
    point of `args` (parse_args).  Returns run()'s or run_device()'s
    numbers, with the peak memory of the run ("peak_memory_gib", None
    off the card) and the MFU fields (mfu_fields) of the MFU_POINTS under
    "mfu", counted after it."""
    rng = np.random.RandomState(0)
    if args.calib_steps > 0:
        cal = calibrate_single if model.single_image else calibrate
        cal(model, rng, args.calib_steps, hw=calib_hw)
    if args.model == "mbt":
        codec = JointAutoregressiveCodec(model).update()
        x = make_pool(rng, 1, args.batch, args.size, codec.device)[0][0]
        res = run_host(codec, x, args.batches)
        res["peak_memory_gib"] = peak_gib(codec.device)
        return res
    h = homographies(args.h, args.batch)
    if args.model in DEVICE_POINTS:
        codec = make_device_codec(model, args.mm, args.groups)
        pool = make_pool(rng, min(args.batches, args.pool), args.batch,
                         args.size, codec.device)
        res = run_device(codec, pool, h, args.batches, args.pipeline)
        kw = {"batch": args.batch}
        pairs_per_sec = args.batches * args.batch / res["seconds"]
    else:
        codec = make_codec(model, args.mm, args.batch)
        pool = make_pool(rng, min(args.batches, args.pool), args.batch,
                         args.size, codec.device)
        res = run(codec, pool, h, args.batches, args.pipeline)
        # the warp windows the loop ran at
        kw = {"win": pick_warp_win(h, args.size, args.size),
              "xwin": pick_warp_xwin(h, args.size, args.size)}
        pairs_per_sec = res["pairs_per_sec"]
    # the peak before the FLOP count, which runs the programs once more
    res["peak_memory_gib"] = peak_gib(codec.device)
    if args.model in MFU_POINTS:
        res["mfu"] = mfu_fields(codec, args.size, pairs_per_sec,
                                args.peak_tflops, **kw)
    return res


def peak_gib(device):
    """torch.cuda.max_memory_allocated in GiB on the card, else None."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def train_model(args, dtype):
    """The train point's model: HESIC N=128/M=192/K=5 with `dtype`
    transforms (None: float32), seed 0, on args.device."""
    return HESIC(N=128, M=192, K=5, dtype=dtype, device=args.device, seed=0)


def bench_train(args) -> dict:
    """bench.py's bench_train: for float32, then bf16, the model of
    train_model stepped by training.recipe.trainer on one batch of
    `args.batch` smooth pairs at `args.size` (identity H): one warm-up
    step under the FLOP counter (untimed), then `args.steps` timed steps.
    Raises on a non-finite loss.  Returns {precision: {"steps_per_sec",
    "pairs_per_sec", "tflops_per_sec", "mfu_pct_bf16", "flops_per_step"}}
    (the rate and the share null off the card)."""
    cuda = args.device == "cuda"
    results = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = train_model(args, dtype)
        _, step, gen = trainer(model)
        batch = train_batch(np.random.RandomState(0), args.batch, args.size,
                            args.device)
        losses = []
        metrics, flops = counted_flops(step, batch, gen)
        losses.append(metrics["loss"])
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            losses.append(step(batch, gen)["loss"])
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        bad = [i for i, v in enumerate(losses) if not torch.isfinite(v)]
        if bad:
            raise RuntimeError(f"train {name}: non-finite loss at steps "
                               f"{bad}")
        steps_per_sec = args.steps / seconds
        tflops = flops * steps_per_sec / 1e12 if cuda else None
        results[name] = {
            "steps_per_sec": steps_per_sec,
            "pairs_per_sec": steps_per_sec * args.batch,
            "tflops_per_sec": tflops,
            "mfu_pct_bf16": (100.0 * tflops / args.peak_tflops if cuda
                             else None),
            "flops_per_step": flops,
        }
        del model, step, batch
        if cuda:
            torch.cuda.empty_cache()
    return results


def backend_flags() -> dict:
    """The cuDNN and matmul settings a run times under: the train point
    keeps PyTorch's defaults (TF32 convolutions allowed), while a process
    that built a codec first runs under the codecs' determinism policy
    (models.base.deterministic_backends: TF32 off), which slows the f32
    step several fold."""
    return {"cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def train_line(args, results: dict) -> dict:
    """The train point's JSON line (bench.py's keys, then the port's)."""
    bf16, f32 = results["bf16"], results["f32"]
    speedup = bf16["steps_per_sec"] / f32["steps_per_sec"]
    cuda = args.device == "cuda"
    return {
        "metric": f"hesic_train_pairs_per_sec_{args.size}px_bf16",
        "value": bf16["pairs_per_sec"],
        "unit": "pairs/s/chip",
        "vs_baseline": speedup,
        "model": "train",
        "batch": args.batch,
        "bf16": bf16,
        "f32": f32,
        "bf16_speedup": speedup,
        "peak_memory_gib": peak_gib(args.device),
        "flops_counter": FLOPS_COUNTER,
        "flops_scope": "the forward's and the backward's matmuls and "
                       "convolutions; Adam's elementwise update is not "
                       "counted",
        "peak_tflops": args.peak_tflops,
        "backends": backend_flags(),
        "card": card_line() if cuda else None,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("bench: no CUDA device; run with --device cpu for a "
              "rehearsal", file=sys.stderr)
        return 1
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if args.model == "train":
        print(json.dumps(train_line(args, bench_train(args))))
        return 0
    res = bench(build_model(args), args)
    prefix, item = POINTS[args.model][:2]
    if args.model == "mbt":
        codec_fields = {"host_threads": host_threads(args.batch),
                        "cpu_count": os.cpu_count(),
                        "coder_seconds": res["coder_s"]}
    elif args.model in DEVICE_POINTS:
        codec_fields = {"mm": args.mm, "groups": args.groups,
                        "escapes": res["escapes"]}
    else:
        codec_fields = {"mm": res["mm"], "outliers": res["outliers"]}
    codec_fields.update(res.get("mfu", {}))
    print(json.dumps({
        "metric": f"{prefix}_{item}_per_sec_{args.size}px_encdec",
        "value": args.batches * args.batch / res["seconds"],
        "unit": f"{item}/s/chip",
        "model": args.model,
        "bpp_real": res["bpp_real"],
        "batches": args.batches,
        "batch": args.batch,
        "h": args.h,
        "pipeline": args.pipeline,
        "peak_memory_gib": res["peak_memory_gib"],
        **codec_fields,
        "card": card_line() if cuda else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
