#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (hesic_tpu_torch).

Usage, from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  1. requires a CUDA device; prints the card's name and power limit;
  2. builds the native code from the checkout's sources, in parallel
     (g++ for the host rANS coder, one nvcc per CUDA source);
  3. holds kernels 1-3 against their plain PyTorch twins on the card, on
     seeded inputs at the HESIC fast path's shapes (B=8, M=192, K=5,
     32x32 latents, ppl=8, every grid bucket mm 4, 8, 16 and 32, pooled
     weights): the results must be bit-equal (tolerance 0); times kernel
     and twin.  Kernels 2 and 3 also on kernel 1's rows at mm 64
     (S=129) and at ragged lane layouts (ppl 1, 10x10 and 9x10 latents).
     Kernels 1-3 also at bench.py's batch 64 (kernel 1's rows feeding
     kernels 2 and 3) on grid mm 4, which phase 9's calibrated latents
     pick, and mm 16, the bench's cap: the plans of kernels 2 and 3
     depend on the batch and the grid.  Prints each launch's plan (lane
     group, ring depth, blocks, shared memory), and where kernel 3 could
     use either CDF search also holds and times the one its plan did not
     pick;
  4. holds kernels 4 and 5 against their twins at the HESIC+ path's
     shapes (B=11, 32x32 latents, M=192, mm 16, 8 channel groups: 125
     levels, 2904 lanes, 1000 slots; the model's seeded weights; inputs
     from its transforms on the smooth pairs), for both variants of the
     level scan (eye 1 without and eye 2 with the cross-eye input):
     kernel 5's teacher pass on the twin's own reconstruction (inputs on
     the quantization lattice) must give equal residuals, y_hat within
     Y_TOL and intervals within FREQ_TOL; on raw latents at most
     RAW_FLIP_SHARE of the residuals may differ, and in each image the
     first level where they differ must hold rounding-margin cells only
     (the products sum in another order than the twin's torch.matmul, so
     flips start only where y - mean lies within Y_TOL of a .5 boundary
     and spread down the causal cone); the same gate must reject the
     kernel run with bf16-rounded weights; kernel 4 must be bit-equal to
     its twin on kernel 5's intervals at the codec's one-launch cap (T
     words a lane), at a cap below the counts, on a seeded mask under
     which the lanes of one group differ, at 21 lanes and 37 slots (a
     ragged lane group, a T that is not a multiple of a stage) and under
     another plan (stages of 8 slots, 2 helpers); prints its plan and
     times it beside its bound; kernel 5's decode of kernel 4's stream
     must give y_hat bit-equal to its teacher pass; kernel 5's hoisted
     product (the scan-independent part of its first layer) must agree
     with its twin within HOIST_TOL; times kernel 5's pass, its hoisted
     product, and one level's four products as torch.matmul (a
     yardstick);
  5. drives the HESIC fast path: HESIC N=128/M=192/K=5 (bf16 transforms,
     seeded random weights) through HESICFastCodec.compress_fast ->
     decompress_fast on 8 smooth 512x512 pairs, with the identity and a
     rotated homography (grid mm 4), once more with amplified inputs and
     the grid capped at mm=4 so latents escape the grid, and twice with
     the analysis transforms' last conv scaled so the default codec picks
     grids mm 16 and mm 32.  The decoded latents must equal the encoder's
     own quantized latents (also for pair 3's container decoded alone and
     for the identity case's list reversed), kernel 2 must have launched
     once per eye, the reconstructions must be finite and of the
     input's shape, the escape case must have outliers, the run must
     reach grids 4, 16 and 32, and kernels 1-3 must have launched;
  6. drives the HESIC+ path: HESIC+ N=192/M=192 (bf16 transforms, seeded
     random weights) through HESICPlusDeviceCodec.compress -> decompress
     on 11 smooth 512x512 pairs (mm 16, 8 groups; cap 64, which reaches
     no container) with the
     identity and a rotated homography, and with an mm=1 codec whose
     residuals escape the grid.  The decoded y1_hat/y2_hat must equal the
     encoder's, the reconstructions must be finite and of the input's
     shape, the escape case must have escapes, kernel 4 must have
     launched exactly once per eye and kernel 5 must have launched
     (kernel 5 counts one launch per eye pass, its 626 kernel launches
     included: the hoisted product, then four stage GEMMs and the coder
     per level);
  7. trains HESIC N=128/M=192/K=5 at bench.py's train point (512x512,
     batch 8, lambda 1e-2, Adam 1e-4 main / 1e-3 aux), in bf16 and in
     f32: one warm-up step, then 12 timed steps; prints ms a step, pairs/s
     and peak memory beside the card's name and power limit; raises on a
     non-finite loss or gradient and unless both parameter groups moved.
     It also runs the training warp's backward under
     torch.use_deterministic_algorithms(True), which must not raise and
     must agree with the default backward;
  8. calibrates as bench.py does (training.recipe.calibrate: bf16,
     256x256, batch 4, 60 steps, seeded noise), printing loss and bpp
     every 10 steps; the mean loss of the last 10 steps must be below the
     first 10's, and a second HESIC calibrated from the same seed must end
     with every parameter and buffer bit-identical and every loss equal
     (ROADMAP C5).  Then the calibrated model goes through compress_fast ->
     decompress_fast on phase 5's 8 pairs (identity H): the decoded
     latents must equal the encoder's, kernels 1-3 must have launched,
     and bpp_real must be below phase 5's random-weights bpp_real of the
     same pairs;
  9. runs the port's bench loop (hesic_tpu_torch/bench.py) at bench.py's
     codec point on the calibrated model: batch containers of 64 smooth
     512x512 pairs, mm 16, codec_batch 64, a pool of 4 distinct batches
     on the device cycled over 6 timed batches, for the identity and
     bench.py's real H, in modes 2 (decode(i-1), compress_fast_start
     (i+1), compress_fast_finish(i)) and 0 (encode then decode).  After
     the bench's warm-up the pipelined re-encode of a batch must equal
     its synchronous batch container byte for byte; every container of
     each timed loop must decode to the encoder's latents; kernels 2 and
     3 must launch exactly twice a batch; compress_fast_start (its
     non-seeding calls) and decompress_fast_batch run under
     torch.cuda.set_sync_debug_mode("error"), so a host sync inside them
     raises, and each must return while a ~1 s device sleep queued before
     it still runs (a wait by any route, one the debug mode does not see
     included); a call that launches more kernels than the stream's
     launch queue holds (measured in the run) blocks on the full queue
     until the sleep ends, and passes only if a profiler audit of it
     finds no waiting CUDA call and no copy to or from pageable host
     memory.  Prints pairs/s, bpp_real, the grids, peak memory and the
     card.  A grid the loops picked that phase 3 did not hold at batch 64
     is held then;
 10. drives DSIC at bench.py's DSIC point: DSIC N=128/M=192/F=21/C=32/
     K=5 (bf16 transforms, the disparity-folded 3-D branch, seeded random
     weights) through DSICFastCodec on phase 5's 8 pairs, per-pair and
     batch container (grid cap 32) and an escape case (amplified inputs,
     grid capped at mm 4, which must have outliers): decoded latents
     equal to the encoder's, reconstructions finite and of the input's
     shape, kernel 2 once per eye, kernels 1-3 launched.  Then calibrates
     it as bench.py's _calibrate(arch="dsic") does (60 bf16 steps at
     256x256, batch 4, no homography; the mean loss of the last 10 steps
     must be below the first 10's, and a second DSIC calibrated from the
     same seed must end bit-identical, as in phase 8), then runs phase 9's
     bench loop on it
     at batch 32, 4 timed batches, identity H (DSIC ignores it), in
     modes 2 and 0, with phase 9's checks; then holds kernels 1-3 at batch
     32 on every grid those loops picked (bit-equal, timed, with bounds);
 11. drives mbt2018 at bench.py's ar-device point: N=192/M=192 float32
     (seeded random weights) through JointAutoregressiveDeviceCodec on 11
     smooth 512x512 images (phase 6's first eyes; mm 16, 8 groups) and
     with an mm=1 codec whose residuals must escape; then calibrates it
     as bench.py's _calibrate_single does (training.recipe.
     calibrate_single: 60 steps at 256x256, batch 4; the mean loss of the
     last 10 steps must be below the first 10's) and round-trips the
     calibrated codec, whose bpp_real must be below the random weights';
     then holds kernel 5 (the no-post level scan, the calibrated
     weights) and kernel 4 against their twins under phase 4's gates
     (lattice inputs, the raw-latent flip share, the bf16-weights control
     rejected; kernel 4 bit-equal in every regime), timed beside their
     bounds; then runs the port's bench loop (hesic_tpu_torch/bench.py's
     device point) at batch 11 over 4 timed batches in modes 1 (encode
     on a worker thread while the main thread decodes) and 0, after a
     warm-up whose threaded encode must equal the synchronous container
     byte for byte.  Every decoded y_hat must equal the encoder's;
     kernel 4 must launch once per batch and kernel 5 twice per round
     trip;
 12. calibrates HESIC+ N=192/M=192 bf16 as bench.py's hesic-plus-device
     point does (training.recipe.calibrate: 60 steps at 256x256, batch
     4, identity H; the loss must fall as in phase 11), round-trips phase
     6's pairs (identity H), whose bpp_real must be below phase 6's
     random-weights one, then runs phase 11's bench loop on it (batch
     11, 4 timed batches, modes 1 and 0, the same checks; kernel 4 once
     per eye);
 13. drives phase 11's calibrated mbt2018 through the host AR codec
     (JointAutoregressiveCodec: the transforms on the card, the
     raster-causal recursion in the native host coder, one thread an
     image): a round trip of phase 11's 11 images, whose decoded y_hat
     must equal the encoder's and x_hat be finite and of the input's
     shape, its bpp_real printed beside the device codec's at the same
     weights; then the port's bench loop at bench.py's ar point
     (hesic_tpu_torch/bench.py --model mbt: batch 8, one untimed round
     trip, 2 timed batches of encode then decode, every one exact);
     prints images/s, the seconds in the native coder and the card;
 14. drives phase 12's calibrated HESIC+ through its host codec
     (HESICPlusCodec, one pair at a time, both eyes through the native
     coder, the right eye's analysis input warped by the full bilinear
     gather): one of phase 6's pairs at the identity H and one at the
     rotated H.  The decoded y1_hat and y2_hat must equal the encoder's,
     the reconstructions be finite and of the input's shape, bpp_real
     be below phase 6's random-weights one, and a container carrying
     the CPU's writer byte must be refused.  Phases 13 and 14 launch
     none of the five kernels: the host codecs compute what kernels 4
     and 5 compute, serially in C++, as the JAX package's do;
 15. drives the CompressAI priors through their host codecs
     (models/codec.py): bmshj2018-factorized, bmshj2018-hyperprior and
     mbt2018-mean, each at the zoo's two widths (N128/M192 and N192/M320,
     random seeded weights), on the first eyes of 4 of phase 6's pairs.
     Decoded y_hat must equal the encoder's, and the factorized prior's
     be round(y - medians) + medians.  Then mbt2018-mean N128/M192 is
     calibrated by training.recipe.calibrate_single (60 steps; the loss
     must fall as in phase 11) and its round trip must stay exact with a
     bpp_real below the random weights'.  Prints bpp_real and the encode
     and decode seconds;
 16. drives the reference-layout container codecs (a .npz header and a
     .bin body in the reference's byte layout, through files in a
     temporary directory) at full width and calibrated weights:
     HESICCodec on phase 8's HESIC, DSICCodec on phase 10's DSIC and
     HESICPlusRefCodec on phase 12's HESIC+, each on two of phase 6's
     pairs, the first at the identity H and the second at the rotated H
     (DSIC takes none).  Decoded y1_hat/y2_hat must equal the encoder's,
     the reconstructions be finite and of the input's shape, and
     decoding with the H passed equal decoding with the header's.
     Prints bpp_real, bpp_side, the encode and decode seconds and the
     host coder's share of them.  Phases 15 and 16 launch none of the
     five kernels: their coders are host C++ (the range coder, rANS), as
     the JAX package's are;
 17. drives Cheng2020 through the wavefront device codec (the zoo builds
     both): cheng2020-anchor at quality 4 (N=192) on phase 11's 11
     images, round trips at random weights (mm 16, and mm 1 on the
     images amplified by CHENG_ESC_GAIN, which must escape),
     calibrate_single (60 steps; the loss must fall as in phase 11), a
     calibrated round trip whose decoded images' MSE must be below the
     random weights' (whose near-zero latents code near the bpp floor:
     the init is torch.nn.Conv2d's default), kernels 5 (no post) and 4
     held against their twins at the calibrated weights under phase
     11's gates, on the images and on the amplified ones, and the host
     AR codec's round trip of 2 of the images; for the record (no gate)
     kernel 5 against its twin at the JAX package's draw; then
     cheng2020-attn at quality 1 (N=128, whose MLP widths 426 and 341
     kernel 5 runs padded to 432 and 352): a round trip and kernels 5
     and 4 held on its weights, on the amplified images' latents.  Every
     decoded y_hat must equal the encoder's, kernel 4 launch once and
     kernel 5 twice a round trip; prints kernel 5's times beside its
     bound at the real widths, and the residual blocks' f32 3x3 conv at
     the calibration's shape batched (cuDNN's pick) and image by image
     (layers.ImageConv);
 18. drives stage 2: HESICTogetherCodec over phase 8's HESIC,
     DSICPlusCodec over phase 10's DSIC and HESICPlusTogetherCodec over
     phase 12's HESIC+ (each enhancement from a seed) on one 512x512 pair
     at the identity and the rotated H (DSIC+ takes none).  Each
     decode's *_base must be bit-equal to the inner codec's decode of
     the same container and its output bit-equal to model.enhance on
     the base; prints the enhancement's ms a pair and the PSNR of base
     against enhanced (information only: the enhancement is untrained).
     Then zoo.create_model builds every name at its lowest quality on
     the card (its default device), as the registry's classes.  Phase 18
     launches none of the five kernels;
 19. trains from image folders and keeps what was trained: writes stereo
     folders (8 train and 2 test pairs of 512x512 smooth images, the
     right eye the left warped by bench.py's real H) and a single-image
     folder with the port's PNG writer (the single folder must read back
     as written); trains the homography net one epoch
     (training.train_homography, batch 4); trains HESIC N=128/M=192/K=5
     in bf16 one epoch through training.train (batch 4, 256x256 crops,
     the homography net's H), then runs it again for 2 epochs: it must
     print its resume line, and the state it loaded (every parameter and
     Adam tensor) must equal the file bit for bit and the file the first
     run's final weights; zoo.create_model(checkpoint=model_latest.pkl)
     round-trips the 2 test pairs exactly through HESICFastCodec (kernels
     1-3 launched); hesic-together --stage2 one epoch in f32: every m1
     tensor bit-unchanged, m2 moved; the reference's tiny trained HESIC
     (tests/fixtures/ref_hsic_tiny.pth.tar) converted by `python -m
     hesic_tpu_torch.utils.convert_torch`, loaded by
     create_model(checkpoint=) and by pretrained=True from a temporary
     zoo cache (equal weights), round-trips one test pair exactly through
     HESICFastCodec and HESICCodec.  Prints ms a training step, the
     epoch's data loading and steps, checkpoint seconds, peak memory,
     bpp_real and the phase's seconds beside the card;
 20. prints one JSON line with each kernel's numbers (launches: phases 5,
     6, 8, 10, 11, 12, 17 and 19's round trips and phases 9-12's timed
     loops; kernels 1-3's times and bounds at batch 64 on the widest
     grid phase 9 ran, kernels 4 and 5's at the HESIC+ point, their
     errors the largest of every hold, mbt2018's and Cheng2020's
     included), then the device line {"ok": true, "device": {...}}
     last.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import time

B, M, K, N = 8, 192, 5, 128
HW_IMG = 512
LAT = HW_IMG // 16              # 32x32 latents
PPL = 8
DEVICE = "cuda"
ALONE = 3                       # the pair whose container decodes alone
# f32 and integer instructions per evaluation, counted from
# codecs/det_math.py and csrc/pmf.cu: arithmetic, min/max, floor,
# conversions, compares and selects.  abs and negation are not counted:
# sm_90 folds them into the multiply as operand modifiers.  Loads, stores
# and address arithmetic are not counted either.
# det_std_cdf = mul (|x| folded), min (2) + 1 + P*z (2) + det_recip (int
# sub + 3 x [mul, sub, mul] = 10) + polynomial (9) + z*z (1, the negation
# folded) + det_exp (mul, add, floor + 2 x [mul, sub] = 7 reduction, 14
# Horner, 4 bit assembly/select, 1 scale = 26) + erfc mul (1) + tail
# (mul, sub, compare, select = 4) = 55; each (k, edge) adds the argument
# (sub, mul) = 57; each (k, bin) the mixture term (sub, mul, add) = 3;
# each bin the quantization (max, add, mul, floor, max, cvt, add, cmp)
# = 8; each (k) the scale setup (max + det_recip) = 11.
OPS_PER_EDGE, OPS_PER_KBIN, OPS_PER_BIN, OPS_PER_K = 57, 3, 8, 11
# H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): 3.35 TB/s
# HBM3; 67 TFLOP/s f32 counts an FMA as two operations, so un-fused f32
# operations run at 33.5e12/s.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 33.5e12
PEAK_F32_FLOPS = 67e12          # an FMA counts as two

# the HESIC+ path: bench.py's point (HESICPlus N=192/M=192 bf16, 512x512
# pairs, batch 11, mm 16, 8 channel groups, the JAX codec's word cap 64,
# which reaches no container); mbt2018's ar-device point has the same
# widths, batch, grid and groups (float32).  Their bench loops time 4
# batches.
AR_B, AR_N, AR_M, AR_MM, AR_GROUPS, AR_CAP = 11, 192, 192, 16, 8, 64
AR_BENCH_BATCHES = 4
# bench.py's ar point (the host AR codec): batch 8, 2 timed batches
HOST_B, HOST_BATCHES = 8, 2
# kernel 5 against its twin on lattice inputs (the twin's own
# reconstruction), where no residual may differ: y_hat within Y_TOL and
# starts/freqs within FREQ_TOL counts of 65536.  The kernel's f32 sums over
# <= 2304 terms run in another order than the twin's torch.matmul; a sound
# kernel read max |dy_hat| 4.2e-5 and 3/5 counts on the H100, so the
# limits sit about 10x and 1.6x above.  Y_TOL is also the rounding margin
# within which the first residual flips on raw latents must lie.  The gate
# must reject a control run of the kernel with its weights rounded to bf16.
Y_TOL = 5e-4
FREQ_TOL = 8
# on raw latents each flip spreads down its causal cone: a sound kernel
# flipped 4.3-5.0% of the residuals
RAW_FLIP_SHARE = 0.08
# kernel 5's coder per latent, counted from codecs/det_math.py as for
# kernel 1: each of the S+1 edges the argument (mul) and det_std_cdf (55),
# each bin the difference, clamp and total (3) and the quantization (8),
# each latent the scale floor, det_recip and det_qscale (23) and the
# residual (sub, round, clip: 4)
AR_OPS_PER_EDGE, AR_OPS_PER_BIN, AR_OPS_PER_LATENT = 56, 11, 27
# the hoisted product (576 or 384 terms a sum, in the kernel's fixed
# order) against its twin's torch.matmul: max |d| within HOIST_TOL of the
# largest |base|; a sound kernel read about 0.1 of that limit on the H100
HOIST_TOL = 1e-5

# phase 17's escape case: Cheng2020's init (torch.nn.Conv2d's default)
# keeps |y| below 1 on images in [0, 1], so the mm=1 codec codes them
# amplified about 0.5 by this gain
CHENG_ESC_GAIN = 32
# phase 15: the CompressAI priors at the zoo's two widths
# (hesic_tpu/zoo/__init__.py: qualities 1-5 or 1-4, and the rest), on the
# first eyes of PRIOR_B of phase 6's pairs
PRIOR_B = 4
PRIOR_WIDTHS = ((128, 192), (192, 320))
# the training step at bench.py's points (training.recipe.trainer: lambda
# 1e-2, Adam lr 1e-4, aux 1e-3): BENCH_MODE=train (512x512, batch 8, 12
# timed steps after a warm-up, bf16 and f32) and _calibrate (bf16,
# 256x256, batch 4, 60 steps)
TRAIN_B, TRAIN_STEPS = 8, 12
CAL_HW, CAL_B, CAL_STEPS = 256, 4, 60
# the port's bench loop at bench.py's codec point (batch 64, mm 16; six
# timed batches cycling a pool of four)
BENCH_B, BENCH_BATCHES, BENCH_POOL = 64, 6, 4
# kernels 1-3 held at batch 64 on these grids up front: the one the
# calibrated latents pick (mm 4) and the bench's cap (mm 16).  Phase 9
# holds any other grid it picks as well.
BENCH_GRIDS = (4, 16)
# DSIC at bench.py's DSIC point (bench_dsic: N128/M192/F21/C32/K5 bf16,
# mm 16, batch containers of 32 over 4 timed batches); its round trips
# at batch 8 (grid cap 32, and mm 4 for the escape case)
DS_F, DS_C = 21, 32
DS_BENCH_B, DS_BENCH_BATCHES = 32, 4
# a device sleep of ~1 s at the H100's ~2 GHz, queued ahead of a call that
# must not wait for the device
SLEEP_CYCLES = 2_000_000_000
# CUDA calls that launch work on a stream without waiting, and those that
# wait for the device (a stream query is a poll, so one in a loop is a wait)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemsetAsync")
WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaStreamQuery", "cudaMemcpy",
              "cudaMemcpy2D")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def sync():
    import torch
    torch.cuda.synchronize()


def check_equal(name: str, got, want) -> int:
    """Raise unless integer tensors are equal; returns max |got - want|."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:        # e.g. no word emitted in a small window
        return 0
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain twin "
                             f"(max abs err {err})")
    return err


def pmf_inputs(mm: int, seed: int, b: int = B, hy: int = LAT,
               wy: int = LAT):
    """Seeded head outputs at the main path's shapes: sigma, means
    (b, K*M, hy, wy), pooled softmax weights (b, K*M, 1, 1), centres."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    center = rng.randint(-6, 7, (b, M)).astype(np.int32)
    mu = (np.repeat(center[:, None, :], K, 1)[..., None, None]
          + rng.randn(b, K, M, hy, wy) * (mm / 6.0))
    sigma = np.abs(rng.randn(b, K, M, hy, wy)) * (mm / 8.0) + 0.05
    logits = rng.randn(b, K, M)
    w = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dev = DEVICE

    def t(a, shape):
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(shape), np.float32)).to(dev)

    return (t(sigma, (b, K * M, hy, wy)), t(mu, (b, K * M, hy, wy)),
            t(w, (b, K * M, 1, 1)), torch.from_numpy(center).to(dev))


def kernel1_rows(mm: int, seed: int, b: int, hy: int, wy: int):
    """Frequency rows (b, M, 2*mm+1, hy*wy) from kernel 1 on seeded head
    outputs: valid rows (sum 65536, every bin >= 1) shaped as the codec's."""
    from hesic_tpu_torch.codecs import pmf
    sigma, mu, w, center = pmf_inputs(mm, seed, b, hy, wy)
    return pmf.gmm_freq_cuda(sigma, mu, w, mm, K, center)


def row_symbols(freq, seed: int):
    """Symbols (M, B, hw) int32 drawn from each row's own distribution."""
    import torch
    b, m, _, hw = freq.shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    u = torch.randint(0, 1 << 16, (b, m, 1, hw), generator=g,
                      device=DEVICE)
    sym = (torch.cumsum(freq, dim=2) <= u).sum(dim=2).to(torch.int32)
    return sym.permute(1, 0, 2).contiguous()


def phase_pmf(mm: int, seed: int, b: int = B) -> dict:
    from hesic_tpu_torch.codecs import pmf
    sigma, mu, w, center = pmf_inputs(mm, seed, b)
    got = pmf.gmm_freq_cuda(sigma, mu, w, mm, K, center)
    want = pmf.gmm_freq_plain(sigma, mu, w, mm, K, center)
    sync()
    err = check_equal(f"gmm_freq mm={mm} B={b}", got, want)
    s = 2 * mm + 1
    if not (got.sum(dim=2) == 1 << 16).all() or got.min() < 1:
        raise AssertionError("gmm_freq rows must sum to 65536, bins >= 1")
    ms = cuda_ms(lambda: pmf.gmm_freq_cuda(sigma, mu, w, mm, K, center), 20)
    plain_ms = cuda_ms(
        lambda: pmf.gmm_freq_plain(sigma, mu, w, mm, K, center), 2)
    hw = LAT * LAT
    ops = b * M * hw * (K * (s + 1) * OPS_PER_EDGE + K * s * OPS_PER_KBIN
                        + s * OPS_PER_BIN + K * OPS_PER_K)
    nbytes = 4 * (2 * b * K * M * hw + b * K * M + b * M + b * M * s * hw)
    bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "operations": ops / PEAK_F32_OPS * 1e3}
    by = max(bound, key=bound.get)
    print(f"kernel gmm_freq mm={mm} B={b}: bit-equal to plain (max_abs_err "
          f"{err}); {ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
          f"{bound[by]:.4f} ms by {by} ({ops:.3e} ops, {nbytes:.3e} B)")
    return {"freq": got, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[by], "bound_by": by}


def overflow_budget(ppl: int, m: int) -> int:
    """A word budget per lane of ~5 bits a symbol, below kernel 2's counts
    at the wider grids (the codec launches at the guaranteed bound): it
    holds kernel 2's overflow contract, true counts and the words within
    the budget."""
    if ppl == 1:
        return m + 2
    return max(64, -(-m * ppl * 5 // 16 // 16) * 16)


def plan_text(plan) -> str:
    return (f"LG {plan.lg}, D {plan.d}, ahead {plan.ahead}, {plan.blocks} "
            f"blocks x {plan.threads} threads, {plan.smem} B shared, "
            f"{4 * plan.vec}-byte copies")


def phase_rans(freq, label: str, seed: int, ppl: int = PPL,
               reps: int = 5) -> dict:
    """Kernels 2 and 3 on realistic rows: symbols drawn from each row's
    own distribution, `ppl` positions per lane and the overflow budget
    (re-encoded with room for every word when a lane passes it).  Both
    must be bit-equal to their twins; times both."""
    import torch
    from hesic_tpu_torch.codecs import grid_rans
    b, m, s, hw = freq.shape
    ls = hw // ppl
    sym_mbl = row_symbols(freq, seed)
    sym = sym_mbl.permute(1, 0, 2)
    cap = overflow_budget(ppl, m)
    enc = grid_rans.rans_encode_grid_cuda(freq, sym_mbl, ppl, cap)
    ref = grid_rans.rans_encode_grid_plain(freq, sym_mbl, ppl, cap)
    sync()
    err_e = max(check_equal(f"encode {n} {label}", a, r)
                for n, a, r in zip(("words", "counts", "states"), enc, ref))
    cmax = int(enc[1].max())
    if cmax > cap:      # re-encode with room for every word
        cap = -(-cmax // 16) * 16
        enc = grid_rans.rans_encode_grid_cuda(freq, sym_mbl, ppl, cap)
        ref = grid_rans.rans_encode_grid_plain(freq, sym_mbl, ppl, cap)
        sync()
        err_e = max([err_e] + [
            check_equal(f"encode {n} {label}, cap {cap}", a, r)
            for n, a, r in zip(("words", "counts", "states"), enc, ref)])
    enc_ms = cuda_ms(
        lambda: grid_rans.rans_encode_grid_cuda(freq, sym_mbl, ppl, cap),
        reps)
    enc_plain_ms = cuda_ms(
        lambda: grid_rans.rans_encode_grid_plain(freq, sym_mbl, ppl, cap), 1)

    words, counts, states = enc
    dec = grid_rans.rans_decode_grid_cuda(freq, words, counts, states, ppl)
    dref = grid_rans.rans_decode_grid_plain(freq, words, counts, states, ppl)
    sync()
    err_d = check_equal(f"decode {label}", dec, dref)
    check_equal(f"decode inverts encode {label}", dec, sym_mbl)
    dec_ms = cuda_ms(lambda: grid_rans.rans_decode_grid_cuda(
        freq, words, counts, states, ppl), reps)
    dec_plain_ms = cuda_ms(lambda: grid_rans.rans_decode_grid_plain(
        freq, words, counts, states, ppl), 1)
    plan_d = grid_rans._launch_plan(ppl, False, freq)
    alt = ""
    if grid_rans.split_entries(s):
        # the search the plan did not pick, on the same words: the
        # measurement behind grid_rans.SPLIT_MAX_S (not counted)
        other = plan_d._replace(
            search="binary" if plan_d.search == "split" else "split")
        dec_o = grid_rans._launch_decode(other, freq, words, counts, states,
                                         ppl)
        sync()
        check_equal(f"decode, {other.search} search, {label}", dec_o, dref)
        other_ms = cuda_ms(lambda: grid_rans._launch_decode(
            other, freq, words, counts, states, ppl), reps)
        alt = f"; {other.search} search {other_ms:.4f} ms, bit-equal"

    # data-dependent bytes: a symbol's interval needs its row's first
    # sym+1 entries; each input read once, each output written once
    row_bytes = 4 * int((sym.to(torch.int64) + 1).sum())
    io_lanes = 4 * b * ls + 8 * b * ls            # counts i32 + states i64
    words_bytes = 4 * b * cap * ls
    enc_bytes = row_bytes + 4 * m * b * hw + words_bytes + io_lanes
    dec_bytes = row_bytes + words_bytes + io_lanes + 4 * m * b * hw
    words_per_lane = float(counts.double().mean())
    plan_e = grid_rans._launch_plan(ppl, True, freq, sym_mbl)
    bound_e = enc_bytes / PEAK_BYTES * 1e3
    bound_d = dec_bytes / PEAK_BYTES * 1e3
    print(f"kernel grid_rans_encode {label}: bit-equal to plain (words, "
          f"counts, states); {enc_ms:.4f} ms kernel, {enc_plain_ms:.1f} ms "
          f"plain, bound {bound_e:.4f} ms by bytes; cap {cap}, mean "
          f"{words_per_lane:.1f} words/lane; plan {plan_text(plan_e)}")
    print(f"kernel grid_rans_decode {label}: bit-equal to plain and to the "
          f"encoded symbols; {dec_ms:.4f} ms kernel, {dec_plain_ms:.1f} ms "
          f"plain, bound {bound_d:.4f} ms by bytes; plan "
          f"{plan_text(plan_d)}, {plan_d.search} search{alt}")
    return {
        "encode": {"err": err_e, "ms": enc_ms, "plain_ms": enc_plain_ms,
                   "bound_ms": bound_e, "bound_by": "bytes"},
        "decode": {"err": err_d, "ms": dec_ms, "plain_ms": dec_plain_ms,
                   "bound_ms": bound_d, "bound_by": "bytes"},
    }


def hold_batch(mm: int, b: int = BENCH_B) -> tuple:
    """Kernels 1-3 at a bench batch `b` (bench.py's BENCH_B, or DSIC's
    DS_BENCH_B) on grid `mm`: kernel 1 against its twin, its rows then
    feeding kernels 2 and 3, all bit-equal and timed.  The plans of
    kernels 2 and 3 depend on the batch and the grid, so each grid a bench
    runs is held here."""
    import torch
    pmf_r = phase_pmf(mm, seed=11, b=b)
    rans_r = phase_rans(pmf_r.pop("freq"), f"mm={mm} B={b}", seed=12)
    torch.cuda.empty_cache()
    return pmf_r, rans_r


def scaled_analysis(model, gain: float):
    """A copy of `model` whose analysis transforms end in a conv scaled by
    `gain`, so its latents spread `gain` times wider.  A gain on the input
    cannot do that: the GDNs before the last conv saturate."""
    import copy
    wide = copy.deepcopy(model)
    for conv in (wide.encoder1.Conv_3, wide.encoder2.Conv_4):
        conv.weight.mul_(gain)
        conv.bias.mul_(gain)
    return wide


def wide_codec(model, x1, x2, mm: int):
    """A default codec (grid cap 32) over the first scaled copy of `model`
    for which pick_mm chooses grid `mm` for both eyes of (x1, x2) at the
    identity H.  Random weights alone spread the latents over mm 4 only."""
    import numpy as np
    import torch
    from hesic_tpu_torch.geometry import pick_warp_win
    from hesic_tpu_torch.models.hesic_fast import (MM_DEFAULT,
                                                   HESICFastCodec, pick_mm)
    eye = np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))
    win = pick_warp_win(eye, HW_IMG, HW_IMG)
    h = torch.from_numpy(eye).to(DEVICE)
    for gain in (2, 2.5, 3, 3.5, 4, 5, 6, 8, 12, 16):
        codec = HESICFastCodec(scaled_analysis(model, gain), codec_batch=B)
        enc = codec.transforms_enc(codec._to_device(x1),
                                   codec._to_device(x2), h, win)
        if (pick_mm(int(enc[6]), MM_DEFAULT),
                pick_mm(int(enc[7]), MM_DEFAULT)) == (mm, mm):
            return codec.update(), gain
    raise AssertionError(f"no analysis gain makes both eyes pick grid {mm}")


def check_fast_round_trip(label: str, cdc, a, b, hm, out, rec):
    """Raise unless the fast codec's decode `rec` of `out` (pairs a, b
    under homography hm) gives the encoder's own quantized latents and
    finite reconstructions of the input's shape.  Returns the encoder's
    (y1_hat, y2_hat), NHWC float."""
    import numpy as np
    import torch
    h = torch.from_numpy(np.tile(hm[None], (len(a), 1, 1))).to(DEVICE)
    enc = cdc.transforms_enc(cdc._to_device(a), cdc._to_device(b), h,
                             out["blob"][3])
    want = [enc[i].permute(0, 2, 3, 1).float() for i in (0, 1)]
    for key, w in zip(("y1_hat", "y2_hat"), want):
        if not torch.equal(rec[key], w):
            bad = int((rec[key] != w).sum())
            raise AssertionError(f"{label}: decoded {key} differs from "
                                 f"the encoder's latents at {bad} cells")
    for key in ("x1_hat", "x2_hat"):
        if tuple(rec[key].shape) != a.shape:
            raise AssertionError(f"{label}: {key} shape "
                                 f"{tuple(rec[key].shape)}")
        if not torch.isfinite(rec[key]).all():
            raise AssertionError(f"{label}: {key} not finite")
    return want


def phase_main_path():
    """Five round trips of a batch, over grids mm 4, 16 and 32; returns
    the kernels' launch counts and the identity case's bpp_real."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
    from hesic_tpu_torch.training.recipe import smooth_pairs
    from hesic_tpu_torch.bench import rotated_homography

    model = HESIC(N=N, M=M, K=K, dtype=torch.bfloat16, device=DEVICE,
                  seed=0)
    codec = HESICFastCodec(model, codec_batch=B).update()
    # the escape case: a grid capped at mm=4 and amplified inputs push
    # latents past the grid, so the outlier side-channel is exercised
    hot_codec = HESICFastCodec(model, mm=4, codec_batch=B).update()
    x1, x2 = smooth_pairs(np.random.RandomState(0), B, HW_IMG)
    codec16, gain16 = wide_codec(model, x1, x2, 16)
    codec32, gain32 = wide_codec(model, x1, x2, 32)
    rot = rotated_homography()
    eye = np.eye(3, dtype=np.float32)
    cases = {"identity H": (codec, x1, x2, eye),
             "rotated H": (codec, x1, x2, rot),
             "escape, identity H": (hot_codec, x1 * 20 - 10, x2 * 20 - 10,
                                    eye),
             f"analysis gain {gain16}, identity H": (codec16, x1, x2, eye),
             f"analysis gain {gain32}, rotated H": (codec32, x1, x2, rot)}

    build.launch_counts.clear()
    runs = {}
    for label, (cdc, a, b, hm) in cases.items():
        h = np.tile(hm[None], (B, 1, 1))
        out = cdc.compress_fast(a, b, h)
        rec = cdc.decompress_fast(out["blobs"])
        runs[label] = (out, rec)
    # one pair's container decoded alone (row 0 of a padded chunk), and
    # the list reversed (every pair in another row)
    blobs = runs["identity H"][0]["blobs"]
    alone = codec.decompress_fast(blobs[ALONE])
    reverse = codec.decompress_fast(blobs[::-1])
    launches = dict(build.launch_counts)
    if launches.get("grid_rans_encode") != 2 * len(cases):
        raise AssertionError(f"kernel 2 launched "
                             f"{launches.get('grid_rans_encode')} times in "
                             f"{len(cases)} round trips, not once per eye")

    grids = {g for out, _ in runs.values() for g in out["blob"][1:3]}
    if not {4, 16, 32} <= grids:
        raise AssertionError(f"main path reached grids {sorted(grids)}, "
                             f"not all of 4, 16 and 32")
    for label, (cdc, a, b, hm) in cases.items():
        out, rec = runs[label]
        win = out["blob"][3]
        want = check_fast_round_trip(label, cdc, a, b, hm, out, rec)
        if label == "identity H":
            for key, w in zip(("y1_hat", "y2_hat"), want):
                for what, got, ref in (
                        (f"blob {ALONE} alone", alone[key][0], w[ALONE]),
                        ("the reversed list", reverse[key].flip(0), w)):
                    if not torch.equal(got, ref):
                        bad = int((got != ref).sum())
                        raise AssertionError(f"{label}, {what}: decoded "
                                             f"{key} differs from the "
                                             f"encoder's latents at {bad} "
                                             f"cells")
        if cdc is hot_codec and min(out["outliers"]) == 0:
            raise AssertionError(f"{label}: no latent left the grid")
        extra = (f"; blob {ALONE} alone and the reversed list too"
                 if label == "identity H" else "")
        print(f"main path [{label}, win {win}, mm {out['blob'][1]}/"
              f"{out['blob'][2]}]: bpp_real {out['bpp_real']:.6f}, "
              f"outliers {out['outliers'][0]}/{out['outliers'][1]}, "
              f"encode {out['enctime'] * 1e3:.1f} ms, decode "
              f"{rec['dectime'] * 1e3:.1f} ms wall for {B} pairs; decoded "
              f"latents equal the encoder's{extra}")
    return launches, runs["identity H"][0]["bpp_real"]


def ar_setup():
    """The HESIC+ model and codec at the path's widths, the smooth pairs,
    and the level scan's inputs for both eyes from the model's transforms
    (identity H): {label: (weights, pre, post, y)}."""
    import numpy as np
    import torch
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.models.hesic_plus import HESICPlus
    from hesic_tpu_torch.training.recipe import smooth_pairs

    model = HESICPlus(N=AR_N, M=AR_M, dtype=torch.bfloat16, device=DEVICE,
                      seed=0)
    codec = HESICPlusDeviceCodec(model, mm=AR_MM, groups=AR_GROUPS,
                                 cap=AR_CAP).update()
    x1, x2 = smooth_pairs(np.random.RandomState(1), AR_B, HW_IMG)
    h = torch.eye(3, device=DEVICE).expand(AR_B, 3, 3).contiguous()

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    with torch.no_grad():
        y1, y2, z1, z2 = codec.transforms_enc(codec._to_device(x1),
                                              codec._to_device(x2), h)
        pre1 = nhwc(model.hyper_synthesis1(
            z1.float() + codec._median("entropy_bottleneck1")))
        pre2 = nhwc(model.hyper_synthesis2(
            z2.float() + codec._median("entropy_bottleneck2")))
        # the left prior's stand-in: rounded latents of the same shape
        post = nhwc(torch.round(y1))
    eyes = {"eye 1, no post": (codec.w1, pre1, None, nhwc(y1)),
            "eye 2, post": (codec.w2, pre2, post, nhwc(y2))}
    return model, codec, (x1, x2), eyes


def first_flips_on_margin(y, yh_t, rs_t, rs_k, eps: float):
    """(residuals that differ, of them at each image's first differing
    level, whether all of those lie within eps of a .5 boundary of the
    twin's y - mean)."""
    import torch
    _, hy, wy, _ = y.shape
    diff = rs_k != rs_t
    u = y - (yh_t - rs_t.float())
    margin = (u - torch.floor(u) - 0.5).abs() < eps
    lev = (3 * torch.arange(hy, device=y.device)[:, None]
           + torch.arange(wy, device=y.device)[None, :])
    lev = lev[None, :, :, None].expand_as(diff)
    big = 3 * hy + wy
    first = torch.where(diff, lev, big).amin(dim=(1, 2, 3))
    at_first = diff & (lev == first[:, None, None, None])
    return (int(diff.sum()), int(at_first.sum()),
            bool((margin | ~at_first).all()))


def pairs_plan_text(plan) -> str:
    return (f"D {plan.d}, H {plan.helpers}, ahead {plan.ahead}, R "
            f"{plan.ring}, {plan.blocks} blocks x {plan.threads} threads, "
            f"{plan.smem} B shared, {4 * plan.vec}-byte copies")


# kernel 4's other plan is the one pairs_plan makes for a card of 22 SMs:
# at the HESIC+ point 17 blocks an SM, so 2 helpers and a ring of 4
# stages, against 4 helpers and 16 stages on the H100's 132 SMs
ALT_SMS = 22


@contextlib.contextmanager
def pairs_planned_for(sm_count: int):
    """Kernel 4's wrapper plans as on a card of `sm_count` SMs (with the
    copy width its own plan chooses); yields a plan function."""
    from hesic_tpu_torch.codecs import pairs_rans
    own = pairs_rans.launch_plan

    def plan(starts, freqs):
        return pairs_rans.pairs_plan(*starts.shape, sm_count)._replace(
            vec=own(starts, freqs).vec)

    pairs_rans.launch_plan = plan
    try:
        yield plan
    finally:
        pairs_rans.launch_plan = own


def check_pairs(label: str, st, fr, valid, cap: int):
    """Kernel 4 against its twin: counts, states and the words within
    each count and the cap must be equal.  Returns ((words, counts,
    states), max |err|)."""
    import torch
    from hesic_tpu_torch.codecs import pairs_rans
    enc = pairs_rans.rans_encode_pairs_cuda(st, fr, valid, cap)
    ref = pairs_rans.rans_encode_pairs_plain(st, fr, valid, cap)
    sync()
    words, counts, states = enc
    keep = torch.arange(cap, device=DEVICE)[None, :] < counts[:, None]
    err = max(check_equal(f"pairs counts {label}", counts, ref[1]),
              check_equal(f"pairs states {label}", states, ref[2]),
              check_equal(f"pairs words {label}", words[keep],
                          ref[0][keep]))
    return enc, err


def phase_pairs(label: str, st, fr, valid) -> dict:
    """Kernel 4 against its twin on kernel 5's intervals: at the codec's
    one-launch cap (T words a lane), at a cap below the counts, on a
    seeded mask under which lanes of one group differ, at 21 lanes (a
    ragged lane group) and 37 slots (not a multiple of a stage), and
    under another plan.  Times the kernel at the codec's launch."""
    import torch
    from hesic_tpu_torch.codecs import pairs_rans
    t_slots, lanes = st.shape
    stream, err = check_pairs(label, st, fr, valid, t_slots)
    counts = stream[1]
    cmax = int(counts.max())
    if cmax > t_slots:
        raise AssertionError(f"pairs {label}: a lane counted {cmax} words "
                             f"in {t_slots} slots")
    low = max(1, cmax // 2 - 1)
    errs = [err, check_pairs(f"{label}, cap {low}", st, fr, valid, low)[1]]
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    mixed = valid & (torch.rand(valid.shape, generator=gen,
                                device=DEVICE) < 0.7)
    errs.append(check_pairs(f"{label}, mixed mask", st, fr, mixed,
                            t_slots)[1])
    t_r, l_r = 37, 21
    errs.append(check_pairs(
        f"{label}, {t_r} slots x {l_r} lanes", st[-t_r:, :l_r].contiguous(),
        fr[-t_r:, :l_r].contiguous(), mixed[-t_r:, :l_r].contiguous(),
        t_r)[1])
    plan = pairs_rans.launch_plan(st, fr)
    with pairs_planned_for(ALT_SMS) as alt_plan:
        alt = alt_plan(st, fr)
        errs.append(check_pairs(f"{label}, plan D {alt.d} H {alt.helpers}",
                                st, fr, valid, t_slots)[1])
        alt_ms = cuda_ms(lambda: pairs_rans.rans_encode_pairs_cuda(
            st, fr, valid, t_slots), 100)

    # 100 launches: a window of 10 (~0.6 ms) read 0.051-0.083 ms for one
    # input on the H100
    ms = cuda_ms(lambda: pairs_rans.rans_encode_pairs_cuda(
        st, fr, valid, t_slots), 100)
    plain_ms = cuda_ms(lambda: pairs_rans.rans_encode_pairs_plain(
        st, fr, valid, t_slots), 1)
    # valid slots' (start, freq), every valid byte, the emitted words,
    # counts and states: each read or written once
    nbytes = (8 * int(valid.sum()) + t_slots * lanes
              + 4 * int(counts.sum()) + 12 * lanes)
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"kernel pairs_rans_encode {label}: bit-equal to plain (words, "
          f"counts, states) at cap {t_slots}, at cap {low} (below the "
          f"counts), on a mixed mask, at {t_r} slots x {l_r} lanes and "
          f"under plan {pairs_plan_text(alt)}; {ms:.4f} ms kernel "
          f"(other plan {alt_ms:.4f} ms), {plain_ms:.1f} ms plain, bound "
          f"{bound:.4f} ms by bytes ({nbytes:.3e} B); mean "
          f"{float(counts.double().mean()):.1f} words/lane, max {cmax}; "
          f"plan {pairs_plan_text(plan)}")
    return {"err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "stream": stream}


def phase_wavefront(label: str, w, pre, post, y) -> dict:
    """Kernel 5 (one variant) and kernel 4 against their twins, and
    kernel 5's own round trip through kernel 4."""
    import torch
    from hesic_tpu_torch.models import wavefront as wf
    from hesic_tpu_torch.models.ar_device import (schedule,
                                                  wavefront_valid_mask)
    b, hy, wy, m = y.shape
    w_raw = w.raw   # w is the codec's PackedArWeights

    def teach(fn, yy, ww=w):
        return fn(ww, pre, post, yy, None, None, None, None, None, True,
                  AR_MM, AR_GROUPS)

    valid = wavefront_valid_mask(hy, wy, b, AR_GROUPS, m, DEVICE)
    raw_limit = int(RAW_FLIP_SHARE * y.numel())
    _, _, yh_t, rs_t = teach(wf.ar_wavefront_plain, y, w_raw)
    # inputs on the quantization lattice: no residual may flip there
    lattice_t = teach(wf.ar_wavefront_plain, yh_t, w_raw)

    def readings(ww):
        """Kernel 5 with weights `ww` against the twin with the model's:
        its raw-latent outputs, the raw flips (count, at first levels,
        first ones on the margin) and the lattice readings (residuals that
        differ, max |dy_hat|, |dstart|, |dfreq|)."""
        out = teach(wf.ar_wavefront_cuda, y, ww)
        st2, fr2, yh2, rs2 = teach(wf.ar_wavefront_cuda, yh_t, ww)
        sync()
        raw = first_flips_on_margin(y, yh_t, rs_t, out[3], Y_TOL)
        lat = (int((rs2 != lattice_t[3]).sum()),
               float((yh2 - lattice_t[2]).abs().max()),
               int((st2 - lattice_t[0]).abs()[valid].max()),
               int((fr2 - lattice_t[1]).abs()[valid].max()))
        return out, raw, lat

    def gate(raw, lat):
        """The reasons (raw, lat) fail the gate; empty when it passes."""
        n_lat, d_y, d_st, d_fr = lat
        why = [f"{raw[0]} raw residuals differ (limit {raw_limit})"
               ] if raw[0] > raw_limit else []
        if not raw[2]:
            why.append("a first raw flip lies off the rounding margin")
        if n_lat or d_y > Y_TOL or max(d_st, d_fr) > FREQ_TOL:
            why.append(f"on lattice inputs {n_lat} residuals differ, max "
                       f"|dy_hat| {d_y}, max |dstart| {d_st}, max |dfreq| "
                       f"{d_fr} (limits 0, {Y_TOL}, {FREQ_TOL})")
        return why

    (st_k, fr_k, yh_k, rs_k), raw, lat = readings(w)
    why = gate(raw, lat)
    if why:
        raise AssertionError(f"ar_wavefront {label}: " + "; ".join(why))
    n_raw, n_first, _ = raw
    _, d_y, d_st, d_fr = lat

    # control: the same kernel with its weights rounded to bf16 (half of
    # a bf16 product's operands) must fail the gate
    def bf16(t):
        return t.to(torch.bfloat16).float().contiguous()

    w_bf = w_raw._replace(ctx_kernel=bf16(w_raw.ctx_kernel),
                          ep_kernels=tuple(map(bf16, w_raw.ep_kernels)))
    _, raw_bf, lat_bf = readings(w_bf)
    why_bf = gate(raw_bf, lat_bf)
    if not why_bf:
        raise AssertionError(f"ar_wavefront {label}: the gate passes the "
                             f"bf16-weight control")

    # kernel 4 on kernel 5's intervals, in every regime
    pairs = phase_pairs(label, st_k, fr_k, valid)
    words, counts, states = pairs.pop("stream")

    esc = rs_k.abs() > AR_MM
    cm = esc.to(torch.int32)
    cv = torch.where(esc, rs_k, 0).to(torch.int32)

    def decode():
        return wf.ar_wavefront_cuda(w, pre, post, None, cm, cv, words,
                                    counts, states, False, AR_MM, AR_GROUPS)

    yh_d = decode()[2]
    sync()
    if not torch.equal(yh_d, yh_k):
        bad = int((yh_d != yh_k).sum())
        raise AssertionError(f"ar_wavefront {label}: kernel decode differs "
                             f"from its teacher pass at {bad} cells")

    ms5 = cuda_ms(lambda: teach(wf.ar_wavefront_cuda, y), 3)
    plain5 = cuda_ms(lambda: teach(wf.ar_wavefront_plain, y, w_raw), 1)
    dec_ms = cuda_ms(decode, 3)

    # the hoisted product (pre and post rows of the first layer, every
    # pixel) against its twin, and one level's four stage products as
    # torch.matmul at a full level's rows (a yardstick, never called by
    # the port)
    # H1, H2: the real widths (the bound's work); the kernel runs the
    # packed ones, padded to multiples of 16
    h1, h2 = w_raw.ep_kernels[1].shape
    h1p, h2p = w.w1.shape
    base_k = wf.hoisted_base_cuda(w, pre, post)
    base_p = wf.hoisted_base_plain(w, pre, post)
    sync()
    d_base = float((base_k[..., :h1] - base_p[..., :h1]).abs().max())
    base_lim = HOIST_TOL * float(base_p.abs().max())
    if not d_base <= base_lim:
        raise AssertionError(f"ar_wavefront {label}: hoisted product "
                             f"differs from its twin by {d_base} (limit "
                             f"{base_lim})")
    if base_k[..., h1:].any():
        raise AssertionError(f"ar_wavefront {label}: the hoisted "
                             f"product's padded columns are not 0")
    hoist_ms = cuda_ms(lambda: wf.hoisted_base_cuda(w, pre, post), 10)
    n_levels, _, _, p_max = schedule(hy, wy)
    rows = b * p_max
    shapes = wf.stage_shapes(m, h1p, h2p)
    blocks = wf.stage_blocks(wf.stage_plan(m, h1p, h2p), shapes, rows)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    mats = [(torch.randn(rows, k, generator=gen, device=DEVICE), wt)
            for (k, _), wt in zip(shapes.values(),
                                  (w.tapk, w.w0_ctx, w.w1, w.w2))]
    level_mm_ms = cuda_ms(lambda: [a @ wt for a, wt in mats], 50)

    pix = b * hy * wy
    q = 0 if post is None else post.shape[-1]
    cin = pre.shape[-1] + 2 * m + q
    s = 2 * AR_MM + 1
    flops = 2 * pix * (12 * m * 2 * m + cin * h1 + h1 * h2 + h2 * 2 * m)
    coder_ops = pix * m * ((s + 1) * AR_OPS_PER_EDGE + s * AR_OPS_PER_BIN
                           + AR_OPS_PER_LATENT)
    w_bytes = 4 * sum(t.numel() for t in (
        w_raw.ctx_kernel, w_raw.ctx_bias, *w_raw.ep_kernels,
        *w_raw.ep_biases))
    t_slots, lanes = st_k.shape
    io_bytes = 4 * pix * (cin - 2 * m + 3 * m) + 8 * t_slots * lanes
    bound5 = {"operations": (flops / PEAK_F32_FLOPS
                             + coder_ops / PEAK_F32_OPS) * 1e3,
              "bytes": (w_bytes + io_bytes) / PEAK_BYTES * 1e3}
    by5 = max(bound5, key=bound5.get)
    print(f"kernel ar_wavefront {label}: raw latents {n_raw} residuals "
          f"differ from the twin's ({n_raw / y.numel():.4f} of them, limit "
          f"{RAW_FLIP_SHARE}; {n_first} at each image's first differing "
          f"level, all on the rounding margin); lattice inputs 0 differ, "
          f"max |dy_hat| {d_y:.3e}, max |dstart| {d_st}, max |dfreq| "
          f"{d_fr}; bf16-weight control: raw {raw_bf[0]} differ "
          f"({raw_bf[0] / y.numel():.4f}), first flips on the margin "
          f"{raw_bf[2]}; lattice {lat_bf[0]} differ, max |dy_hat| "
          f"{lat_bf[1]:.3e}, max |dstart| {lat_bf[2]}, max |dfreq| "
          f"{lat_bf[3]}: rejected ({'; '.join(why_bf)}); decode of "
          f"kernel 4's stream bit-equal to the "
          f"teacher pass ({int(esc.sum())} escapes); teacher {ms5:.3f} ms, "
          f"decode {dec_ms:.3f} ms, plain {plain5:.1f} ms; bound "
          f"{bound5[by5]:.4f} ms by {by5} ({flops:.3e} FLOP + "
          f"{coder_ops:.3e} coder ops; {w_bytes + io_bytes:.3e} B); "
          f"{4 * n_levels + 1} stage launches per pass (the hoisted "
          f"product, then ctx and layers 0-2 per level) and {n_levels} "
          f"coder launches; blocks per stage at {rows} rows {blocks}; "
          f"{wf.weight_bytes_per_level(shapes, rows):.3e} weight bytes "
          f"read per level at {rows} rows; hoisted product {hoist_ms:.4f} "
          f"ms (max |d| {d_base:.3e} against its twin, limit "
          f"{base_lim:.3e}); one level's four products as torch.matmul at "
          f"{rows} rows {level_mm_ms:.4f} ms (yardstick); MLP widths H1 "
          f"{h1}, H2 {h2}, packed {h1p}, {h2p}")
    return {
        "wavefront": {"err": d_y, "ms": ms5, "plain_ms": plain5,
                      "bound_ms": bound5[by5], "bound_by": by5,
                      "dec_ms": dec_ms},
        "pairs": pairs,
    }


def phase_hesic_plus_path(model, codec, pairs) -> tuple:
    """Three round trips of a batch of 11 through the HESIC+ device
    codec; returns the kernels' launch counts and the identity case's
    bpp_real."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.bench import rotated_homography

    hot = HESICPlusDeviceCodec(model, mm=1, groups=AR_GROUPS,
                               cap=AR_CAP).update()
    x1, x2 = pairs
    eye = np.eye(3, dtype=np.float32)
    cases = {"identity H": (codec, eye),
             "rotated H": (codec, rotated_homography()),
             "escape (mm 1), identity H": (hot, eye)}
    build.launch_counts.clear()
    runs = {}
    for label, (cdc, hm) in cases.items():
        h = np.tile(hm[None], (AR_B, 1, 1))
        out = cdc.compress(x1, x2, h)
        runs[label] = (out, cdc.decompress(out["strings"]))
    launches = dict(build.launch_counts)
    if launches.get("pairs_rans_encode") != 2 * len(cases):
        raise AssertionError(f"kernel 4 launched "
                             f"{launches.get('pairs_rans_encode')} times in "
                             f"{len(cases)} round trips, not once per eye")

    for label, (cdc, _) in cases.items():
        out, rec = runs[label]
        for key in ("y1_hat", "y2_hat"):
            if not torch.equal(rec[key], out[key]):
                bad = int((rec[key] != out[key]).sum())
                raise AssertionError(f"HESIC+ {label}: decoded {key} "
                                     f"differs from the encoder's at {bad} "
                                     f"cells")
        for key in ("x1_hat", "x2_hat"):
            if tuple(rec[key].shape) != x1.shape:
                raise AssertionError(f"HESIC+ {label}: {key} shape "
                                     f"{tuple(rec[key].shape)}")
            if not torch.isfinite(rec[key]).all():
                raise AssertionError(f"HESIC+ {label}: {key} not finite")
        if cdc is hot and min(out["escapes"]) == 0:
            raise AssertionError(f"HESIC+ {label}: no residual escaped")
        print(f"HESIC+ path [{label}, mm {cdc.mm}]: bpp_real "
              f"{out['bpp_real']:.6f}, escapes {out['escapes'][0]}/"
              f"{out['escapes'][1]}, encode {out['enctime'] * 1e3:.1f} ms, "
              f"decode {rec['dectime'] * 1e3:.1f} ms wall for {AR_B} pairs; "
              f"decoded latents equal the encoder's")
    return launches, runs["identity H"][0]["bpp_real"]


def check_step(label: str, model, opt, before: dict, losses) -> None:
    """Raise on a non-finite loss or gradient, or a parameter group that
    did not move from `before`."""
    import torch
    bad = [i for i, v in enumerate(losses) if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"train {label}: non-finite loss at steps {bad}")
    names = {p: n for n, p in model.named_parameters()}
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"train {label}: gradient of "
                                     f"{names[p]} missing or not finite")
        if all(torch.equal(p.detach(), before[names[p]])
               for p in group["params"]):
            raise AssertionError(f"train {label}: the {group['name']} "
                                 f"group did not move")


def check_warp_backward(dtype) -> str:
    """The training warp's backward (the gather's scatter-add) run under
    torch.use_deterministic_algorithms(True) against the default one, at
    the step's shapes (rotated H); returns a line with the times of
    forward + backward both ways."""
    import torch
    from hesic_tpu_torch.geometry import warp_perspective_train
    from hesic_tpu_torch.bench import rotated_homography
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    src = torch.rand(TRAIN_B, 3, HW_IMG, HW_IMG, generator=gen,
                     device=DEVICE, requires_grad=True)
    h = torch.from_numpy(rotated_homography()).to(DEVICE).expand(
        TRAIN_B, 3, 3).contiguous()
    cot = torch.rand(src.shape, generator=gen, device=DEVICE)

    def grad(deterministic: bool = False):
        out = warp_perspective_train(src, h, dtype)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(deterministic)
        try:
            return torch.autograd.grad(out, src, cot)[0]
        finally:
            torch.use_deterministic_algorithms(was)

    g_det = grad(True)
    det_ms = cuda_ms(lambda: grad(True), 5)
    g = grad()
    ms = cuda_ms(grad, 5)
    sync()
    err = float((g_det - g).abs().max())
    if not err <= 1e-5 * float(g.abs().max()):
        raise AssertionError(f"warp backward: deterministic and default "
                             f"gradients differ by {err}")
    return (f"warp forward+backward (rotated H) {ms:.3f} ms, under "
            f"deterministic algorithms {det_ms:.3f} ms, max |d grad| "
            f"{err:.3e}")


def phase_train(card: str) -> None:
    """bench.py's train point: the full-width step at 512x512, batch 8,
    in bf16 and in f32; one warm-up step, then TRAIN_STEPS timed."""
    import numpy as np
    import torch
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.training.recipe import train_batch, trainer
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = HESIC(N=N, M=M, K=K, dtype=dtype, device=DEVICE, seed=0)
        opt, step, gen = trainer(model)
        batch = train_batch(np.random.RandomState(0), TRAIN_B, HW_IMG,
                            DEVICE)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        losses = [step(batch, gen)["loss"]]
        sync()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(step(batch, gen)["loss"])
        sync()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        check_step(name, model, opt, before, losses)
        print(f"train {name} [{card}]: N{N}/M{M}/K{K} {HW_IMG}x{HW_IMG} "
              f"batch {TRAIN_B}: {ms:.2f} ms a step, "
              f"{TRAIN_B * 1e3 / ms:.2f} pairs/s over {TRAIN_STEPS} steps "
              f"after a warm-up; peak memory {peak / 2 ** 30:.2f} GiB; "
              f"loss {float(losses[0]):.3f} -> {float(losses[-1]):.3f}; "
              f"both groups moved, gradients finite; "
              f"{check_warp_backward(dtype)}")
        del model, opt, step, batch, before, losses
        torch.cuda.empty_cache()


def phase_calibrate(random_bpp: float):
    """bench.py's calibration (training.recipe.calibrate): CAL_STEPS bf16
    steps at CAL_HW, batch CAL_B, then the fast codec's round trip at the
    calibrated weights on phase 5's pairs (identity H).  Returns the round
    trip's launches and the calibrated model."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
    from hesic_tpu_torch.training.recipe import calibrate, smooth_pairs

    def calibrated():
        model = HESIC(N=N, M=M, K=K, dtype=torch.bfloat16, device=DEVICE,
                      seed=0)
        return model, calibrate(model, np.random.RandomState(2), CAL_STEPS,
                                CAL_HW, CAL_B)

    model, (losses, bpps) = calibrated()
    check_same_calibration("HESIC", model, losses, *calibrated())
    for i in range(9, CAL_STEPS, 10):
        print(f"calibrate step {i + 1}: loss {losses[i]:.4f}, bpp "
              f"{bpps[i]:.4f}")
    if not np.isfinite(losses).all():
        raise AssertionError("calibration: non-finite loss")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last < first:
        raise AssertionError(f"calibration: mean loss of the last 10 steps "
                             f"{last} is not below the first 10's {first}")

    codec = HESICFastCodec(model, codec_batch=B).update()
    x1, x2 = smooth_pairs(np.random.RandomState(0), B, HW_IMG)
    eye = np.eye(3, dtype=np.float32)
    build.launch_counts.clear()
    out = codec.compress_fast(x1, x2, np.tile(eye[None], (B, 1, 1)))
    rec = codec.decompress_fast(out["blobs"])
    launches = dict(build.launch_counts)
    check_fast_round_trip("calibrated", codec, x1, x2, eye, out, rec)
    for name in ("gmm_freq", "grid_rans_encode", "grid_rans_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"calibrated round trip never launched "
                                 f"{name}")
    bpp = out["bpp_real"]
    if not bpp < random_bpp:
        raise AssertionError(f"calibrated bpp_real {bpp} is not below the "
                             f"random weights' {random_bpp}")
    print(f"calibrate: mean loss of the first 10 steps {first:.4f}, of the "
          f"last 10 {last:.4f}; bpp (training estimate) {bpps[0]:.4f}"
          f" -> {bpps[-1]:.4f}; calibrated round trip [identity H, "
          f"mm {out['blob'][1]}/{out['blob'][2]}]: bpp_real {bpp:.6f} "
          f"against the random weights' {random_bpp:.6f}, outliers "
          f"{out['outliers'][0]}/{out['outliers'][1]}; decoded latents "
          f"equal the encoder's; launches {launches}")
    return launches, model


def check_same_calibration(label: str, model, losses, twin,
                           twin_run) -> None:
    """Raise unless a second calibration from the same seed (`twin`, its
    (losses, bpps) `twin_run`) ends with every parameter and buffer of
    `model` bit-identical and took the same losses (ROADMAP C5)."""
    import torch
    a, b = model.state_dict(), twin.state_dict()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    steps = [i for i, (u, v) in enumerate(zip(losses, twin_run[0]))
             if u != v]
    if bad or steps:
        raise AssertionError(
            f"{label}: two calibrations from one seed differ in {len(bad)} "
            f"of {len(a)} tensors ({bad[:4]}) and in the losses of "
            f"{len(steps)} steps (first {steps[:1]})")
    print(f"{label}: two calibrations from one seed end bit-identical "
          f"({len(a)} tensors, all {len(losses)} losses equal)")


def strict_sync(codec):
    """Run the codec's compress_fast_start (its non-seeding calls) and
    decompress_fast_batch under torch.cuda.set_sync_debug_mode("error"):
    any host sync inside them raises."""
    import torch

    def strict(fn, seeding=lambda: False):
        def call(*args, **kwargs):
            if seeding():
                return fn(*args, **kwargs)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    codec.compress_fast_start = strict(codec.compress_fast_start,
                                       lambda: codec._next_mm is None)
    codec.decompress_fast_batch = strict(codec.decompress_fast_batch)
    return codec


@functools.cache
def launch_queue_depth(limit: int = 65536) -> int:
    """Kernel launches a stream queues behind a running kernel before the
    next launch blocks the host (CUDA's launch queue): a device sleep,
    then empty kernels launched one by one until a launch waits over
    0.1 s for the sleep.  A kernel with larger parameters takes more of
    the queue, so a real call blocks after at most this many launches."""
    import torch
    torch.cuda._sleep(0)
    sync()
    torch.cuda._sleep(SLEEP_CYCLES)
    for n in range(limit):
        t0 = time.perf_counter()
        torch.cuda._sleep(0)
        if time.perf_counter() - t0 > 0.1:
            break
    sync()
    return n


def runtime_audit(call):
    """Run `call` (the device idle) under torch.profiler: (its kernel
    launches and memsets, its CUDA calls of WAIT_CALLS by name, the
    device copies it made to or from pageable host memory, its
    result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("audited call"):
            out = call()
        sync()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "audited call")
    inside = [e.name for e in events if e.device_type != cuda
              and span.start <= e.time_range.start <= span.end]
    waits = {n: inside.count(n) for n in WAIT_CALLS if n in inside}
    pageable = sorted({e.name for e in events if e.device_type == cuda
                       and e.name.startswith("Memcpy")
                       and "Pageable" in e.name})
    return sum(inside.count(n) for n in LAUNCH_CALLS), waits, pageable, out


def check_no_wait(codec, x1, x2, h, blob) -> str:
    """compress_fast_start and decompress_fast_batch must return while a
    device sleep queued before them still runs: neither may wait for the
    device, by any route (the sync debug mode does not see every one).
    A call that launches more kernels than the launch queue holds
    (launch_queue_depth) blocks on the full queue until the sleep drains
    it; such a call passes only if a profiler audit of it (runtime_audit)
    finds no waiting CUDA call and no copy to or from pageable host
    memory.  Returns a line with the host and device times."""
    import torch
    parts = []
    for name, call in (
            ("compress_fast_start",
             lambda: codec.compress_fast_start(x1, x2, h)),
            ("decompress_fast_batch",
             lambda: codec.decompress_fast_batch(blob))):
        sync()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        out = call()
        host = time.perf_counter() - t0
        busy = not torch.cuda.current_stream().query()
        sync()
        total = time.perf_counter() - t0
        if out.get("mode") == "async":
            codec.compress_fast_finish(out)
        line = (f"{name} returned after {host * 1e3:.1f} ms of a "
                f"{total * 1e3:.1f} ms queue")
        if not (busy and host < 0.5 * total):
            depth = launch_queue_depth()
            launches, waits, pageable, out = runtime_audit(call)
            if out.get("mode") == "async":
                codec.compress_fast_finish(out)
            if waits or pageable or launches <= depth or not busy:
                raise AssertionError(
                    f"{name} waited for the device: it returned after "
                    f"{host * 1e3:.1f} ms of a {total * 1e3:.1f} ms queue "
                    f"(still busy: {busy}; {launches} launches against a "
                    f"launch queue of {depth}; waiting calls {waits}; "
                    f"pageable copies {pageable})")
            line += (f" (blocked on the full launch queue: {launches} "
                     f"launches against a queue of {depth}, no waiting "
                     f"call, no pageable copy)")
        parts.append(line)
    return "; ".join(parts)


def phase_bench(model, card: str, b: int = BENCH_B,
                n_batches: int = BENCH_BATCHES,
                kinds=("identity", "real")) -> tuple:
    """The port's bench loop (hesic_tpu_torch/bench.py) at a bench.py
    point on the calibrated `model` (HESIC or DSIC): batch `b`, mm 16, a
    pool of BENCH_POOL batches cycled over `n_batches`, for each
    homography of `kinds`, modes 2 and 0.  Returns the timed loops'
    launches and the grid widths (mm1 and mm2) their containers
    picked."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build

    name = type(model).__name__
    torch.cuda.reset_peak_memory_stats()
    codec = strict_sync(bench.make_codec(model, 16, b))
    pool = bench.make_pool(np.random.RandomState(1), BENCH_POOL, b, HW_IMG,
                           DEVICE)
    batches = [pool[i % BENCH_POOL] for i in range(n_batches)]
    launches, grids = {}, set()
    for kind in kinds:
        h = bench.homographies(kind, b)
        what = f"{kind} H"
        bench.warm_up(codec, pool, h)
        bench.check_pipelined_bytes(codec, *pool[0], h)
        blob = codec.compress_fast(*pool[1], h, batch_container=True)["blob"]
        print(f"bench {name} [{what}]: "
              f"{check_no_wait(codec, *pool[0], h, blob)} behind a device "
              f"sleep")
        for mode in (2, 0):
            build.launch_counts.clear()
            loop = bench.timed_loop(codec, batches, h, mode)
            counts = dict(build.launch_counts)
            for kernel, n in counts.items():
                launches[kernel] = launches.get(kernel, 0) + n
            for kernel in ("grid_rans_encode", "grid_rans_decode"):
                if counts.get(kernel) != 2 * n_batches:
                    raise AssertionError(
                        f"bench {name} [{what}, mode {mode}]: {kernel} "
                        f"launched {counts.get(kernel)} times for "
                        f"{n_batches} batches, not twice a batch")
            bench.check_exact(codec, batches, h, loop)
            outs = loop["containers"]
            grids.update(v for o in outs for v in o["blob"][1:3])
            print(f"bench {name} [{card}] [{what}, pipeline {mode}]: "
                  f"{n_batches * b / loop['seconds']:.2f} pairs/s "
                  f"({n_batches} batches of {b} {HW_IMG}x{HW_IMG}"
                  f" pairs in {loop['seconds'] * 1e3:.1f} ms), bpp_real "
                  f"{np.mean([o['bpp_real'] for o in outs]):.6f}, grids "
                  f"{sorted({tuple(o['blob'][1:3]) for o in outs})}, "
                  f"outliers {[tuple(o['outliers']) for o in outs]}; "
                  f"pipelined re-encode byte-identical; every container "
                  f"decoded to the encoder's latents; no host sync in "
                  f"compress_fast_start or decompress_fast_batch; peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                  f" GiB; launches {counts}")
            del loop
    return launches, grids


def phase_dsic_path() -> tuple:
    """DSIC's fast codec at full width on 8 pairs (random weights): the
    per-pair and the batch container (grid cap 32), and an escape case
    (amplified inputs, grid capped at mm 4).  Returns the launches and
    the model."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.dsic import DSIC
    from hesic_tpu_torch.models.dsic_fast import DSICFastCodec
    from hesic_tpu_torch.training.recipe import smooth_pairs

    model = DSIC(N=N, M=M, F=DS_F, C=DS_C, K=K, dtype=torch.bfloat16,
                 device=DEVICE, seed=0)
    codec = DSICFastCodec(model, codec_batch=B).update()
    hot = DSICFastCodec(model, mm=4, codec_batch=B).update()
    x1, x2 = smooth_pairs(np.random.RandomState(0), B, HW_IMG)
    eye = np.eye(3, dtype=np.float32)
    cases = {"per-pair": (codec, x1, x2, False),
             "batch container": (codec, x1, x2, True),
             "escape, batch container": (hot, x1 * 20 - 10, x2 * 20 - 10,
                                         True)}
    build.launch_counts.clear()
    runs = {}
    for label, (cdc, a, b, batch) in cases.items():
        out = cdc.compress_fast(a, b, batch_container=batch)
        rec = (cdc.decompress_fast_batch(out["blob"]) if batch
               else cdc.decompress_fast(out["blobs"]))
        sync()
        runs[label] = (out, rec)
    launches = dict(build.launch_counts)
    if launches.get("grid_rans_encode") != 2 * len(cases):
        raise AssertionError(f"DSIC: kernel 2 launched "
                             f"{launches.get('grid_rans_encode')} times in "
                             f"{len(cases)} round trips, not once per eye")
    for name in ("gmm_freq", "grid_rans_encode", "grid_rans_decode"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"DSIC round trips never launched {name}")
    for label, (cdc, a, b, _) in cases.items():
        out, rec = runs[label]
        check_fast_round_trip(f"DSIC {label}", cdc, a, b, eye, out, rec)
        if cdc is hot and min(out["outliers"]) == 0:
            raise AssertionError(f"DSIC {label}: no latent left the grid")
        print(f"DSIC path [{label}, mm {out['blob'][1]}/{out['blob'][2]}]: "
              f"bpp_real {out['bpp_real']:.6f}, outliers "
              f"{out['outliers'][0]}/{out['outliers'][1]}, encode "
              f"{out['enctime'] * 1e3:.1f} ms, decode "
              f"{rec['dectime'] * 1e3:.1f} ms wall for {B} pairs; decoded "
              f"latents equal the encoder's")
    return launches, model


def phase_dsic(card: str) -> tuple:
    """DSIC at bench.py's DSIC point: the round trips of phase_dsic_path,
    then the calibration (training.recipe.calibrate, DSIC's loss without
    H), then the bench loop at batch DS_BENCH_B in modes 2 and 0, then
    kernels 1-3 held at that batch on every grid the loops picked.
    A second DSIC calibrated from the same seed must end bit-identical.
    Returns (launches of the round trips and the timed loops, {grid:
    hold_batch result}, the calibrated model)."""
    import numpy as np
    import torch
    from hesic_tpu_torch.training.recipe import calibrate

    from hesic_tpu_torch.models.dsic import DSIC

    launches, model = phase_dsic_path()
    t0 = time.perf_counter()
    losses, bpps = calibrate(model, np.random.RandomState(2), CAL_STEPS,
                             CAL_HW, CAL_B)
    cal_s = time.perf_counter() - t0
    twin = DSIC(N=N, M=M, F=DS_F, C=DS_C, K=K, dtype=torch.bfloat16,
                device=DEVICE, seed=0)
    check_same_calibration("DSIC", model, losses, twin, calibrate(
        twin, np.random.RandomState(2), CAL_STEPS, CAL_HW, CAL_B))
    del twin
    if not np.isfinite(losses).all():
        raise AssertionError("DSIC calibration: non-finite loss")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last < first:
        raise AssertionError(f"DSIC calibration: mean loss of the last 10 "
                             f"steps {last} is not below the first 10's "
                             f"{first}")
    print(f"DSIC calibrate: {CAL_STEPS} bf16 steps at {CAL_HW}x{CAL_HW}, "
          f"batch {CAL_B}, in {cal_s:.1f} s; mean loss of the first 10 "
          f"steps {first:.4f}, of the last 10 {last:.4f}; bpp (training "
          f"estimate) {bpps[0]:.4f} -> {bpps[-1]:.4f}")
    torch.cuda.empty_cache()
    bench_launches, grids = phase_bench(model, card, DS_BENCH_B,
                                        DS_BENCH_BATCHES, ("identity",))
    for name, n in bench_launches.items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()
    held = {mm: hold_batch(mm, DS_BENCH_B) for mm in sorted(grids)}
    return launches, held, model


def check_loss_falls(label: str, losses, bpps, seconds: float) -> None:
    """Raise on a non-finite loss or unless the mean loss of the last 10
    steps is below the first 10's; print the run."""
    import numpy as np
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label} calibration: non-finite loss")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    if not last < first:
        raise AssertionError(f"{label} calibration: mean loss of the last "
                             f"10 steps {last} is not below the first "
                             f"10's {first}")
    print(f"{label} calibrate: {len(losses)} steps at {CAL_HW}x{CAL_HW}, "
          f"batch {CAL_B}, in {seconds:.1f} s; mean loss of the first 10 "
          f"steps {first:.4f}, of the last 10 {last:.4f}; bpp (training "
          f"estimate) {bpps[0]:.4f} -> {bpps[-1]:.4f}")


def device_round_trips(label: str, cases: dict, eyes: int) -> tuple:
    """Round trips through wavefront device codecs: {case: (codec, compress
    arguments)}.  Decoded latents must equal the encoder's, the
    reconstructions be finite and of the input's shape, kernel 4 launch
    once per level scan and kernel 5 twice (teacher and decode).  Returns
    (launches, {case: (out, rec)})."""
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build
    build.launch_counts.clear()
    runs = {}
    for case, (cdc, args) in cases.items():
        out = cdc.compress(*args)
        runs[case] = (out, cdc.decompress(out["strings"]))
    launches = dict(build.launch_counts)
    want = {"pairs_rans_encode": eyes * len(cases),
            "ar_wavefront": 2 * eyes * len(cases)}
    for name, n in want.items():
        if launches.get(name) != n:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches.get(name)} times in "
                                 f"{len(cases)} round trips, not {n}")
    for case, (cdc, args) in cases.items():
        out, rec = runs[case]
        bench.check_decoded(cdc, out, rec, f"{label} [{case}]")
        for key, x in rec.items():
            if key.startswith("x") and tuple(x.shape) != args[0].shape:
                raise AssertionError(f"{label} [{case}]: {key} shape "
                                     f"{tuple(x.shape)}")
        print(f"{label} [{case}, mm {cdc.mm}]: bpp_real "
              f"{out['bpp_real']:.6f}, escapes {out['escapes']}, encode "
              f"{out['enctime'] * 1e3:.1f} ms, decode "
              f"{rec['dectime'] * 1e3:.1f} ms wall for {AR_B}; decoded "
              f"latents equal the encoder's")
    return launches, runs


def phase_device_bench(model, card: str, label: str, eyes: int) -> dict:
    """The port's bench loop at bench.py's ar-device or hesic-plus-device
    point on the calibrated `model`: one pool batch of AR_B smooth images
    or pairs (seed 1), identity H, the warm-up (exact round trip, the
    threaded encode byte-identical to the synchronous one), then
    AR_BENCH_BATCHES timed batches in modes 1 (encode on a worker thread
    while the main thread decodes) and 0.  Every container must decode to
    the encoder's latents, kernel 4 launch once per level scan and kernel
    5 twice.  Returns the timed loops' launches."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build

    torch.cuda.reset_peak_memory_stats()
    codec = bench.make_device_codec(model, AR_MM, AR_GROUPS)
    pool = bench.make_pool(np.random.RandomState(1), 1, AR_B, HW_IMG,
                           DEVICE)
    h = bench.homographies("identity", AR_B)
    bench.warm_up_device(codec, pool, h)
    batches = [bench.device_args(codec, *pool[0], h)] * AR_BENCH_BATCHES
    item = "images" if eyes == 1 else "pairs"
    launches = {}
    for mode in (1, 0):
        build.launch_counts.clear()
        loop = bench.device_timed_loop(codec, batches, mode)
        counts = dict(build.launch_counts)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        want = {"pairs_rans_encode": eyes * AR_BENCH_BATCHES,
                "ar_wavefront": 2 * eyes * AR_BENCH_BATCHES}
        for name, n in want.items():
            if counts.get(name) != n:
                raise AssertionError(f"bench {label} [pipeline {mode}]: "
                                     f"{name} launched {counts.get(name)} "
                                     f"times for {AR_BENCH_BATCHES} "
                                     f"batches, not {n}")
        bench.check_device_loop(codec, loop)
        outs = loop["containers"]
        print(f"bench {label} [{card}] [identity H, pipeline {mode}]: "
              f"{AR_BENCH_BATCHES * AR_B / loop['seconds']:.2f} {item}/s "
              f"({AR_BENCH_BATCHES} batches of {AR_B} {HW_IMG}x{HW_IMG} "
              f"{item} in {loop['seconds'] * 1e3:.1f} ms), bpp_real "
              f"{np.mean([o['bpp_real'] for o in outs]):.6f}, escapes "
              f"{[o['escapes'] for o in outs]}; threaded re-encode "
              f"byte-identical; every container decoded to the encoder's "
              f"latents; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches {counts}")
        del loop
    return launches


def phase_mbt(card: str) -> tuple:
    """mbt2018 at bench.py's ar-device point: N192/M192 float32 on AR_B
    smooth 512x512 images (the first eyes of phase 6's pairs) through its
    device codec at random weights (mm 16, and mm 1, which must escape),
    then calibrate_single (CAL_STEPS steps), a calibrated round trip
    whose bpp_real must be below the random one's, kernels 5 (no post)
    and 4 held against their twins at the calibrated weights, and the
    bench loop.  Returns (launches of the round trips and the timed
    loops, the kernels' hold, (the calibrated model, its images, the
    device codec's calibrated bpp_real))."""
    import numpy as np
    import torch
    from hesic_tpu_torch.models.ar_device import (
        JointAutoregressiveDeviceCodec)
    from hesic_tpu_torch.models.priors import (
        JointAutoregressiveHierarchicalPriors)
    from hesic_tpu_torch.training.recipe import (calibrate_single,
                                                 smooth_pairs)

    model = JointAutoregressiveHierarchicalPriors(N=AR_N, M=AR_M,
                                                  device=DEVICE, seed=0)

    def codec(mm):
        return JointAutoregressiveDeviceCodec(model, mm=mm,
                                              groups=AR_GROUPS).update()

    x, _ = smooth_pairs(np.random.RandomState(1), AR_B, HW_IMG)
    launches, runs = device_round_trips(
        "mbt2018", {"random weights": (codec(AR_MM), (x,)),
                    "escape (mm 1)": (codec(1), (x,))}, 1)
    if runs["escape (mm 1)"][0]["escapes"] == 0:
        raise AssertionError("mbt2018 escape (mm 1): no residual escaped")
    random_bpp = runs["random weights"][0]["bpp_real"]
    del runs

    t0 = time.perf_counter()
    losses, bpps = calibrate_single(model, np.random.RandomState(2),
                                    CAL_STEPS, CAL_HW, CAL_B)
    check_loss_falls("mbt2018", losses, bpps, time.perf_counter() - t0)
    cal = codec(AR_MM)
    cal_launches, runs = device_round_trips(
        "mbt2018", {"calibrated": (cal, (x,))}, 1)
    bpp = runs["calibrated"][0]["bpp_real"]
    if not bpp < random_bpp:
        raise AssertionError(f"mbt2018: calibrated bpp_real {bpp} is not "
                             f"below the random weights' {random_bpp}")
    print(f"mbt2018: calibrated bpp_real {bpp:.6f} against the random "
          f"weights' {random_bpp:.6f}")
    for name, n in cal_launches.items():
        launches[name] = launches.get(name, 0) + n
    del runs

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    with torch.no_grad():
        xd = cal._to_device(x)
        y = model.analysis(xd)
        z_sym = cal._z_symbols(model.hyper_analysis(y), "entropy_bottleneck")
        pre = nhwc(model.hyper_synthesis(cal._z_hat(z_sym,
                                                    "entropy_bottleneck")))
    held = phase_wavefront("mbt2018 calibrated, no post", cal.w, pre, None,
                           nhwc(y))
    del xd, y, pre
    torch.cuda.empty_cache()
    for name, n in phase_device_bench(model, card, "mbt2018", 1).items():
        launches[name] = launches.get(name, 0) + n
    return launches, held, (model, x, bpp)


def phase_hesic_plus_calibrated(card: str, pairs, random_bpp: float):
    """HESIC+ calibrated as bench.py's hesic-plus-device point does (bf16,
    training.recipe.calibrate: CAL_STEPS steps at CAL_HW, batch CAL_B,
    identity H), a round trip on phase 6's pairs whose bpp_real must be
    below phase 6's random-weights one, then the bench loop.  Returns the
    launches of the round trip and the timed loops, and the calibrated
    model."""
    import numpy as np
    import torch
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.models.hesic_plus import HESICPlus
    from hesic_tpu_torch.training.recipe import calibrate

    model = HESICPlus(N=AR_N, M=AR_M, dtype=torch.bfloat16, device=DEVICE,
                      seed=0)
    t0 = time.perf_counter()
    losses, bpps = calibrate(model, np.random.RandomState(2), CAL_STEPS,
                             CAL_HW, CAL_B)
    check_loss_falls("HESIC+", losses, bpps, time.perf_counter() - t0)
    codec = HESICPlusDeviceCodec(model, mm=AR_MM, groups=AR_GROUPS,
                                 cap=AR_CAP).update()
    h = np.tile(np.eye(3, dtype=np.float32)[None], (AR_B, 1, 1))
    launches, runs = device_round_trips(
        "HESIC+", {"calibrated, identity H": (codec, (*pairs, h))}, 2)
    bpp = runs["calibrated, identity H"][0]["bpp_real"]
    if not bpp < random_bpp:
        raise AssertionError(f"HESIC+: calibrated bpp_real {bpp} is not "
                             f"below the random weights' {random_bpp}")
    print(f"HESIC+: calibrated bpp_real {bpp:.6f} against the random "
          f"weights' {random_bpp:.6f} (phase 6)")
    del runs
    torch.cuda.empty_cache()
    for name, n in phase_device_bench(model, card, "HESIC+", 2).items():
        launches[name] = launches.get(name, 0) + n
    return launches, model


def phase_mbt_host(card: str, model, x, device_bpp: float) -> None:
    """Phase 13: phase 11's calibrated mbt2018 through the host AR codec:
    a round trip of its AR_B images, then the port's bench loop at
    bench.py's ar point (batch HOST_B, HOST_BATCHES timed), every round
    trip exact.  Launches none of the five kernels."""
    import numpy as np
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.autoregressive import host_threads
    from hesic_tpu_torch.models.codec import JointAutoregressiveCodec

    codec = JointAutoregressiveCodec(model).update()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    out = bench.host_round_trip(codec, x, "mbt2018 host codec")
    trip_s = time.perf_counter() - t0
    print(f"mbt2018 host codec [{card}]: {AR_B} {HW_IMG}x{HW_IMG} images "
          f"round trip in {trip_s:.2f} s ({out['coder_s']:.2f} s encode "
          f"and {out['dec_coder_s']:.2f} s decode in the native coder, "
          f"{host_threads(AR_B)} threads); decoded y_hat equals the "
          f"encoder's; bpp_real {out['bpp_real']:.6f} against the device "
          f"codec's {device_bpp:.6f} at the same weights")
    pool = bench.make_pool(np.random.RandomState(0), 1, HOST_B, HW_IMG,
                           DEVICE)
    res = bench.run_host(codec, pool[0][0], HOST_BATCHES)
    no_kernel_launched("the host AR codec")
    print(f"bench mbt2018 host [{card}]: "
          f"{HOST_BATCHES * HOST_B / res['seconds']:.3f} images/s "
          f"({HOST_BATCHES} batches of {HOST_B} in {res['seconds']:.2f} s, "
          f"{res['coder_s']:.2f} s in the native coder, "
          f"{host_threads(HOST_B)} threads, os.cpu_count() "
          f"{os.cpu_count()}), bpp_real {res['bpp_real']:.6f}; every "
          f"round trip exact")


def phase_hesic_plus_host(card: str, model, pairs, random_bpp: float):
    """Phase 14: phase 12's calibrated HESIC+ through its host codec, one
    of phase 6's pairs at the identity H and one at the rotated H; the
    decoded latents must equal the encoder's, bpp_real be below phase 6's
    random-weights one, and a container with the CPU's writer byte be
    refused.  Launches none of the five kernels."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.hesic_plus_codec import (HESICPlusCodec,
                                                         writer_id)

    codec = HESICPlusCodec(model).update()
    x1, x2 = pairs
    build.launch_counts.clear()
    for i, (label, hm) in enumerate((
            ("identity H", np.eye(3, dtype=np.float32)),
            ("rotated H", bench.rotated_homography()))):
        a, b = x1[i:i + 1], x2[i:i + 1]
        out = codec.compress(a, b, hm[None])
        rec = codec.decompress(out["strings"])
        for key in ("y1_hat", "y2_hat"):
            if not torch.equal(rec[key], out[key]):
                bad = int((rec[key] != out[key]).sum())
                raise AssertionError(f"HESIC+ host codec [{label}]: "
                                     f"decoded {key} differs from the "
                                     f"encoder's at {bad} cells")
        for key in ("x1_hat", "x2_hat"):
            x = rec[key]
            if tuple(x.shape) != tuple(a.shape) or not torch.isfinite(
                    x).all():
                raise AssertionError(f"HESIC+ host codec [{label}]: {key} "
                                     f"shape {tuple(x.shape)} or not "
                                     f"finite")
        if not out["bpp_real"] < random_bpp:
            raise AssertionError(f"HESIC+ host codec [{label}]: bpp_real "
                                 f"{out['bpp_real']} is not below the "
                                 f"random weights' {random_bpp}")
        print(f"HESIC+ host codec [{card}] [{label}]: bpp_real "
              f"{out['bpp_real']:.6f} (phase 6's random weights "
              f"{random_bpp:.6f}), encode {out['enctime']:.2f} s, decode "
              f"{rec['dectime']:.2f} s for one {HW_IMG}x{HW_IMG} pair; "
              f"decoded latents equal the encoder's")
    blob = out["strings"][0]
    try:
        codec.decompress([bytes([writer_id("cpu")]) + blob[1:]])
    except ValueError as e:
        print(f"HESIC+ host codec: the CPU writer's container refused "
              f"({e})")
    else:
        raise AssertionError("HESIC+ host codec: a container with the "
                             "CPU's writer byte was not refused")
    no_kernel_launched("the HESIC+ host codec")


def no_kernel_launched(label: str) -> None:
    """Raise if any kernel launched since build.launch_counts was
    cleared."""
    from hesic_tpu_torch.codecs import build
    if build.launch_counts:
        raise AssertionError(f"{label} launched kernels "
                             f"{dict(build.launch_counts)}")


def phase_priors(card: str, x) -> None:
    """Phase 15: bmshj2018-factorized, bmshj2018-hyperprior and
    mbt2018-mean at the zoo's two widths (random seeded weights) through
    their host codecs on images `x`; decoded y_hat must equal the
    encoder's, and the factorized prior's be round(y - medians) +
    medians.  Then mbt2018-mean N128/M192 calibrated by calibrate_single,
    whose round trip must stay exact and whose bpp_real must fall below
    its random weights'.  Launches none of the five kernels."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models import codec as prior_codecs
    from hesic_tpu_torch.models import priors
    from hesic_tpu_torch.training.recipe import calibrate_single

    kinds = {"bmshj2018-factorized": ("FactorizedPrior",
                                      "FactorizedPriorCodec"),
             "bmshj2018-hyperprior": ("ScaleHyperprior",
                                      "ScaleHyperpriorCodec"),
             "mbt2018-mean": ("MeanScaleHyperprior",
                              "MeanScaleHyperpriorCodec")}

    def round_trip(label, cdc):
        out = cdc.compress(x)
        rec = cdc.decompress(out["strings"], out["shape"])
        if not torch.equal(rec["y_hat"], out["y_hat"]):
            bad = int((rec["y_hat"] != out["y_hat"]).sum())
            raise AssertionError(f"{label}: decoded y_hat differs from the "
                                 f"encoder's at {bad} cells")
        xh = rec["x_hat"]
        if tuple(xh.shape) != x.shape or not torch.isfinite(xh).all():
            raise AssertionError(f"{label}: x_hat shape {tuple(xh.shape)} "
                                 f"or not finite")
        print(f"{label} [{card}]: bpp_real {out['bpp_real']:.6f}, encode "
              f"{out['enctime']:.3f} s, decode {rec['dectime']:.3f} s for "
              f"{len(x)} {HW_IMG}x{HW_IMG} images; decoded y_hat equals the "
              f"encoder's")
        return out

    build.launch_counts.clear()
    random_bpp = None
    for kind, (model_name, codec_name) in kinds.items():
        for n, m in PRIOR_WIDTHS:
            model = getattr(priors, model_name)(N=n, M=m, device=DEVICE,
                                                seed=0)
            cdc = getattr(prior_codecs, codec_name)(model).update()
            out = round_trip(f"{kind} N{n}/M{m}, random weights", cdc)
            if model_name == "FactorizedPrior":
                with torch.no_grad():
                    y = model.analysis(cdc._to_device(x))
                med = cdc._median("entropy_bottleneck")
                want = (torch.round(y - med) + med).permute(0, 2, 3, 1)
                if not torch.equal(out["y_hat"], want):
                    raise AssertionError(f"{kind} N{n}/M{m}: y_hat is not "
                                         f"round(y - median) + median")
            if model_name == "MeanScaleHyperprior" and (n, m) == (N, M):
                random_bpp, cal_model = out["bpp_real"], model
            del model, cdc
    t0 = time.perf_counter()
    losses, bpps = calibrate_single(cal_model, np.random.RandomState(2),
                                    CAL_STEPS, CAL_HW, CAL_B)
    check_loss_falls("mbt2018-mean", losses, bpps, time.perf_counter() - t0)
    cdc = prior_codecs.MeanScaleHyperpriorCodec(cal_model).update()
    bpp = round_trip(f"mbt2018-mean N{N}/M{M}, calibrated", cdc)["bpp_real"]
    if not bpp < random_bpp:
        raise AssertionError(f"mbt2018-mean: calibrated bpp_real {bpp} is "
                             f"not below the random weights' {random_bpp}")
    print(f"mbt2018-mean: calibrated bpp_real {bpp:.6f} against the random "
          f"weights' {random_bpp:.6f}")
    no_kernel_launched("the priors' host codecs")


def phase_ref_codecs(card: str, hesic, dsic, plus, pairs) -> None:
    """Phase 16: the reference-layout container codecs at full width and
    calibrated weights (HESICCodec on phase 8's HESIC, DSICCodec on phase
    10's DSIC, HESICPlusRefCodec on phase 12's HESIC+), each on two of
    phase 6's pairs through files in a temporary directory: the first at
    the identity H, the second at the rotated H (DSIC takes none).
    Decoded y1_hat/y2_hat must equal the encoder's, the reconstructions
    be finite and of the input's shape, and decoding with the H passed
    equal decoding with the header's.  Launches none of the five
    kernels."""
    import tempfile

    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.dsic_codec import DSICCodec
    from hesic_tpu_torch.models.hesic_codec import HESICCodec
    from hesic_tpu_torch.models.hesic_plus_refcodec import HESICPlusRefCodec

    x1, x2 = pairs
    hs = (("identity H", np.eye(3, dtype=np.float32)[None]),
          ("rotated H", bench.rotated_homography()[None]))
    ref_codecs = (("HESICCodec", HESICCodec(hesic).update(), True),
                  ("DSICCodec", DSICCodec(dsic).update(), False),
                  ("HESICPlusRefCodec", HESICPlusRefCodec(plus).update(),
                   True))
    build.launch_counts.clear()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cdc, takes_h in ref_codecs:
            for i, (h_label, hm) in enumerate(hs):
                label = f"{name} [{h_label if takes_h else f'pair {i}'}]"
                args = (x1[i:i + 1], x2[i:i + 1]) + ((hm,) if takes_h
                                                     else ())
                out = cdc.compress(*args, f"pair{i}", tmp)
                rec = cdc.decompress(f"pair{i}", tmp)
                for key in ("y1_hat", "y2_hat"):
                    if not torch.equal(rec[key], out[key]):
                        bad = int((rec[key] != out[key]).sum())
                        raise AssertionError(f"{label}: decoded {key} "
                                             f"differs from the encoder's "
                                             f"at {bad} cells")
                for key in ("x1_hat", "x2_hat"):
                    xh = rec[key]
                    if (tuple(xh.shape) != (1, HW_IMG, HW_IMG, 3)
                            or not torch.isfinite(xh).all()):
                        raise AssertionError(f"{label}: {key} shape "
                                             f"{tuple(xh.shape)} or not "
                                             f"finite")
                if takes_h:
                    passed = cdc.decompress(f"pair{i}", tmp, h_matrix=hm)
                    for key in ("y1_hat", "y2_hat", "x1_hat", "x2_hat"):
                        if not torch.equal(passed[key], rec[key]):
                            raise AssertionError(
                                f"{label}: decoding with H passed differs "
                                f"from decoding with the header's ({key})")
                coder = out["coder_s"] + rec["coder_s"]
                wall = out["enctime"] + rec["dectime"]
                print(f"{label} [{card}]: bpp_real {out['bpp_real']:.6f}, "
                      f"bpp_side {out['bpp_side']:.6f}, encode "
                      f"{out['enctime']:.3f} s, decode {rec['dectime']:.3f} "
                      f"s for one {HW_IMG}x{HW_IMG} pair, the host coder "
                      f"{out['coder_s']:.3f} + {rec['coder_s']:.3f} s (share "
                      f"{coder / wall:.3f}); decoded latents equal the "
                      f"encoder's" + ("; the header's H decodes as the H "
                                      "passed" if takes_h else ""))
    no_kernel_launched("the reference-layout codecs")


def phase_cheng(card: str, x) -> tuple:
    """Phase 17: Cheng2020 through the wavefront device codec.
    cheng2020-anchor at quality 4 (N=192, built by the zoo) on AR_B
    images `x`: round trips at random weights (mm 16, and mm 1 on `x`
    amplified by CHENG_ESC_GAIN, which must escape), calibrate_single
    (CAL_STEPS steps), a calibrated round trip whose decoded images' MSE
    must be below the random weights', kernels 5 (no post) and 4 held
    against their twins at the calibrated weights under phase 11's
    gates (on `x` and on the amplified images), the host AR codec's
    round trip of 2 images, and the JAX draw's reading for the record
    (``jax_draw_reading``).
    Then cheng2020-attn at quality 1 (N=128: MLP widths 426 and 341,
    which kernel 5's packing pads to 432 and 352): a device round trip
    and kernels 5 and 4 held on its weights, on the amplified images'
    latents.  Also times the residual
    blocks' 3x3 conv batched and image by image (``image_conv_ms``).
    Returns (the device round trips' launches, {label: hold})."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench, zoo
    from hesic_tpu_torch.models.ar_device import (
        JointAutoregressiveDeviceCodec)
    from hesic_tpu_torch.training.recipe import calibrate_single

    def nhwc(t):
        return t.permute(0, 2, 3, 1).contiguous()

    def level_scan_inputs(cdc, images):
        """The level scan's pre and raw latents of `images` under
        `cdc`."""
        m = cdc.model
        with torch.no_grad():
            y = m.analysis(cdc._to_device(images))
            z_sym = cdc._z_symbols(m.hyper_analysis(y),
                                   "entropy_bottleneck")
            pre = nhwc(m.hyper_synthesis(cdc._z_hat(z_sym,
                                                    "entropy_bottleneck")))
        return pre, nhwc(y)

    def add(total, counts):
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

    t0 = time.perf_counter()
    host = zoo.create_model("cheng2020-anchor", 4, device=DEVICE)
    model = host.model
    label = f"cheng2020-anchor q4 (N={model.N})"
    model_n = model.N
    conv_ms = image_conv_ms(model_n)

    def codec(mm):
        return JointAutoregressiveDeviceCodec(model, mm=mm,
                                              groups=AR_GROUPS).update()

    hot = ((x - 0.5) * CHENG_ESC_GAIN + 0.5).astype(np.float32)
    launches, runs = device_round_trips(
        label, {"random weights": (codec(AR_MM), (x,)),
                "escape (mm 1, amplified)": (codec(1), (hot,))}, 1)
    if runs["escape (mm 1, amplified)"][0]["escapes"] == 0:
        raise AssertionError(f"{label} escape (mm 1): no residual escaped")
    def mse(run):
        return float(((run[1]["x_hat"] - torch.as_tensor(
            x, device=DEVICE)) ** 2).mean())

    random_bpp = runs["random weights"][0]["bpp_real"]
    random_mse = mse(runs["random weights"])
    del runs
    t1 = time.perf_counter()
    losses, bpps = calibrate_single(model, np.random.RandomState(2),
                                    CAL_STEPS, CAL_HW, CAL_B)
    check_loss_falls(label, losses, bpps, time.perf_counter() - t1)
    cal = codec(AR_MM)
    cal_launches, runs = device_round_trips(
        label, {"calibrated": (cal, (x,))}, 1)
    add(launches, cal_launches)
    bpp = runs["calibrated"][0]["bpp_real"]
    cal_mse = mse(runs["calibrated"])
    # the random weights code near-zero latents (bpp_real near its
    # floor), so calibration shows in the decoded images' distortion
    if not cal_mse < random_mse:
        raise AssertionError(f"{label}: the calibrated round trip's MSE "
                             f"{cal_mse} is not below the random weights' "
                             f"{random_mse}")
    print(f"{label}: calibrated round trip MSE {cal_mse:.6f} against the "
          f"random weights' {random_mse:.6f}; bpp_real {bpp:.6f} against "
          f"{random_bpp:.6f}")
    del runs
    # on the images, and on the amplified images, whose latents (|y| up
    # to ~4) reject the bf16-weights control by a wider margin
    held = {}
    for case, images in (("", x), (", amplified images", hot)):
        pre, y = level_scan_inputs(cal, images)
        held[label + case] = phase_wavefront(
            f"{label} calibrated, no post{case}", cal.w, pre, None, y)
        del pre, y
    out = bench.host_round_trip(host.update(), x[:2],
                                f"{label} host codec")
    print(f"{label} host codec [{card}]: 2 images round trip, bpp_real "
          f"{out['bpp_real']:.6f} (the device codec's {bpp:.6f} over "
          f"{AR_B}), {out['coder_s']:.2f} s encode and "
          f"{out['dec_coder_s']:.2f} s decode in the native coder; decoded "
          f"y_hat equals the encoder's")
    del host, model, cal
    torch.cuda.empty_cache()
    jax_draw_reading(card, x)

    attn = zoo.create_model("cheng2020-attn", 1, device=DEVICE).model
    label_a = f"cheng2020-attn q1 (N={attn.N})"
    cdc = JointAutoregressiveDeviceCodec(attn, mm=AR_MM,
                                         groups=AR_GROUPS).update()
    attn_launches, runs = device_round_trips(
        label_a, {"random weights": (cdc, (x,))}, 1)
    add(launches, attn_launches)
    del runs
    # at random weights the latents of images in [0, 1] are near zero,
    # where even the bf16-weights control passes phase 11's gates; the
    # amplified images give latents of the calibrated models' range
    pre, y = level_scan_inputs(cdc, hot)
    held[label_a] = phase_wavefront(f"{label_a}, no post, amplified "
                                    f"images", cdc.w, pre, None, y)
    del attn, cdc, pre, y
    torch.cuda.empty_cache()
    print("kernel ar_wavefront on Cheng2020 [" + card + "]: " + "; ".join(
        f"{k}: teacher {r['wavefront']['ms']:.3f} ms, decode "
        f"{r['wavefront']['dec_ms']:.3f} ms, bound "
        f"{r['wavefront']['bound_ms']:.4f} ms by "
        f"{r['wavefront']['bound_by']} (real widths)"
        for k, r in held.items()) + f"; phase 17 took "
        f"{time.perf_counter() - t0:.1f} s")
    print(f"the residual blocks' f32 3x3 conv ({model_n} channels) at the "
          f"calibration's shape {conv_ms['shape']} [{card}]: batched "
          f"{conv_ms['batched']:.3f} ms (cuDNN's pick under the codecs' "
          f"policy), image by image {conv_ms['per image']:.3f} ms "
          f"(layers.ImageConv)")
    return launches, held


def jax_draw_reading(card: str, x) -> None:
    """For the record, no gate: cheng2020-anchor at quality 4 with the
    JAX package's draw (every conv kaiming-normal, gain sqrt 2, zero
    bias) instead of the port's torch.nn.Conv2d default: the RD loss of
    one calibration step, the level scan's input magnitudes on images
    `x`, and kernel 5 against its twin there (raw residual flips; on
    lattice inputs max |dy_hat| and |dfreq| against Y_TOL and
    FREQ_TOL)."""
    import numpy as np
    import torch
    from hesic_tpu_torch import zoo
    from hesic_tpu_torch.layers import Conv, MaskedConv2d
    from hesic_tpu_torch.layers.conv import _kaiming_
    from hesic_tpu_torch.models import wavefront as wf
    from hesic_tpu_torch.models.ar_device import (
        JointAutoregressiveDeviceCodec, wavefront_valid_mask)
    from hesic_tpu_torch.training.recipe import calibrate_single

    model = zoo.create_model("cheng2020-anchor", 4, device=DEVICE).model
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Conv, MaskedConv2d)):
                w = torch.empty(mod.weight.shape)
                _kaiming_(w, w[0].numel(), gen)
                mod.weight.copy_(w)
                mod.bias.zero_()
    cdc = JointAutoregressiveDeviceCodec(model, mm=AR_MM,
                                         groups=AR_GROUPS).update()
    with torch.no_grad():
        y = model.analysis(cdc._to_device(x))
        z_sym = cdc._z_symbols(model.hyper_analysis(y), "entropy_bottleneck")
        pre = model.hyper_synthesis(cdc._z_hat(z_sym, "entropy_bottleneck"))
    pre = pre.permute(0, 2, 3, 1).contiguous()
    y = y.permute(0, 2, 3, 1).contiguous()

    def teach(fn, w, yy):
        return fn(w, pre, None, yy, None, None, None, None, None, True,
                  AR_MM, AR_GROUPS)

    ref = teach(wf.ar_wavefront_plain, cdc.w.raw, y)
    raw = teach(wf.ar_wavefront_cuda, cdc.w, y)
    lat_t = teach(wf.ar_wavefront_plain, cdc.w.raw, ref[2])
    lat_k = teach(wf.ar_wavefront_cuda, cdc.w, ref[2])
    sync()
    b, hy, wy, m = y.shape
    valid = wavefront_valid_mask(hy, wy, b, AR_GROUPS, m, DEVICE)
    flips = int((raw[3] != ref[3]).sum())
    d_y = float((lat_k[2] - lat_t[2]).abs().max())
    d_fr = int((lat_k[1] - lat_t[1]).abs()[valid].max())
    losses, _ = calibrate_single(model, np.random.RandomState(2), 1, CAL_HW,
                                 CAL_B)
    print(f"cheng2020-anchor q4 with the JAX package's draw, for the record "
          f"[{card}]: RD loss of one calibration step {losses[0]:.4g}; "
          f"|pre| max {float(pre.abs().max()):.4g}, |y| max "
          f"{float(y.abs().max()):.4g}; kernel 5 against its twin: raw "
          f"{flips} residuals differ ({flips / y.numel():.4f}, phase 11's "
          f"limit {RAW_FLIP_SHARE}), on lattice inputs max |dy_hat| "
          f"{d_y:.3e} (Y_TOL {Y_TOL}), max |dfreq| {d_fr} (FREQ_TOL "
          f"{FREQ_TOL})")
    del model, cdc, pre, y, ref, raw, lat_t, lat_k
    torch.cuda.empty_cache()


def image_conv_ms(n: int) -> dict:
    """A stride-1 f32 3x3 conv of `n` channels at the calibration's first
    residual blocks' shape (CAL_B, n, CAL_HW / 2, CAL_HW / 2), batched
    and image by image as layers.ImageConv runs it; ms per call."""
    import torch
    import torch.nn.functional as F
    from hesic_tpu_torch.models.base import deterministic_backends
    deterministic_backends()
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    shape = (CAL_B, n, CAL_HW // 2, CAL_HW // 2)
    a = torch.randn(shape, generator=gen, device=DEVICE)
    w = torch.randn((n, n, 3, 3), generator=gen, device=DEVICE) * 0.02
    return {"shape": shape,
            "batched": cuda_ms(lambda: F.conv2d(a, w, padding=1), 2),
            "per image": cuda_ms(lambda: [
                F.conv2d(a[i:i + 1], w, padding=1)
                for i in range(CAL_B)], 10)}


def phase_stage2(card: str, hesic, dsic, plus, pairs) -> None:
    """Phase 18: stage 2.  HESICTogetherCodec over phase 8's HESIC,
    DSICPlusCodec over phase 10's DSIC and HESICPlusTogetherCodec over
    phase 12's HESIC+, each enhancement from a seed, on one 512x512 pair
    of phase 6's at the identity and the rotated H (DSIC+ takes none: the
    pair at both).  Each decode's *_base must be bit-equal to the inner
    codec's own decode of the same container, and its output bit-equal
    to model.enhance on the base (contiguous NCHW, as the codec passes
    it).  Prints the enhancement's ms a pair and the PSNR of the base
    against the enhanced reconstruction (information only: the
    enhancement is untrained).  Then zoo.create_model for every name at
    its lowest quality on the card: each model's parameters must be on
    the card and its codec the registry's class.  Launches none of the
    five kernels."""
    import tempfile

    import numpy as np
    import torch
    from hesic_tpu_torch import bench, zoo
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.dsic import DSICPlus
    from hesic_tpu_torch.models.dsic_codec import DSICPlusCodec
    from hesic_tpu_torch.models.hesic import HESICTogether
    from hesic_tpu_torch.models.hesic_codec import HESICTogetherCodec
    from hesic_tpu_torch.models.hesic_plus import HESICPlusTogether
    from hesic_tpu_torch.models.hesic_plus_codec import (
        HESICPlusTogetherCodec)

    t0 = time.perf_counter()
    x1, x2 = pairs
    a, b = x1[:1], x2[:1]
    hs = (("identity H", np.eye(3, dtype=np.float32)[None]),
          ("rotated H", bench.rotated_homography()[None]))
    codecs = (
        ("HESICTogetherCodec", HESICTogetherCodec(HESICTogether(
            m1=hesic, seed=1)).update(), True),
        ("DSICPlusCodec", DSICPlusCodec(DSICPlus(m1=dsic, seed=1)).update(),
         False),
        ("HESICPlusTogetherCodec", HESICPlusTogetherCodec(HESICPlusTogether(
            m1=plus, seed=1)).update(), True))

    def nchw(t):
        return t.permute(0, 3, 1, 2).contiguous()

    def psnr(u, v):
        mse = float(((u.float() - v.float()) ** 2).mean())
        return 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")

    build.launch_counts.clear()
    with tempfile.TemporaryDirectory() as tmp:
        for name, cdc, takes_h in codecs:
            if set(cdc.tables) != {f"m1/{k}" for k in cdc.inner.tables}:
                raise AssertionError(f"{name}: tables {sorted(cdc.tables)}")
            for h_label, hm in hs:
                label = f"{name} [{h_label if takes_h else 'no H'}]"
                args = (a, b, hm) if takes_h else (a, b)
                if name == "HESICPlusTogetherCodec":
                    blob = cdc.compress(*args)["strings"]
                    rec = cdc.decompress(blob)
                    ref = cdc.inner.decompress(blob)
                else:
                    cdc.compress(*args, "pair", tmp)
                    rec = cdc.decompress("pair", tmp)
                    ref = cdc.inner.decompress("pair", tmp)
                base = [rec[f"{e}_hat_base"] for e in ("x1", "x2")]
                for e, t in zip(("x1", "x2"), base):
                    if not torch.equal(t, ref[f"{e}_hat"]):
                        raise AssertionError(f"{label}: {e}_hat_base is "
                                             f"not the inner codec's "
                                             f"decode")
                enh_args = [nchw(t) for t in base] + (
                    [cdc._homographies(rec["h_matrix"], 1)[0]]
                    if takes_h else [])
                with torch.no_grad():
                    enh = cdc.model.enhance(*enh_args)
                for e in ("x1", "x2"):
                    got = rec[f"{e}_hat"]
                    if (tuple(got.shape) != (1, HW_IMG, HW_IMG, 3)
                            or not torch.isfinite(got).all()):
                        raise AssertionError(f"{label}: {e}_hat shape "
                                             f"{tuple(got.shape)} or not "
                                             f"finite")
                    if not torch.equal(got, enh[f"{e}_hat"].permute(
                            0, 2, 3, 1)):
                        raise AssertionError(f"{label}: {e}_hat is not "
                                             f"model.enhance of the base")
                enh_ms = cuda_ms(lambda: cdc.model.enhance(*enh_args), 5)
                print(f"{label} [{card}]: *_base bit-equal to the inner "
                      f"codec's decode, output bit-equal to model.enhance "
                      f"on it; enhancement {enh_ms:.3f} ms a "
                      f"{HW_IMG}x{HW_IMG} pair; PSNR of the base against "
                      f"the enhanced (untrained m2, information only) "
                      f"{psnr(base[0], rec['x1_hat']):.2f} / "
                      f"{psnr(base[1], rec['x2_hat']):.2f} dB; decode "
                      f"{rec['dectime']:.3f} s")
                if not takes_h:
                    break
    no_kernel_launched("the Together codecs")
    del codecs
    torch.cuda.empty_cache()

    built = []
    # create_model's default device is the card (a rehearsal on the CPU
    # passes its own)
    where = {} if DEVICE == "cuda" else {"device": DEVICE}
    for name, (model_cls, codec_cls) in zoo.model_architectures.items():
        q = min(zoo.cfgs[name])
        cdc = zoo.create_model(name, q, **where)
        if type(cdc) is not codec_cls or type(cdc.model) is not model_cls:
            raise AssertionError(f"zoo {name}: built {type(cdc).__name__} "
                                 f"over {type(cdc.model).__name__}")
        if not all(p.device.type == torch.device(DEVICE).type
                   for p in cdc.model.parameters()):
            raise AssertionError(f"zoo {name}: parameters off {DEVICE}")
        built.append(f"{name} q{q} {codec_cls.__name__}")
        del cdc
    torch.cuda.empty_cache()
    print(f"zoo [{card}]: every name built on the card at its lowest "
          f"quality as the registry's classes ({'; '.join(built)}); phase "
          f"18 took {time.perf_counter() - t0:.1f} s")


# phase 19: training from image folders and the checkpoints it keeps.
# Stereo folders of TRAIN_PAIRS / TEST_PAIRS pairs at HW_IMG (phase 5's
# smooth images, the right eye the left warped by bench.py's real H), one
# homography-net epoch and one HESIC epoch at bench.py's calibration batch
# and crop (CAL_B, CAL_HW), the reference's tiny HESIC fixture converted
TRAIN_PAIRS, TEST_PAIRS = 8, 2
REF_FIXTURE = os.path.join("tests", "fixtures", "ref_hsic_tiny.pth.tar")


def write_folders(root: str):
    """Phase 19's image folders under `root`, written by the port's PNG
    writer (filter 0): stereo/{train,test}/{left,right} and single/
    {train,test}.  Returns (stereo root, single root, the left views as
    uint8 (n, HW_IMG, HW_IMG, 3), the right views)."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.datasets.image_io import write_png
    from hesic_tpu_torch.geometry.homography import warp_perspective
    from hesic_tpu_torch.training.recipe import smooth_pairs

    n = TRAIN_PAIRS + TEST_PAIRS
    x1, _ = smooth_pairs(np.random.RandomState(19), n, HW_IMG)
    h = torch.from_numpy(bench.rotated_homography())[None].expand(n, 3, 3)
    x2 = warp_perspective(torch.from_numpy(x1).permute(0, 3, 1, 2), h)
    x2 = x2.permute(0, 2, 3, 1).numpy()
    u1, u2 = (np.round(np.clip(a, 0, 1) * 255).astype(np.uint8)
              for a in (x1, x2))
    stereo, single = (os.path.join(root, d) for d in ("stereo", "single"))
    for split, idx in (("train", range(TRAIN_PAIRS)),
                       ("test", range(TRAIN_PAIRS, n))):
        for eye, imgs in (("left", u1), ("right", u2)):
            os.makedirs(os.path.join(stereo, split, eye))
            for i in idx:
                write_png(os.path.join(stereo, split, eye, f"{i:03d}.png"),
                          imgs[i])
        os.makedirs(os.path.join(single, split))
        for i in idx:
            write_png(os.path.join(single, split, f"{i:03d}.png"), u1[i])
    return stereo, single, u1, u2


def checked_load(train_mod, seen: list):
    """A load_checkpoint for the CLI that also holds the state it loaded
    against the file: every model tensor and every Adam tensor bit-equal
    to the payload's.  Appends (the count of tensors held, the file's
    parameters) to `seen`."""
    import numpy as np
    orig = train_mod.load_checkpoint

    def load(path, model, optimizer):
        payload = orig(path, model, optimizer)
        held = 0
        for k, v in model.state_dict().items():
            if not np.array_equal(v.cpu().numpy(), payload["params"][k]):
                raise AssertionError(f"resume: {k} differs from the file")
            held += 1
        names = {id(p): n for n, p in model.named_parameters()}
        for g in optimizer.param_groups:
            for p in g["params"]:
                saved = payload["opt_state"][g["name"]][names[id(p)]]
                for key, v in optimizer.state[p].items():
                    if not np.array_equal(v.cpu().numpy(), saved[key]):
                        raise AssertionError(f"resume: Adam {key} of "
                                             f"{names[id(p)]} differs")
                    held += 1
        seen.append((held, payload["params"]))
        return payload

    return load


def phase_train_cli(card: str) -> dict:
    """Phase 19: train from image folders and keep what was trained.
    Writes the folders, trains the homography net one epoch (batch
    CAL_B), HESIC N=128/M=192/K=5 one epoch in bf16 with that net's H
    (train.main at batch CAL_B, CAL_HW crops), then resumes it for a
    second epoch: the CLI must print its resume line, and the state it
    loaded must equal the file bit for bit.  The trained model_latest.pkl
    goes through zoo.create_model(checkpoint=) and HESICFastCodec on the
    2 test pairs at HW_IMG (real H): exact round trip, kernels 1-3
    launched.  Stage 2 (hesic-together --stage2, f32) one epoch: every m1
    tensor bit-unchanged, m2 moved.  The reference's tiny HESIC is
    converted by `python -m hesic_tpu_torch.utils.convert_torch`, loaded
    by create_model(checkpoint=) and by pretrained=True from a temporary
    zoo cache (equal weights), and round-trips exactly through
    HESICFastCodec and HESICCodec on one test pair.  Returns the fast
    round trips' launches."""
    import io
    import shutil
    import subprocess
    import tempfile

    import numpy as np
    import torch
    from hesic_tpu_torch import bench, zoo
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.datasets import ImageFolder
    from hesic_tpu_torch.models.hesic_codec import HESICCodec
    from hesic_tpu_torch.training import train, train_homography

    t_phase = time.perf_counter()
    hm = bench.rotated_homography()
    launches = {}
    # the entry points' default device is the card (a rehearsal on the
    # CPU passes its own)
    where = {} if DEVICE == "cuda" else {"device": DEVICE}
    dev_args = [] if DEVICE == "cuda" else ["--device", DEVICE]

    def fast_trip(label, cdc, a, b):
        build.launch_counts.clear()
        out = cdc.compress_fast(a, b, np.tile(hm[None], (len(a), 1, 1)))
        rec = cdc.decompress_fast(out["blobs"])
        got = dict(build.launch_counts)
        check_fast_round_trip(label, cdc, a, b, hm, out, rec)
        for name in ("gmm_freq", "grid_rans_encode", "grid_rans_decode"):
            if got.get(name, 0) <= 0:
                raise AssertionError(f"{label}: never launched {name}")
            launches[name] = launches.get(name, 0) + got[name]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stereo, single, u1, u2 = write_folders(tmp)
        single_ds = ImageFolder(single, "train")
        for i in range(len(single_ds)):
            if not np.array_equal(np.round(single_ds[i]["x"] * 255), u1[i]):
                raise AssertionError(f"single folder image {i} does not "
                                     f"read back as written")
        folders_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        homo_dir = os.path.join(tmp, "homo")
        train_homography.main(["--dataset", stereo, "--epochs", "1",
                               "--batch-size", str(CAL_B),
                               "--checkpoint-dir", homo_dir] + dev_args)
        homo_s = time.perf_counter() - t0
        homo = os.path.join(homo_dir, "homo_best.pkl")

        ckpt = os.path.join(tmp, "hesic")
        args = ["--model", "hesic", "--bf16", "--homography-net", homo,
                "--dataset", stereo, "--batch-size", str(CAL_B),
                "--patch-size", str(CAL_HW), "--checkpoint-dir", ckpt,
                "--log-file", os.path.join(tmp, "train_log.txt")] + dev_args
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train.main(args + ["--epochs", "1"])
        first_s = time.perf_counter() - t0
        if first["codec"].model.N != N or first["codec"].model.M != M:
            raise AssertionError("the CLI's HESIC is not at full width")
        trained = {k: v.detach().cpu().numpy().copy()
                   for k, v in first["codec"].model.state_dict().items()}
        ep0 = first["epochs"][0]
        del first
        torch.cuda.empty_cache()
        seen = []
        orig_load = train.load_checkpoint
        train.load_checkpoint = checked_load(train, seen)
        out = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                again = train.main(args + ["--epochs", "2"])
            again_s = time.perf_counter() - t0
        finally:
            train.load_checkpoint = orig_load
        text = out.getvalue()
        print(text, end="")
        resume = os.path.join(ckpt, "checkpoint_best_loss.pkl")
        if f"resumed from {resume} (epoch 1)" not in text or len(seen) != 1:
            raise AssertionError("the second run did not resume from "
                                 "epoch 1")
        # the file the second run loaded held the first run's final state
        for k, v in trained.items():
            if not np.array_equal(seen[0][1][k], v):
                raise AssertionError(f"resume: the file's {k} is not the "
                                     f"first run's")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ep1 = again["epochs"][0]
        del again, trained
        torch.cuda.empty_cache()
        print(f"train CLI [{card}]: HESIC N{N}/M{M}/K{K} bf16, batch "
              f"{CAL_B}, {CAL_HW}x{CAL_HW} crops of {TRAIN_PAIRS} "
              f"{HW_IMG}x{HW_IMG} pairs, the homography net's H: resumed "
              f"epoch 1 with {seen[0][0]} tensors bit-equal to the file "
              f"and the file's weights the first run's; "
              f"{1e3 * ep1['step_s'] / ep1['steps']:.1f} ms a training step "
              f"(homography net included) over epoch 1's {ep1['steps']} "
              f"steps ({1e3 * ep0['step_s'] / ep0['steps']:.1f} over epoch "
              f"0's, the process's first at this shape); epoch 1's loop "
              f"{ep1['data_s'] + ep1['step_s']:.3f} s = data loading "
              f"{ep1['data_s']:.3f} s + steps {ep1['step_s']:.3f} s; "
              f"validation {ep1['val_s']:.3f} s, checkpoints "
              f"{ep1['save_s']:.3f} s; first run {first_s:.1f} s, resumed "
              f"run {again_s:.1f} s; peak memory {peak:.2f} GiB; folders "
              f"{folders_s:.1f} s, homography net epoch {homo_s:.1f} s")
        del seen

        # the trained checkpoint through the zoo and the fast codec
        test1 = u1[TRAIN_PAIRS:].astype(np.float32) / 255
        test2 = u2[TRAIN_PAIRS:].astype(np.float32) / 255
        cdc = zoo.create_model("hesic", checkpoint=os.path.join(
            ckpt, "model_latest.pkl"), dtype=torch.bfloat16,
            **where).update()
        out = fast_trip("trained checkpoint", cdc, test1, test2)
        print(f"trained checkpoint [{card}]: create_model(checkpoint=) -> "
              f"HESICFastCodec on the {TEST_PAIRS} test pairs "
              f"({HW_IMG}x{HW_IMG}, real H): bpp_real {out['bpp_real']:.6f}, "
              f"mm {out['blob'][1]}/{out['blob'][2]}; decoded latents equal "
              f"the encoder's")
        del cdc
        torch.cuda.empty_cache()

        # stage 2 from the CLI: m1 frozen, m2 trained
        before = zoo.create_model("hesic-together", seed=0, **where).model
        m1_before = {k: v.detach().clone()
                     for k, v in before.m1.state_dict().items()}
        m2_before = {k: v.detach().clone()
                     for k, v in before.m2.state_dict().items()}
        del before
        t0 = time.perf_counter()
        st2 = train.main(["--model", "hesic-together", "--stage2",
                          "--homography-net", homo, "--dataset", stereo,
                          "--batch-size", str(CAL_B), "--patch-size",
                          str(CAL_HW), "--epochs", "1", "--checkpoint-dir",
                          os.path.join(tmp, "stage2"), "--log-file",
                          os.path.join(tmp, "stage2_log.txt")] + dev_args)
        st2_s = time.perf_counter() - t0
        model = st2["codec"].model
        for k, v in model.m1.state_dict().items():
            if not torch.equal(v, m1_before[k]):
                raise AssertionError(f"stage 2 moved m1.{k}")
        moved = sum(not torch.equal(v, m2_before[k])
                    for k, v in model.m2.state_dict().items())
        if moved == 0:
            raise AssertionError("stage 2 left m2 unchanged")
        e = st2["epochs"][0]
        print(f"stage 2 CLI [{card}]: hesic-together f32, batch {CAL_B}, "
              f"{CAL_HW}x{CAL_HW}: {len(m1_before)} m1 tensors bit-"
              f"unchanged, {moved} of {len(m2_before)} m2 tensors moved; "
              f"{1e3 * e['step_s'] / e['steps']:.1f} ms a step, run "
              f"{st2_s:.1f} s")
        del st2, model, m1_before, m2_before
        torch.cuda.empty_cache()

        # the reference's trained tiny HESIC, converted and loaded twice
        conv = os.path.join(tmp, "ref_hesic.pkl")
        subprocess.run([sys.executable, "-m",
                        "hesic_tpu_torch.utils.convert_torch", REF_FIXTURE,
                        "--arch", "hesic", "-o", conv], check=True,
                       stdout=subprocess.DEVNULL, timeout=300)
        ref = zoo.create_model("hesic", checkpoint=conv, **where).update()
        zoo_dir = os.path.join(tmp, "zoo")
        os.makedirs(zoo_dir)
        shutil.copy(REF_FIXTURE, os.path.join(zoo_dir,
                                              "hesic-q1-mse.pth.tar"))
        old = os.environ.get("HESIC_ZOO_DIR")
        os.environ["HESIC_ZOO_DIR"] = zoo_dir
        try:
            pre = zoo.create_model("hesic", pretrained=True, **where)
        finally:
            if old is None:
                del os.environ["HESIC_ZOO_DIR"]
            else:
                os.environ["HESIC_ZOO_DIR"] = old
        for k, v in ref.model.state_dict().items():
            if not torch.equal(v, pre.model.state_dict()[k]):
                raise AssertionError(f"pretrained {k} differs from the "
                                     f"converted checkpoint's")
        a, b = test1[:1], test2[:1]
        out = fast_trip("converted reference", ref, a, b)
        ref_codec = HESICCodec(ref.model).update()
        enc = ref_codec.compress(a, b, hm[None], "ref", tmp)
        dec = ref_codec.decompress("ref", tmp)
        for key in ("y1_hat", "y2_hat"):
            if not torch.equal(dec[key], enc[key]):
                raise AssertionError(f"converted reference, HESICCodec: "
                                     f"decoded {key} differs")
        print(f"converted reference [{card}]: {REF_FIXTURE} (N"
              f"{ref.model.N}/M{ref.model.M}/K{ref.model.K}) through "
              f"convert_torch, create_model(checkpoint=) and "
              f"pretrained=True (equal weights): exact round trips on one "
              f"{HW_IMG}x{HW_IMG} test pair (real H): HESICFastCodec "
              f"bpp_real {out['bpp_real']:.6f}, HESICCodec bpp_real "
              f"{enc['bpp_real']:.6f}")
    print(f"phase 19 [{card}]: took {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from hesic_tpu_torch.bench import card_line
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from hesic_tpu_torch.codecs import build
    t0 = time.perf_counter()
    times = build.build_all()
    print(f"built {sorted(times)} in {time.perf_counter() - t0:.1f} s "
          f"(per library from the common start: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(times.items()))
          + ")")

    # every grid width of the codec's buckets at batch 8
    from hesic_tpu_torch.models.hesic_fast import MM_BUCKETS
    for i, mm in enumerate(MM_BUCKETS):
        pmf_r = phase_pmf(mm, seed=2 * i + 1)
        phase_rans(pmf_r.pop("freq"), f"mm={mm}", seed=2 * i + 2)
    # kernels 2 and 3 beyond the buckets, on kernel 1's rows: a codec
    # built with mm 64 (S = 129), ragged lane groups at ppl 1 (10x10
    # latents: 100 lanes, 16-byte copies; 9x10: 90 lanes, 4-byte copies),
    # and bench.py's point (batch 64, mm 16)
    for label, mm, b, hy, wy, ppl in (
            ("mm=64", 64, B, LAT, LAT, PPL),
            ("mm=16 10x10 ppl 1", 16, B, 10, 10, 1),
            ("mm=16 9x10 ppl 1", 16, B, 9, 10, 1)):
        phase_rans(kernel1_rows(mm, 11, b, hy, wy), label, seed=12, ppl=ppl)
        torch.cuda.empty_cache()
    # kernels 1-3 at bench.py's point too (batch 64), kernel 1's rows
    # feeding kernels 2 and 3, on the grids phase 9 runs
    bench_k = {mm: hold_batch(mm) for mm in BENCH_GRIDS}

    model, codec, pairs, eyes = ar_setup()
    ar = {label: phase_wavefront(label, *args)
          for label, args in eyes.items()}
    ar_post = ar["eye 2, post"]
    ar_post["wavefront"]["err"] = max(r["wavefront"]["err"]
                                      for r in ar.values())
    torch.cuda.empty_cache()

    launches, random_bpp = phase_main_path()
    plus_launches, plus_random_bpp = phase_hesic_plus_path(model, codec,
                                                           pairs)
    launches.update(plus_launches)
    del model, codec, eyes, ar
    torch.cuda.empty_cache()

    phase_train(card)
    cal_launches, cal_model = phase_calibrate(random_bpp)
    torch.cuda.empty_cache()
    bench_launches, grids = phase_bench(cal_model, card)
    torch.cuda.empty_cache()
    dsic_launches, _, dsic_model = phase_dsic(card)
    torch.cuda.empty_cache()
    mbt_launches, mbt_held, (mbt_model, mbt_x, mbt_bpp) = phase_mbt(card)
    torch.cuda.empty_cache()
    plus_cal_launches, plus_model = phase_hesic_plus_calibrated(
        card, pairs, plus_random_bpp)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_mbt_host(card, mbt_model, mbt_x, mbt_bpp)
    phase_hesic_plus_host(card, plus_model, pairs, plus_random_bpp)
    print(f"phases 13-14 (the host AR codecs) took "
          f"{time.perf_counter() - t0:.1f} s")
    del mbt_model, mbt_x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_priors(card, pairs[0][:PRIOR_B])
    phase_ref_codecs(card, cal_model, dsic_model, plus_model, pairs)
    print(f"phases 15-16 (the priors' codecs, the reference-layout "
          f"codecs) took {time.perf_counter() - t0:.1f} s")
    # phase 6's first eyes are phase 11's images
    cheng_launches, cheng_held = phase_cheng(card, pairs[0])
    torch.cuda.empty_cache()
    phase_stage2(card, cal_model, dsic_model, plus_model, pairs)
    del pairs, plus_model, cal_model, dsic_model
    torch.cuda.empty_cache()
    cli_launches = phase_train_cli(card)
    for counts in (cal_launches, bench_launches, dsic_launches,
                   mbt_launches, plus_cal_launches, cheng_launches,
                   cli_launches):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    # kernels 4 and 5's errors over every hold: both HESIC+ eyes,
    # mbt2018 and Cheng2020 at N=192 and N=128
    for k in ("wavefront", "pairs"):
        ar_post[k]["err"] = max([ar_post[k]["err"], mbt_held[k]["err"]]
                                + [r[k]["err"] for r in cheng_held.values()])
    for mm in sorted(set(grids) - set(bench_k)):
        bench_k[mm] = hold_batch(mm)
    # the JSON line reports kernels 1-3 at the main path's shape: batch 64
    # on the widest grid phase 9 ran
    pmf_j, rans_j = bench_k[max(grids)]
    names = {"gmm_freq": ("hesic_tpu_torch/codecs/csrc/pmf.cu",
                          "hesic_tpu/codecs/pallas_pmf.py:110", pmf_j),
             "grid_rans_encode": ("hesic_tpu_torch/codecs/csrc/grid_rans.cu",
                                  "hesic_tpu/codecs/pallas_rans.py:153",
                                  rans_j["encode"]),
             "grid_rans_decode": ("hesic_tpu_torch/codecs/csrc/grid_rans.cu",
                                  "hesic_tpu/codecs/pallas_rans.py:258",
                                  rans_j["decode"]),
             "pairs_rans_encode": (
                 "hesic_tpu_torch/codecs/csrc/pairs_rans.cu",
                 "hesic_tpu/codecs/pallas_rans.py:349", ar_post["pairs"]),
             "ar_wavefront": ("hesic_tpu_torch/codecs/csrc/wavefront.cu",
                              "hesic_tpu/models/pallas_wavefront.py:245",
                              ar_post["wavefront"])}
    kernels = []
    for name, (src, replaces, r) in names.items():
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"main path never launched {name}")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
