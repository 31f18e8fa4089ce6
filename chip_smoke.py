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
     product, a teacher pass by kernel (the level kernel, the coder and
     the hoisted product, torch.profiler) with the level plans it ran,
     and one level's four products as torch.matmul (a yardstick); all of
     it again at the benchmark cell's batch of AR_BIG_B = 64 (704 rows a
     level, 16,896 lanes);
     Then C13's functions on the card (phase_c13_routes): the
     interleaved coder through kernels 2 and 3 bit-equal to its twin and
     decoding back; wavefront_encode -> wavefront_decode (kernels 5 and
     4) bit-exact on a tiny level scan; quantize_pmf_device's rows equal
     to the CPU's;
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
     (kernel 5 counts one launch per eye pass, its 251 kernel launches
     included: the hoisted product, then the cluster level kernel and the
     coder per level).  Then (phase_hesic_plus_fast) HESIC+ N=128/M=192 on the
     fast protocol at the benchmark cell's batch of 64: pipelined
     batches in the benchmark loop's order must equal compress's
     containers byte for byte and decode to the encoder's latents, at mm
     16 and at mm 1 with escapes past the start's slab; the start and the
     batch decode must not wait for the device; one traced round trip
     must count as many level-kernel launches
     (count/wavefront_level_launches) as levels (count/scan_levels), new
     containers must carry backend byte 5 and one with byte 4 must be
     refused by name; a timed pipelined pass;
  7. trains HESIC N=128/M=192/K=5 at bench.py's train point (512x512,
     batch 8, lambda 1e-2, Adam 1e-4 main / 1e-3 aux), in bf16 and in
     f32: one warm-up step, whose FLOPs torch's FlopCounterMode counts,
     then 12 timed steps; prints ms a step, pairs/s, FLOPs a step,
     TFLOP/s, mfu_pct_bf16 (of bench.PEAK_TFLOPS, the H100 SXM5's dense
     bf16 rate) and peak memory beside the card's name and power limit;
     raises on a
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
     card.  After each homography's loops, outside them and their launch
     checks, the codec's device_flops at the windows the loops ran at:
     FLOPs a pair, TFLOP/s and mfu_pct_bf16 at mode 2's pairs/s
     (bench.mfu_fields, which raises on a share above 100%), and the
     per-program counts once.  A grid the loops picked that phase 3 did
     not hold at batch 64 is held then;
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
     phase 9's FLOP count and MFU share come with its loops.  DSIC's dense
     warp kernel must launch six times a round trip of one batch (three
     warps an encode, three a decode) in the round trips and the timed
     loops (never in HESIC's).  Then (phase_dense_warp) the dense warp
     kernel against its plain twin (the loop of one addcmul_ a shift):
     bit-equal on bf16 at the bench cell's six calls (batch 32, N 128, C
     32; 256x256, 128x128 and 64x64, two seeds each), at 5 disparities,
     at a width that is no multiple of a row segment and at one that is
     no multiple of 4; float32 within DW_F32_TOL; DenseWarp's cost
     gradient equal to autograd through the loop on bf16 and float32;
     times the kernel and its twin at the cell's shapes beside its bound.
     Then (phase_gdn) GDN's kernel against its plain twin (the op
     sequence it replaces) at the cells' calls, GDN and IGDN, with and
     without the conv's bias: within GDN_ULPS bf16 ulps on at most
     GDN_FLIP_SHARE of the elements (the channel mix's sum order), every
     image of a batch bit-equal to itself alone and in a crop, and the
     conv-bias fold exact on the card; times kernel and twin at batch 64
     beside the byte bound.  The bench loops of phases 9 and 10 (and 12's
     HESIC+) must launch it GDN_CALLS times a batch;
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
     per eye), then, outside the loops, device_flops at batch 11: FLOPs
     a pair, TFLOP/s and mfu_pct_bf16 at mode 1's pairs/s, and the
     per-program counts.  Then the FLOP counts' cross-check: device_flops
     of a tiny HESIC fast codec (N16/M24/K2) and a tiny HESIC+ device
     codec (N16/M32: kernel 5 takes M in multiples of 16), 64x64, one
     seed, on the CPU and on the card, must be equal program by program;
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
     five coder kernels: their coders are host C++ (the range coder,
     rANS), as the JAX package's are (DSIC's transforms launch the dense
     warp's);
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
     launches none of the five coder kernels (DSIC+'s transforms launch
     the dense warp's);
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
 20. evaluates and codes what was trained through the CLIs, each by its
     main(argv) with --device cuda, on phase 19's folders and files and
     on phase 11's calibrated mbt2018 and phase 12's calibrated HESIC+
     (saved by CompressionModel.save before they are freed):
     utils.eval_model of HESIC with phase 19's checkpoint and homography
     net on the 2 test pairs, the real coder (HESICFastCodec's
     reference-layout container) and --entropy-estimation, and the same
     pair through that container must decode to the encoder's latents;
     eval_model --device-codec of HESIC+ on those pairs and of mbt2018 on
     2 of phase 11's images written as an image folder, each device
     codec's own round trip exact (kernels 4 and 5); utils.codec_cli
     encode and decode of one 512x512 PNG with mbt2018 (writer byte 17;
     the decoded PNG equal to the decoder's x_hat rounded);
     utils.update_model on phase 19's checkpoint (the file it writes
     loads and codes a test pair to the container bytes of the
     checkpoint rebuilt in the process); StereoImageFolder(classical_h=
     True) on 2 block-textured 512x512 pairs whose right eye is the left
     warped by bench.py's real H (the estimate's mean transfer error
     below 1 px; a hypothesis batch of repeated points scores -1 on the
     card without raising), and those pairs through HESICFastCodec under
     the estimates (exact round trip, kernels 1-3);
     utils.eval_homography with phase 19's net (MACE, forward ms,
     PyTorch's FLOP count); utils.bench_codecs jpeg -j 2 on 2 images
     (PSNR and MS-SSIM finite).  Prints each row's numbers and the
     phase's seconds beside the card;
 21. runs hesic_tpu_torch.parallel at a world of one (an NCCL process
     group through a file store in the script's temporary directory, a
     (1, 1) mesh): __graft_entry__.py's dry run through the port (one
     HESIC N=8/M=16/K=2 step of make_parallel_train_step at 64x64, then
     sharded_codec_roundtrip of the tiny HESIC, DSIC and HESIC+ codecs,
     each asserting its split round trip bit-exact and its container
     equal to the one-process run's), a line each as the dry run prints
     them; HESIC N=128/M=192/K=5 bf16 at bench.py's train point (512x512,
     batch 8), 2 steps of make_parallel_train_step against 2 of
     make_train_step from the same seeded weights, noise seed and
     determinism policy: every loss and every parameter bit-equal, ms a
     step of each printed; and phase 9's codec (the calibrated HESIC,
     batch 64, mm 16) split by split_compress_fast: for the identity and
     the real H its container must be byte-equal to phase 9's container
     of the same pairs, and split_decompress_fast_batch must give the
     one-process decode's outputs bit for bit.  Kernels 1-5 must launch
     in the phase; prints its seconds;
 22. prints one JSON line with each kernel's numbers (launches: phases 5,
     6, 8, 10, 11, 12, 17, 19, 20 and 21's round trips, phases 9-12's
     timed loops and the FLOP counts of phases 9, 10 and 12 and the
     cross-check; kernels 1-3's times and bounds at batch 64 on the widest
     grid phase 9 ran, kernels 4 and 5's at the HESIC+ point, their
     errors the largest of every hold, mbt2018's and Cheng2020's
     included; the dense warp's summed over the six calls of a DSIC
     round trip at batch 32; GDN's over the 23 calls of a HESIC round
     trip at batch 64, its error in bf16 ulps), then the device line
     {"ok": true, "device": {...}} last.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import shutil
import sys
import tempfile
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
# the benchmark's HESIC+ cell (hesicplus.rig-batch64): kernels 4 and 5 at
# 64 pairs (704 rows a level, 16,896 lanes); its fast protocol on HESIC+
# N=128/M=192 (bf16 transforms, seeded random weights), pipelined over
# PF_BATCHES batches, and the escape fallback with a slab of PF_SLAB
AR_BIG_B, PF_N, PF_BATCHES, PF_SLAB = 64, 128, 4, 64
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
# DSIC's dense warp (codecs/csrc/dense_warp.cu) at the bench cell's calls:
# batch 32, N 128, C 32, the encoder's and the decoder's warps at 256x256,
# 128x128 and 64x64 (each shape twice a round trip, on other inputs);
# then off them: 5 disparities, a width that is no multiple of a row
# segment (200) and one that is no multiple of 4 (90: the element-wise
# loads and stores).  float32 within DW_F32_TOL of the twin (the existing
# tolerance of the port's dense_warp tests); gradients at DW_GRAD_SHAPE.
DW_SIZES = (256, 128, 64)
DW_EXTRA = ((DS_BENCH_B, N, 64, 64, 5), (4, N, 24, 200, DS_C),
            (4, 24, 16, 90, DS_C), (4, 24, 16, 90, 5))
DW_F32_TOL = 1e-6
DW_GRAD_SHAPE = (4, N, 64, 64)
# GDN's kernel (codecs/csrc/gdn.cu) at the cells' calls: N channels at
# 256x256, 128x128 and 64x64 (HESIC's and HESIC+'s seven stacks, DSIC's
# four), GDN and IGDN, at batch 64 and DSIC's 32; 3 channels at 512x512
# (HESIC's right-eye pre-fuse GDN and final IGDN); then off them: C 192
# (HESIC+ at N=192), and H*W no multiple of 8 on both paths.  Each in
# both of the kernel's layouts, contiguous NCHW and channels-last (HESIC+'s
# device codec runs its synthesis stacks channels-last).  The channel
# mix's f32 sum runs in another order than cuDNN's 1x1 convolution, so
# where its bf16 rounding flips, the result moves (through the beta add,
# the rsqrt and the product) by a bf16 ulp or two: at most GDN_ULPS on at
# most GDN_FLIP_SHARE of the elements.
GDN_SIZES = (256, 128, 64)
GDN_EXTRA = ((4, 192, 32, 32), (2, 192, 5, 7), (3, N, 9, 13), (2, N, 7, 9),
             (3, 3, 9, 13), (2, 3, 5, 7))
GDN_ULPS, GDN_FLIP_SHARE = 2, 0.01
# GDN calls of one batch round trip of each fast codec: HESIC and HESIC+
# 21 of N channels (seven stacks of three: analysis1, analysis2, and
# cond2's synthesis1 and re-encoded analysis1 in the encode; synthesis1,
# the re-encode and synthesis2 in the decode) and 2 of 3 channels
# (analysis2's pre-fuse GDN, synthesis2's final IGDN); DSIC 12 (its two
# encoders and two decoders)
GDN_CALLS = {"HESIC": 23, "HESICPlus": 23, "DSIC": 12}
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


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call: `reps` calls captured in one CUDA graph
    and replayed 3 times after a warm-up call and replay, CUDA events.
    The host's work per call (Python, the dispatcher, ctypes) is left out,
    which an eager loop of a call shorter than that work would time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * reps)


def sync():
    import torch
    torch.cuda.synchronize()


# kernel 5's kernels, as kernel_ms groups a pass's device time
LEVEL_KERNELS = ("wavefront_level_kernel", "wavefront_coder_kernel",
                 "wavefront_hoist_kernel")


def kernel_ms(fn, names) -> dict:
    """Device ms of one call of `fn` (after a warm-up) by kernel:
    {name: the summed time of the kernels whose names hold it}, from
    torch.profiler; the first name must have run (the trace may miss a
    pass's first, short kernel: it then reads 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    out = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        for name in names:
            if name in ev.key:
                out[name] += ev.device_time_total / 1e3
    if not out[names[0]]:
        raise AssertionError(f"kernel_ms: no device time for {out}")
    return out


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
    under homography hm, (3, 3) or one per pair) gives the encoder's own
    quantized latents and finite reconstructions of the input's shape.
    Returns the encoder's (y1_hat, y2_hat), NHWC float."""
    import numpy as np
    import torch
    h = torch.from_numpy(np.array(np.broadcast_to(
        hm, (len(a), 3, 3)))).to(DEVICE)
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


def ar_setup(b: int = AR_B):
    """The HESIC+ model and codec at the path's widths, `b` smooth pairs,
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
    x1, x2 = smooth_pairs(np.random.RandomState(1), b, HW_IMG)
    h = torch.eye(3, device=DEVICE).expand(b, 3, 3).contiguous()

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
    import numpy as np
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
    # pixel) against its twin, and one level's four products as
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
    # one teacher pass's device time by kernel, and the level plans
    split = kernel_ms(lambda: teach(wf.ar_wavefront_cuda, y), LEVEL_KERNELS)
    n_levels, _, count, p_max = schedule(hy, wy)
    rows = b * p_max
    shapes = wf.stage_shapes(m, h1p, h2p)
    plans = {int(b * n): wf.level_plan(m, h1p, h2p, int(b * n))
             for n in np.unique(count)}
    full = plans[rows]
    smem = wf.level_smem(m, h1p, h2p, full)
    # the plans' model of a wave: the clusters the card holds at once
    resident = wf.level_clusters(full.cluster, smem, full.tile)
    if resident != wf.CLUSTER_SLOTS[full.cluster]:
        raise AssertionError(f"ar_wavefront {label}: the card holds "
                             f"{resident} clusters of {full.cluster}, "
                             f"level_plan assumes "
                             f"{wf.CLUSTER_SLOTS[full.cluster]}")
    plan_text = ("level plans (rows: bm, cluster, kq, tile -> blocks) "
                 + ", ".join(f"{r}: {p.bm}, {p.cluster}, {p.kq}, {p.tile} "
                             f"-> {wf.level_ctas(p, r)}"
                             for r, p in plans.items())
                 + f"; a full level's {smem} B of shared memory a block, "
                 f"{resident} clusters of {full.cluster} resident at once")
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
          f"{2 * n_levels + 1} launches per pass (the hoisted product, then "
          f"the level kernel and the coder per level); one teacher pass by "
          f"kernel: level {split['wavefront_level_kernel']:.3f} ms, coder "
          f"{split['wavefront_coder_kernel']:.3f} ms, hoist "
          f"{split['wavefront_hoist_kernel']:.4f} ms; {plan_text}; "
          f"hoisted product {hoist_ms:.4f} "
          f"ms (max |d| {d_base:.3e} against its twin, limit "
          f"{base_lim:.3e}); one level's four products as torch.matmul at "
          f"{rows} rows {level_mm_ms:.4f} ms (yardstick); MLP widths H1 "
          f"{h1}, H2 {h2}, packed {h1p}, {h2p}")
    return {
        "wavefront": {"err": d_y, "ms": ms5, "plain_ms": plain5,
                      "bound_ms": bound5[by5], "bound_by": by5,
                      "dec_ms": dec_ms, "split": split},
        "pairs": pairs,
    }


def level_split_at(label: str, w, pre, post, y, b: int = AR_BIG_B) -> dict:
    """Kernel 5's device time by kernel (the level kernel, the coder and
    the hoisted product) for one teacher pass at batch `b`, the images of
    a smaller batch repeated: {name: ms}, printed with the level plans'
    blocks at the full level."""
    from hesic_tpu_torch.models import wavefront as wf
    from hesic_tpu_torch.models.ar_device import schedule

    def tile(t):
        if t is None:
            return None
        reps = -(-b // t.shape[0])
        return t.repeat(reps, 1, 1, 1)[:b].contiguous()

    pre, post, y = tile(pre), tile(post), tile(y)
    split = kernel_ms(lambda: wf.ar_wavefront_cuda(
        w, pre, post, y, None, None, None, None, None, True, AR_MM,
        AR_GROUPS), LEVEL_KERNELS)
    _, _, _, p_max = schedule(y.shape[1], y.shape[2])
    h1p, h2p = w.w1.shape
    full = wf.level_plan(y.shape[-1], h1p, h2p, b * p_max)
    print(f"kernel ar_wavefront {label}, B={b} (the images repeated): one "
          f"teacher pass by kernel: level "
          f"{split['wavefront_level_kernel']:.3f} ms, coder "
          f"{split['wavefront_coder_kernel']:.3f} ms, hoist "
          f"{split['wavefront_hoist_kernel']:.4f} ms; full level plan "
          f"{tuple(full)} -> {wf.level_ctas(full, b * p_max)} blocks")
    return split


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


def phase_hesic_plus_fast(card: str) -> dict:
    """HESIC+ N=128/M=192 (bf16, seeded random weights) on the fast
    protocol at the benchmark cell's batch of AR_BIG_B smooth pairs, mm
    16, 8 groups, and an mm 1 codec whose escapes pass a slab of PF_SLAB
    (the finish's synchronous gather): PF_BATCHES batches (the identity
    and the rotated H in turn) in the benchmark loop's order (decode i-1,
    start i+1, finish i) must give compress's containers byte for byte
    and decode to the encoder's latents; compress_fast_start and
    decompress_fast_batch must not wait for the device (check_no_wait),
    on either codec; then PF_BATCHES timed pipelined iterations.  Returns
    the launch counts."""
    import numpy as np
    import torch
    from hesic_tpu_torch.bench import rotated_homography
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models import ar_device
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.models.hesic_plus import HESICPlus
    from hesic_tpu_torch.training.recipe import smooth_pairs

    model = HESICPlus(N=PF_N, M=AR_M, dtype=torch.bfloat16, device=DEVICE,
                      seed=0)
    rng = np.random.RandomState(5)
    batches = []
    for i in range(PF_BATCHES):
        x1, x2 = smooth_pairs(rng, AR_BIG_B, HW_IMG)
        hm = rotated_homography() if i % 2 else np.eye(3, dtype=np.float32)
        batches.append((torch.from_numpy(x1).to(DEVICE),
                        torch.from_numpy(x2).to(DEVICE),
                        np.tile(hm[None], (AR_BIG_B, 1, 1))))
    build.launch_counts.clear()
    full = ar_device.ESCAPE_CAP
    for mm, slab in ((AR_MM, full), (1, PF_SLAB)):
        codec = HESICPlusDeviceCodec(model, mm=mm,
                                     groups=AR_GROUPS).update()
        ar_device.ESCAPE_CAP = slab
        want = [codec.compress(*b) for b in batches]
        blobs, recs = [], []
        handle, prev = codec.compress_fast_start(*batches[0]), None
        for i in range(PF_BATCHES):
            if prev is not None:
                recs.append(codec.decompress_fast_batch(prev))
            nxt = (codec.compress_fast_start(*batches[i + 1])
                   if i + 1 < PF_BATCHES else None)
            prev = codec.compress_fast_finish(handle)["blob"]
            blobs.append(prev)
            handle = nxt
        recs.append(codec.decompress_fast_batch(prev))
        sync()
        escapes = [w["escapes"] for w in want]
        for i, (w, blob, rec) in enumerate(zip(want, blobs, recs)):
            if blob != w["strings"][0]:
                raise AssertionError(f"HESIC+ fast, mm {mm}: batch {i}'s "
                                     f"pipelined container differs from "
                                     f"compress's")
            for key in ("y1_hat", "y2_hat"):
                if not torch.equal(rec[key], w[key]):
                    raise AssertionError(f"HESIC+ fast, mm {mm}: batch "
                                         f"{i}'s decoded {key} differs "
                                         f"from the encoder's")
        if mm == 1 and min(min(e) for e in escapes) <= slab:
            raise AssertionError(f"HESIC+ fast, mm 1: escapes {escapes} "
                                 f"do not pass the slab of {slab}")
        print(f"HESIC+ fast [mm {mm}, slab {slab}]: {PF_BATCHES} pipelined "
              f"batches of {AR_BIG_B} equal compress's containers and "
              f"decode to the encoder's latents; escapes {escapes}; "
              f"bpp_real {np.mean([w['bpp_real'] for w in want]):.6f}; "
              + check_no_wait(codec, *batches[1], blobs[1]))
    ar_device.ESCAPE_CAP = full
    codec = HESICPlusDeviceCodec(model, mm=AR_MM,
                                 groups=AR_GROUPS).update()
    # the level scans take the cluster level kernel (one traced round
    # trip: count/wavefront_level_launches equals count/scan_levels), new
    # containers carry backend byte 5 and one with byte 4 (the earlier
    # stage kernels' product order) is refused by name
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blob = codec.compress(*batches[0])["strings"][0]
        codec.decompress([blob])
        sync()
    counts = {"scan_levels": 0, "wavefront_level_launches": 0}
    for ev in prof.events():
        name, _, val = ev.name.partition("=")
        if name.startswith("count/") and name[6:] in counts:
            counts[name[6:]] += int(val)
    if not counts["scan_levels"] or len(set(counts.values())) != 1:
        raise AssertionError(f"HESIC+ fast: level scan counters {counts}")
    if blob[0] != 5:
        raise AssertionError(f"HESIC+ fast: backend byte {blob[0]}, not 5")
    try:
        codec.decompress([bytes([4]) + blob[1:]])
    except ValueError as err:
        if "cuda-level-scan" not in str(err):
            raise
        refused = str(err)
    else:
        raise AssertionError("HESIC+ fast: a byte-4 container decoded")
    print(f"HESIC+ fast: one traced round trip counted {counts}; new "
          f"containers carry backend byte 5; a byte-4 container is refused "
          f"({refused})")
    # timed: the loop's order over the batches, after one warm pass
    for timed in (False, True):
        sync()
        t0 = time.perf_counter()
        handle, prev = codec.compress_fast_start(*batches[0]), None
        for i in range(PF_BATCHES):
            if prev is not None:
                codec.decompress_fast_batch(prev)
            nxt = (codec.compress_fast_start(*batches[i + 1])
                   if i + 1 < PF_BATCHES else None)
            prev = codec.compress_fast_finish(handle)["blob"]
            handle = nxt
        codec.decompress_fast_batch(prev)
        sync()
        secs = time.perf_counter() - t0
    print(f"HESIC+ fast [{card}]: {PF_BATCHES} pipelined batches of "
          f"{AR_BIG_B} {HW_IMG}x{HW_IMG} pairs in {secs:.3f} s, "
          f"{PF_BATCHES * AR_BIG_B / secs:.2f} pairs/s (random weights, "
          f"smooth pairs); peak {torch.cuda.max_memory_allocated()} bytes")
    return dict(build.launch_counts)


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
    from hesic_tpu_torch.bench import PEAK_TFLOPS, backend_flags
    from hesic_tpu_torch.models.base import counted_flops
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.training.recipe import train_batch, trainer
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model = HESIC(N=N, M=M, K=K, dtype=dtype, device=DEVICE, seed=0)
        opt, step, gen = trainer(model)
        batch = train_batch(np.random.RandomState(0), TRAIN_B, HW_IMG,
                            DEVICE)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        # the warm-up step under the FLOP counter (bench.py's train point)
        metrics, flops = counted_flops(step, batch, gen)
        losses = [metrics["loss"]]
        sync()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(step(batch, gen)["loss"])
        sync()
        ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        check_step(name, model, opt, before, losses)
        tflops = flops / ms / 1e9
        print(f"train {name} [{card}]: N{N}/M{M}/K{K} {HW_IMG}x{HW_IMG} "
              f"batch {TRAIN_B}: {ms:.2f} ms a step, "
              f"{TRAIN_B * 1e3 / ms:.2f} pairs/s over {TRAIN_STEPS} steps "
              f"after a warm-up; {flops:.6e} FLOPs a step (torch "
              f"FlopCounterMode: the forward's and the backward's matmuls "
              f"and convolutions, not Adam's update), {tflops:.3f} TFLOP/s, "
              f"mfu_pct_bf16 {100 * tflops / PEAK_TFLOPS:.3f} of "
              f"{PEAK_TFLOPS} TFLOP/s under {backend_flags()}; peak memory "
              f"{peak / 2 ** 30:.2f} GiB; "
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
    launches, the grid widths (mm1 and mm2) their containers picked, and
    {kind: the synchronous batch container of pool batch 1}."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.geometry import pick_warp_win, pick_warp_xwin

    name = type(model).__name__
    torch.cuda.reset_peak_memory_stats()
    codec = strict_sync(bench.make_codec(model, 16, b))
    rates = {}
    pool = bench.make_pool(np.random.RandomState(1), BENCH_POOL, b, HW_IMG,
                           DEVICE)
    batches = [pool[i % BENCH_POOL] for i in range(n_batches)]
    launches, grids, blobs = {}, set(), {}
    for kind in kinds:
        h = bench.homographies(kind, b)
        what = f"{kind} H"
        bench.warm_up(codec, pool, h)
        bench.check_pipelined_bytes(codec, *pool[0], h)
        blob = codec.compress_fast(*pool[1], h, batch_container=True)["blob"]
        blobs[kind] = blob
        print(f"bench {name} [{what}]: "
              f"{check_no_wait(codec, *pool[0], h, blob)} behind a device "
              f"sleep")
        for mode in (2, 0):
            build.launch_counts.clear()
            loop = bench.timed_loop(codec, batches, h, mode)
            counts = dict(build.launch_counts)
            add_launches(launches, counts)
            for kernel in ("grid_rans_encode", "grid_rans_decode"):
                if counts.get(kernel) != 2 * n_batches:
                    raise AssertionError(
                        f"bench {name} [{what}, mode {mode}]: {kernel} "
                        f"launched {counts.get(kernel)} times for "
                        f"{n_batches} batches, not twice a batch")
            # DSIC warps three times an encode and three times a decode
            warps = 6 * n_batches if name == "DSIC" else 0
            if counts.get("dense_warp", 0) != warps:
                raise AssertionError(
                    f"bench {name} [{what}, mode {mode}]: dense_warp "
                    f"launched {counts.get('dense_warp', 0)} times for "
                    f"{n_batches} batches, not {warps}")
            gdns = GDN_CALLS[name] * n_batches
            if counts.get("gdn", 0) != gdns:
                raise AssertionError(
                    f"bench {name} [{what}, mode {mode}]: gdn launched "
                    f"{counts.get('gdn', 0)} times for {n_batches} "
                    f"batches, not {GDN_CALLS[name]} a batch")
            bench.check_exact(codec, batches, h, loop)
            outs = loop["containers"]
            grids.update(v for o in outs for v in o["blob"][1:3])
            rates[mode] = n_batches * b / loop["seconds"]
            print(f"bench {name} [{card}] [{what}, pipeline {mode}]: "
                  f"{rates[mode]:.2f} pairs/s "
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
        # the FLOP count, outside the loops and their launch checks, at
        # the warp windows the loops ran at
        build.launch_counts.clear()
        mfu = bench.mfu_fields(codec, HW_IMG, rates[2], bench.PEAK_TFLOPS,
                               win=pick_warp_win(h, HW_IMG, HW_IMG),
                               xwin=pick_warp_xwin(h, HW_IMG, HW_IMG))
        add_launches(launches, build.launch_counts)
        print_mfu(f"bench {name} [{card}] [{what}]", mfu, rates[2],
                  kind == kinds[0])
    return launches, grids, blobs


def warp_inputs(shape, c: int, seed: int, dtype):
    """Seeded dense-warp inputs on the card: features (B, N, H, W) of both
    signs and costs (B, c, H, W) softmaxed over the disparities, as the
    cost volumes give them."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b, _, hh, w = shape
    h1 = torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    cost = torch.softmax(3 * torch.randn((b, c, hh, w), generator=g,
                                         device=DEVICE), dim=1).to(dtype)
    return h1, cost


def warp_bound(b: int, n: int, hh: int, w: int, c: int, itemsize: int):
    """The dense warp's least time on the card: {"bytes": ms, "operations":
    ms}.  Bytes: h1 and the costs read once, the output written once.
    Operations: each tap the inputs need (x + d < W) is one f32
    multiply-add, and on bf16 one rounding, at PEAK_F32_OPS."""
    taps = b * n * hh * sum(min(c, w - x) for x in range(w))
    nbytes = itemsize * (2 * b * n * hh * w + b * c * hh * w)
    ops = taps * (2 if itemsize == 2 else 1)
    return {"bytes": nbytes / PEAK_BYTES * 1e3,
            "operations": ops / PEAK_F32_OPS * 1e3}


def check_warp(label: str, shape, c: int, seed: int, dtype,
               tol: float = 0.0) -> float:
    """The kernel against its twin: bit-equal (tol 0) or within tol;
    returns max |kernel - twin|."""
    import torch
    from hesic_tpu_torch.models import dsic
    h1, cost = warp_inputs(shape, c, seed, dtype)
    got = dsic.dense_warp_cuda(h1, cost)
    want = dsic.dense_warp_plain(h1, cost)
    sync()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"dense_warp {label}: {got.dtype} "
                             f"{tuple(got.shape)} against the twin's "
                             f"{want.dtype} {tuple(want.shape)}")
    if tol == 0:
        same = torch.equal(got.view(torch.int16) if dtype == torch.bfloat16
                           else got.view(torch.int32),
                           want.view(torch.int16) if dtype == torch.bfloat16
                           else want.view(torch.int32))
        err = float((got.float() - want.float()).abs().max())
        if not same:
            raise AssertionError(f"dense_warp {label}: not bit-equal to its "
                                 f"twin (max abs err {err})")
    else:
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"dense_warp {label}: max abs err {err} "
                                 f"above {tol}")
    return err


def phase_dense_warp(card: str) -> dict:
    """DSIC's dense warp kernel against its plain twin (models/dsic.py's
    addcmul_ loop): bit-equal on bf16 at the bench cell's six calls
    (DW_SIZES, two seeds each) and at DW_EXTRA; float32 within DW_F32_TOL;
    the DenseWarp function's cost gradient equal to autograd through the
    loop, in both dtypes, and its output as above.  Times kernel and twin at the cell's
    shapes beside the bound.  Returns the sums over one round trip's six
    calls."""
    import torch
    from hesic_tpu_torch.models import dsic

    t0 = time.perf_counter()
    err = 0.0
    for size in DW_SIZES:
        shape = (DS_BENCH_B, N, size, size)
        for seed in (1, 2):
            err = max(err, check_warp(f"bf16 {shape} C={DS_C} seed {seed}",
                                      shape, DS_C, 100 * size + seed,
                                      torch.bfloat16))
        torch.cuda.empty_cache()
    for b, n, hh, w, c in DW_EXTRA:
        err = max(err, check_warp(f"bf16 {(b, n, hh, w)} C={c}",
                                  (b, n, hh, w), c, w + c, torch.bfloat16))
    f32_err = 0.0
    for b, n, hh, w, c in ((8, N, 128, 128, DS_C), (4, 24, 16, 90, 5)):
        f32_err = max(f32_err, check_warp(
            f"float32 {(b, n, hh, w)} C={c}", (b, n, hh, w), c, 7 + w,
            torch.float32, DW_F32_TOL))
    for dtype in (torch.bfloat16, torch.float32):
        h1, cost = warp_inputs(DW_GRAD_SHAPE, DS_C, 5, dtype)
        g = torch.randn(DW_GRAD_SHAPE, device=DEVICE,
                        generator=torch.Generator(device=DEVICE)
                        .manual_seed(6)).to(dtype)
        ref = cost.clone().requires_grad_(True)
        fn = cost.clone().requires_grad_(True)
        want = dsic.dense_warp_plain(h1, ref)
        want.backward(g)
        got = dsic.DenseWarp.apply(h1, fn)
        got.backward(g)
        sync()
        out_err = float((got - want).detach().abs().max())
        tol = DW_F32_TOL if dtype == torch.float32 else 0.0
        if not (out_err <= tol and torch.equal(fn.grad, ref.grad)):
            raise AssertionError(
                f"dense_warp {dtype}: DenseWarp's output or cost gradient "
                f"differs from autograd through the loop (max abs "
                f"{out_err}, {float((fn.grad - ref.grad).abs().max())})")
        if dtype == torch.float32:
            f32_err = max(f32_err, out_err)
    print(f"dense_warp: bit-equal to its twin on bf16 at the DSIC cell's "
          f"six calls (B={DS_BENCH_B}, N={N}, C={DS_C}; {DW_SIZES}) and at "
          f"{DW_EXTRA}; float32 max abs err {f32_err:.3e} (limit "
          f"{DW_F32_TOL}); DenseWarp's cost gradient equal to autograd "
          f"through the loop at {DW_GRAD_SHAPE}, bf16 and float32")

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    bys = set()
    for size in DW_SIZES:
        shape = (DS_BENCH_B, N, size, size)
        h1, cost = warp_inputs(shape, DS_C, size, torch.bfloat16)
        ms = cuda_ms(lambda: dsic.dense_warp_cuda(h1, cost), 20)
        plain_ms = cuda_ms(lambda: dsic.dense_warp_plain(h1, cost), 3)
        bound = warp_bound(*shape, DS_C, 2)
        by = max(bound, key=bound.get)
        bys.add(by)
        print(f"kernel dense_warp bf16 {shape} C={DS_C} [{card}]: "
              f"{ms:.4f} ms kernel, {plain_ms:.3f} ms plain, bound "
              f"{bound[by]:.4f} ms by {by} (bytes {bound['bytes']:.4f} ms), "
              f"{100 * bound[by] / ms:.1f}% of it")
        # each shape is warped twice a round trip: encoder and decoder
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound[by])):
            total[k] += 2 * v
        del h1, cost
        torch.cuda.empty_cache()
    print(f"kernel dense_warp, the six calls of a DSIC round trip at batch "
          f"{DS_BENCH_B} [{card}]: {total['ms']:.4f} ms kernel, "
          f"{total['plain_ms']:.3f} ms plain, bound {total['bound_ms']:.4f} "
          f"ms; phase {time.perf_counter() - t0:.1f} s")
    return {**total, "err": err, "bound_by": "/".join(sorted(bys))}


def gdn_inputs(shape, seed: int):
    """Seeded GDN inputs on the card: x (B, C, H, W) as a conv's output
    gives it, the conv's bias, beta in [1, 2) and gamma 0.1 I plus
    cross-channel terms up to 0.01, all bf16."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    c = shape[1]
    bf16 = torch.bfloat16
    x = (1.5 * torch.randn(shape, generator=g, device=DEVICE)).to(bf16)
    bias = (0.3 * torch.randn(c, generator=g, device=DEVICE)).to(bf16)
    beta = (1 + torch.rand(c, generator=g, device=DEVICE)).to(bf16)
    gamma = (0.1 * torch.eye(c, device=DEVICE) + 0.01 * torch.rand(
        (c, c), generator=g, device=DEVICE)).to(bf16)
    return x, bias, beta, gamma


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps, element by element (the bit patterns as
    ordered integers)."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def gdn_bound(shape) -> float:
    """The GDN pass's least time on the card, ms: x read once and the
    result written once, bf16, at PEAK_BYTES (the parameters are a few
    KB)."""
    n = 1
    for d in shape:
        n *= d
    return 2 * 2 * n / PEAK_BYTES * 1e3


def check_gdn(label: str, shape, inverse: bool, seed: int) -> tuple:
    """The kernel against its twin with the conv's bias, and without one
    against the twin without, on x contiguous and on x channels-last: at
    most GDN_ULPS bf16 ulps apart on at most GDN_FLIP_SHARE of the
    elements, finite where the twin is, and the result in x's layout.
    Returns (max ulps, share of elements that differ, share of elements
    where the kernel's two layouts differ)."""
    import torch
    from hesic_tpu_torch.layers import gdn
    x, bias, beta, gamma = gdn_inputs(shape, seed)
    last = torch.channels_last
    worst, share, layouts = 0, 0.0, 0.0
    for b in (bias, None):
        got = {}
        for fmt in (torch.contiguous_format, last):
            xf = x.contiguous(memory_format=fmt)
            out = gdn.gdn_cuda(xf, beta, gamma, inverse, b)
            want = gdn.gdn_plain(xf, beta, gamma, inverse, None, b)
            sync()
            where = (f"gdn {label}{'' if b is not None else ', no bias'}"
                     f"{', channels-last' if fmt is last else ''}")
            if out.dtype != want.dtype or out.shape != want.shape:
                raise AssertionError(f"{where}: {out.dtype} "
                                     f"{tuple(out.shape)} against the "
                                     f"twin's {want.dtype} "
                                     f"{tuple(want.shape)}")
            if not out.is_contiguous(memory_format=fmt):
                raise AssertionError(f"{where}: the result left x's layout")
            if not torch.equal(torch.isfinite(out), torch.isfinite(want)):
                raise AssertionError(f"{where}: not finite where the twin "
                                     f"is")
            gap = bf16_ulps(out, want)
            worst = max(worst, int(gap.max()))
            share = max(share, float((gap > 0).float().mean()))
            if worst > GDN_ULPS or share > GDN_FLIP_SHARE:
                raise AssertionError(
                    f"{where}: {worst} ulps on {100 * share:.3f}% of the "
                    f"elements (limits {GDN_ULPS} on "
                    f"{100 * GDN_FLIP_SHARE}%)")
            got[fmt] = out
        layouts = max(layouts, float(
            (got[last] != got[torch.contiguous_format]).float().mean()))
    return worst, share, layouts


def phase_gdn(card: str) -> dict:
    """GDN's kernel (codecs/csrc/gdn.cu) against its plain twin
    (layers/gdn.py's gdn_plain) at the cells' calls (GDN_SIZES by N
    channels at batch 64 and DSIC's 32, GDN and IGDN; 3 channels at
    512x512) and at GDN_EXTRA, contiguous and channels-last, within
    GDN_ULPS on GDN_FLIP_SHARE; every image of a batch bit-equal to the
    same image alone and to a crop of it (a pixel's result depends on its
    own column only), in both layouts; the conv-bias fold exact on the
    card in both layouts (cuDNN's product plus the bias equal to the conv
    with its bias, and conv_gdn equal to the kernel on the biased conv
    output).  Times kernel (device time, graph_ms) and twin beside the
    byte bound at batch 64, in both layouts.  Returns the sums over the
    GDN calls of a HESIC batch round trip (GDN_CALLS), contiguous."""
    import torch
    from hesic_tpu_torch.layers import GDN, Conv, Deconv, conv_gdn, gdn

    t0 = time.perf_counter()
    last = torch.channels_last
    worst, share, layouts = 0, 0.0, 0.0
    cases = [((b, N, size, size), inverse)
             for b in (BENCH_B, DS_BENCH_B) for size in GDN_SIZES
             for inverse in (False, True)]
    cases += [((BENCH_B, 3, HW_IMG, HW_IMG), inverse)
              for inverse in (False, True)]
    cases += [(shape, inverse) for shape in GDN_EXTRA
              for inverse in (False, True)]
    for i, (shape, inverse) in enumerate(cases):
        label = f"{'IGDN' if inverse else 'GDN'} {shape}"
        w, sh, lay = check_gdn(label, shape, inverse, 50 + i)
        worst, share = max(worst, w), max(share, sh)
        layouts = max(layouts, lay)
        torch.cuda.empty_cache()
    print(f"gdn: against its twin at the cells' calls and {GDN_EXTRA}, "
          f"contiguous and channels-last: at most {worst} bf16 ulps, on at "
          f"most {100 * share:.4f}% of the elements (limits {GDN_ULPS}, "
          f"{100 * GDN_FLIP_SHARE}%); the kernel's two layouts differ on "
          f"at most {100 * layouts:.4f}% of the elements")

    for c in (N, 3):
        for fmt in (torch.contiguous_format, last):
            x, bias, beta, gamma = gdn_inputs((BENCH_B, c, 64, 64), 7)
            x = x.contiguous(memory_format=fmt)
            for inverse in (False, True):
                whole = gdn.gdn_cuda(x, beta, gamma, inverse, bias)
                crop = gdn.gdn_cuda(
                    x[:, :, 8:40, 4:60].contiguous(memory_format=fmt), beta,
                    gamma, inverse, bias)
                if not torch.equal(crop, whole[:, :, 8:40, 4:60]):
                    raise AssertionError(f"gdn C={c} {fmt}: a crop's result "
                                         f"differs from the whole image's")
                for i in (0, 37, BENCH_B - 1):
                    alone = gdn.gdn_cuda(
                        x[i:i + 1].contiguous(memory_format=fmt), beta,
                        gamma, inverse, bias)
                    if not torch.equal(alone, whole[i:i + 1]):
                        raise AssertionError(
                            f"gdn C={c} {fmt}: image {i} alone differs "
                            f"from image {i} of a batch of {BENCH_B}")

    g = torch.Generator().manual_seed(3)
    bf16 = torch.bfloat16
    for conv, hw_in in ((Conv(N, N, dtype=bf16, generator=g), 256),
                        (Deconv(N, N, dtype=bf16, generator=g), 64)):
        layer = GDN(N, inverse=isinstance(conv, Deconv), dtype=bf16)
        with torch.no_grad():
            conv.bias.normal_(0, 0.3, generator=g)
            layer.gamma.add_(0.05)
        conv.to(DEVICE).requires_grad_(False)
        layer.to(DEVICE).requires_grad_(False)
        for fmt in (torch.contiguous_format, last):
            x = torch.randn((8, N, hw_in, hw_in), device=DEVICE).contiguous(
                memory_format=fmt)
            with torch.no_grad():
                bare = conv(x, with_bias=False)
                biased = conv(x)
                if not torch.equal(biased, bare + conv.bias.to(bf16)[
                        :, None, None]):
                    raise AssertionError(f"{type(conv).__name__} {fmt}: "
                                         f"cuDNN's output with its bias is "
                                         f"not the bias-free output plus "
                                         f"the bias")
                folded = conv_gdn(conv, layer, x)
                if not folded.is_contiguous(memory_format=fmt):
                    raise AssertionError(f"{type(conv).__name__} + GDN "
                                         f"{fmt}: the result left the "
                                         f"conv's layout")
                if not torch.equal(folded, layer(biased)):
                    raise AssertionError(f"{type(conv).__name__} + GDN "
                                         f"{fmt}: the folded bias differs "
                                         f"from the kernel on the biased "
                                         f"output")
    print(f"gdn: every image of a batch of {BENCH_B} equals itself alone "
          "and in a crop; cuDNN's conv and deconv with a bias equal the "
          "bias-free output plus the bias, and the folded pair equals the "
          "kernel on the biased output, bit for bit, contiguous and "
          "channels-last")

    timed = {}
    for c, size in [(N, s) for s in GDN_SIZES] + [(3, HW_IMG)]:
        shape = (BENCH_B, c, size, size)
        x, bias, beta, gamma = gdn_inputs(shape, size + c)
        xl = x.contiguous(memory_format=last)
        for inverse in (False, True):
            ms = graph_ms(lambda: gdn.gdn_cuda(x, beta, gamma, inverse,
                                               bias), 20)
            ms_last = graph_ms(lambda: gdn.gdn_cuda(xl, beta, gamma, inverse,
                                                    bias), 20)
            eager_ms = cuda_ms(lambda: gdn.gdn_cuda(x, beta, gamma, inverse,
                                                    bias), 20)
            plain_ms = cuda_ms(lambda: gdn.gdn_plain(x, beta, gamma,
                                                     inverse, None, bias), 3)
            bound = gdn_bound(shape)
            timed[c, size, inverse] = (ms, plain_ms, bound)
            print(f"kernel gdn {'IGDN' if inverse else 'GDN'} bf16 {shape} "
                  f"[{card}]: {ms:.4f} ms kernel (device, a graph of 20; "
                  f"channels-last {ms_last:.4f}; an eager loop "
                  f"{eager_ms:.4f}), {plain_ms:.3f} ms plain, bound "
                  f"{bound:.4f} ms by bytes, {100 * bound / ms:.1f}% of it "
                  f"({100 * bound / ms_last:.1f}% channels-last)")
        del x, xl
        torch.cuda.empty_cache()
    # a HESIC batch round trip: seven N-channel stacks, each a GDN or IGDN
    # at every size (GDN and IGDN averaged), and the two 3-channel calls
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for (c, _, _), (ms, plain_ms, bound) in timed.items():
        calls = 3.5 if c == N else 1.0
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
            total[k] += calls * v
    print(f"kernel gdn, the {GDN_CALLS['HESIC']} calls of a HESIC round "
          f"trip at batch {BENCH_B} [{card}]: {total['ms']:.4f} ms kernel, "
          f"{total['plain_ms']:.3f} ms plain, bound {total['bound_ms']:.4f} "
          f"ms; phase {time.perf_counter() - t0:.1f} s")
    return {**total, "err": worst, "bound_by": "bytes"}


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
        before = build.launch_counts["dense_warp"]
        out = cdc.compress_fast(a, b, batch_container=batch)
        rec = (cdc.decompress_fast_batch(out["blob"]) if batch
               else cdc.decompress_fast(out["blobs"]))
        sync()
        runs[label] = (out, rec)
        warps = build.launch_counts["dense_warp"] - before
        if warps != 6:
            raise AssertionError(f"DSIC {label}: the dense warp kernel "
                                 f"launched {warps} times in a round trip "
                                 f"of one batch, not 6")
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
    bench_launches, grids, _ = phase_bench(model, card, DS_BENCH_B,
                                           DS_BENCH_BATCHES, ("identity",))
    add_launches(launches, bench_launches)
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
              f"{rec['dectime'] * 1e3:.1f} ms wall for {len(args[0])}; "
              f"decoded "
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
    launches, rates = {}, {}
    for mode in (1, 0):
        build.launch_counts.clear()
        loop = bench.device_timed_loop(codec, batches, mode)
        counts = dict(build.launch_counts)
        add_launches(launches, counts)
        want = {"pairs_rans_encode": eyes * AR_BENCH_BATCHES,
                "ar_wavefront": 2 * eyes * AR_BENCH_BATCHES}
        # HESIC+'s bf16 transforms take GDN's kernel; mbt2018's float32
        # ones do not
        want["gdn"] = (GDN_CALLS.get(type(model).__name__, 0)
                       * AR_BENCH_BATCHES)
        for name, n in want.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"bench {label} [pipeline {mode}]: "
                                     f"{name} launched {counts.get(name)} "
                                     f"times for {AR_BENCH_BATCHES} "
                                     f"batches, not {n}")
        bench.check_device_loop(codec, loop)
        outs = loop["containers"]
        rates[mode] = AR_BENCH_BATCHES * AR_B / loop["seconds"]
        print(f"bench {label} [{card}] [identity H, pipeline {mode}]: "
              f"{rates[mode]:.2f} {item}/s "
              f"({AR_BENCH_BATCHES} batches of {AR_B} {HW_IMG}x{HW_IMG} "
              f"{item} in {loop['seconds'] * 1e3:.1f} ms), bpp_real "
              f"{np.mean([o['bpp_real'] for o in outs]):.6f}, escapes "
              f"{[o['escapes'] for o in outs]}; threaded re-encode "
              f"byte-identical; every container decoded to the encoder's "
              f"latents; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches {counts}")
        del loop
    if eyes == 2:
        # HESIC+'s FLOP count (mbt2018's point has none, as bench.py's),
        # outside the loops and their launch checks
        build.launch_counts.clear()
        mfu = bench.mfu_fields(codec, HW_IMG, rates[1], bench.PEAK_TFLOPS,
                               batch=AR_B)
        add_launches(launches, build.launch_counts)
        print_mfu(f"bench {label} [{card}] [identity H]", mfu, rates[1],
                  True)
    return launches


def add_launches(total: dict, counts) -> None:
    """Add `counts` ({kernel: launches}) into `total`."""
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def print_mfu(label: str, mfu: dict, rate: float, programs: bool) -> None:
    """Print bench.mfu_fields' FLOPs a pair, TFLOP/s and MFU share at the
    pipelined loop's `rate`, and the per-program counts if `programs`."""
    print(f"{label}: {mfu['flops_per_pair']:.6e} FLOPs a pair "
          f"({mfu['flops_counter']}; kernels 1-5 not counted), "
          f"{mfu['tflops_per_sec']:.3f} TFLOP/s at the pipelined loop's "
          f"{rate:.2f} pairs/s, mfu_pct_bf16 {mfu['mfu_pct_bf16']:.4f} of "
          f"{mfu['peak_tflops']} TFLOP/s")
    if programs:
        print(f"{label}: FLOPs per program "
              + ", ".join(f"{k} {v:.6e}"
                          for k, v in mfu["flops_per_program"].items()))


# the FLOP counts' cross-check: the tiny codecs of the CPU tests (HESIC
# N16/M24/K2; HESIC+ N16 at M=32, as kernel 5 takes M in multiples of 16)
# at 64x64, the same seed on the CPU and the card
FLOPS_HW = 64


def phase_flops_cross_check(card: str) -> dict:
    """device_flops of a tiny HESIC fast codec and a tiny HESIC+ device
    codec, built from one seed on the CPU and on the card: the counts
    must be equal, program by program (kernels 1-5 opaque on both, so
    FlopCounterMode sees the same matmuls and convolutions).  Returns
    the card runs' launches."""
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
    from hesic_tpu_torch.models.hesic_plus import HESICPlus

    def counts(device):
        hesic = HESICFastCodec(HESIC(N=16, M=24, K=2, device=device,
                                     seed=0), mm=8, codec_batch=2).update()
        plus = HESICPlusDeviceCodec(HESICPlus(N=16, M=32, device=device,
                                              seed=0), mm=8,
                                    groups=4).update()
        return {"HESIC fast": hesic.device_flops(FLOPS_HW, FLOPS_HW),
                "HESIC+ device": plus.device_flops(FLOPS_HW, FLOPS_HW,
                                                   batch=2)}

    t0 = time.perf_counter()
    cpu = counts("cpu")
    build.launch_counts.clear()
    dev = counts(DEVICE)
    launches = dict(build.launch_counts)
    for label, want in cpu.items():
        got = dev[label]
        if got["per_program"] != want["per_program"]:
            raise AssertionError(
                f"flops cross-check {label}: the card counts "
                f"{got['per_program']}, the CPU {want['per_program']}")
        print(f"flops cross-check {label} [{card}] at {FLOPS_HW}x"
              f"{FLOPS_HW}: card and CPU equal program by program, "
              + ", ".join(f"{k} {v:.0f}"
                          for k, v in got["per_program"].items())
              + f"; {got['flops_per_pair']:.0f} FLOPs a pair")
    print(f"flops cross-check: {time.perf_counter() - t0:.1f} s; launches "
          f"on the card {launches}")
    return launches


def phase_c13_routes() -> None:
    """C13's functions on the card: quantize_pmf_device's rows equal to
    the CPU's; the interleaved coder (rans_encode_interleaved through
    kernel 2, rans_decode_interleaved through kernel 3) bit-equal to its
    CPU twin in words, counts and states, at a ragged symbol count and at
    a multiple of the lanes, and decoding back to the symbols;
    wavefront_encode -> wavefront_decode (kernels 5 and 4) on a tiny level
    scan (seeded weights, M=32, B=2, 4x4 latents, mm 8, 4 groups, with and
    without the post input): the decode's y_hat bit-equal to the
    teacher's, the word buffer zero past the counts.  These launches are
    comparisons: they are not counted."""
    import numpy as np
    import torch
    from hesic_tpu_torch.codecs import device_rans
    from hesic_tpu_torch.models.ar_device import (wavefront_decode,
                                                  wavefront_encode)
    from hesic_tpu_torch.models.autoregressive import ArWeights
    rng = np.random.RandomState(21)
    for n, lanes, s_dim in ((20_000, 1024, 33), (16_384, 512, 9)):
        pmf = torch.from_numpy((rng.rand(n, s_dim) ** 4).astype(np.float32))
        rows = device_rans.quantize_pmf_device(pmf)
        check_equal(f"quantize_pmf_device n={n}", device_rans.
                    quantize_pmf_device(pmf.to(DEVICE)).cpu(), rows)
        cdf = device_rans.freq_to_cdf(rows)
        u = torch.from_numpy(rng.randint(0, 1 << 16, (n, 1)))
        sym = (cdf[:, 1:] <= u).sum(1).clamp_max(s_dim - 1).to(torch.int32)
        starts, freqs = device_rans.gather_intervals(cdf, sym)
        want = device_rans.rans_encode_interleaved(starts, freqs, lanes)
        got = device_rans.rans_encode_interleaved(starts.to(DEVICE),
                                                  freqs.to(DEVICE), lanes)
        for name, g, w in zip(("words", "counts", "states"), got, want):
            check_equal(f"interleaved encode n={n} {name}", g.cpu(), w)
        dec = device_rans.rans_decode_interleaved(*got, cdf.to(DEVICE), n,
                                                  lanes)
        check_equal(f"interleaved decode n={n}", dec.cpu(), sym)
    gen = torch.Generator().manual_seed(5)

    def randn(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen) * scale).to(DEVICE)

    b, hy, wy, m, mm, groups = 2, 4, 4, 32, 8, 4
    mask = torch.ones(5, 5, 1, 1)
    mask[2, 2:] = 0
    mask[3:] = 0
    for q in (0, m):
        w = ArWeights(randn(5, 5, m, 2 * m) * mask.to(DEVICE),
                      randn(2 * m, scale=0.05),
                      (randn(4 * m + q, 64), randn(64, 64),
                       randn(64, 2 * m)),
                      (randn(64, scale=0.05), randn(64, scale=0.05),
                       torch.cat([torch.full((m,), 0.5),
                                  torch.zeros(m)]).to(DEVICE)))
        pre, y = randn(b, hy, wy, 2 * m, scale=0.3), randn(b, hy, wy, m,
                                                           scale=2.0)
        post = randn(b, hy, wy, q, scale=0.3) if q else None
        words, counts, states, y_hat, resid, n_esc = wavefront_encode(
            w, y, pre, post, mm, groups)
        past = (torch.arange(words.shape[1], device=DEVICE)[None, :]
                >= counts[:, None])
        if (words[past] != 0).any():
            raise AssertionError("wavefront_encode: words past the counts")
        esc = resid.abs() > mm
        yd = wavefront_decode(w, pre, words, counts, states, post,
                              esc.to(torch.int32), torch.where(esc, resid, 0),
                              mm, groups)
        if not torch.equal(yd, y_hat):
            raise AssertionError(f"wavefront_decode (post {q}) differs from "
                                 f"the teacher's y_hat")
        print(f"C13 wavefront_encode -> wavefront_decode (post {q}): "
              f"{int(counts.sum())} words, {n_esc} escapes, y_hat "
              f"bit-equal")
    print("C13 routes: quantize_pmf_device equal to the CPU's; the "
          "interleaved coder through kernels 2 and 3 bit-equal to its "
          "twin at n 20000 (1024 lanes, ragged) and 16384 (512 lanes) "
          "and decoded back to the symbols")


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
    add_launches(launches, cal_launches)
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
    held["wavefront"]["split_big"] = level_split_at(
        "mbt2018 calibrated, no post", cal.w, pre, None, nhwc(y))
    del xd, y, pre
    torch.cuda.empty_cache()
    add_launches(launches, phase_device_bench(model, card, "mbt2018", 1))
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
    add_launches(launches, phase_device_bench(model, card, "HESIC+", 2))
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
    """Raise if any of the five coder kernels launched since
    build.launch_counts was cleared (DSIC's transforms launch the dense
    warp's kernel on any codec, and bf16 transforms GDN's)."""
    from hesic_tpu_torch.codecs import build
    coders = {k: v for k, v in build.launch_counts.items()
              if v and k not in ("dense_warp", "gdn")}
    if coders:
        raise AssertionError(f"{label} launched kernels {coders}")


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
    equal decoding with the header's.  Launches none of the five coder
    kernels (DSIC's transforms launch the dense warp's)."""
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
        if not case:
            level_split_at(f"{label} calibrated, no post", cal.w, pre,
                           None, y)
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
    level_split_at(f"{label_a}, no post, amplified images", cdc.w, pre,
                   None, y)
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
    five coder kernels (DSIC+'s transforms launch the dense warp's)."""
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


def phase_train_cli(card: str, tmp: str) -> tuple:
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
    HESICFastCodec and HESICCodec on one test pair.  Everything is
    written under `tmp`, which phase 20 reads.  Returns (the fast round
    trips' launches, what phase 20 takes: the folders, the homography
    net's and the trained HESIC's files, the test pairs as uint8)."""
    import io
    import subprocess

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
    kept = {"stereo": stereo, "single": single, "homo": homo,
            "hesic": os.path.join(ckpt, "model_latest.pkl"),
            "test1": u1[TRAIN_PAIRS:], "test2": u2[TRAIN_PAIRS:]}
    return launches, kept


# phase 20: evaluating and coding what was trained, through the CLIs.
# Textured pairs for the classical homography estimate: the JAX feature
# tests' block texture (tests/test_features.py), which gives Harris the
# corners that phase 19's smooth images lack.
TEXTURE_PAIRS = 2
EVAL_KEYS = ("bpp", "psnr", "ms-ssim")


def textured(seed: int, hw: int):
    """8x8 blocks of random colour plus 5% noise, in [0, 1]."""
    import numpy as np
    rng = np.random.RandomState(seed)
    blocks = rng.rand(hw // 8, hw // 8, 3).astype(np.float32)
    img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)
    img += 0.05 * rng.rand(hw, hw, 3).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def transfer_error(h_est, h_true, hw: int) -> float:
    """Mean distance in pixels between the images of a 5x5 grid over the
    middle half of the frame under two homographies."""
    import numpy as np
    ys, xs = np.meshgrid(np.linspace(hw * 0.25, hw * 0.75, 5),
                         np.linspace(hw * 0.25, hw * 0.75, 5))
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=-1)

    def proj(h):
        q = pts @ np.asarray(h, np.float64).T
        return q[:, :2] / q[:, 2:3]

    return float(np.mean(np.linalg.norm(proj(h_est) - proj(h_true),
                                        axis=-1)))


def cli(fn, argv):
    """A CLI's main(argv), its standard output dropped (phase 20 prints
    one line a row)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def check_summary(label: str, res: dict) -> str:
    """Raise unless an eval_model summary has bpp > 0 and finite PSNR and
    MS-SSIM; returns them as text."""
    import math
    if not res["bpp"] > 0 or not all(math.isfinite(res[k])
                                     for k in EVAL_KEYS):
        raise AssertionError(f"{label}: summary {res}")
    return ", ".join(f"{k} {res[k]:.6f}" for k in EVAL_KEYS)


def write_images(root: str, split: str, imgs) -> str:
    """Float images in [0, 1] as root/split/NNN.png; returns root."""
    import numpy as np
    from hesic_tpu_torch.datasets.image_io import write_png
    os.makedirs(os.path.join(root, split), exist_ok=True)
    for i, img in enumerate(imgs):
        write_png(os.path.join(root, split, f"{i:03d}.png"),
                  np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))
    return root


def phase_eval_cli(card: str, tmp: str, kept: dict, mbt_file: str, mbt_x,
                   plus_file: str) -> dict:
    """Phase 20 (see the module docstring).  Returns the launches of its
    device-codec and fast-codec runs."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench, zoo
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.datasets import StereoImageFolder
    from hesic_tpu_torch.datasets.image_io import read_png
    from hesic_tpu_torch.geometry import features
    from hesic_tpu_torch.geometry.homography import warp_perspective
    from hesic_tpu_torch.models.ar_device import (
        HESICPlusDeviceCodec, JointAutoregressiveDeviceCodec)
    from hesic_tpu_torch.models.hesic_fast import writer_id
    from hesic_tpu_torch.utils import (bench_codecs, codec_cli,
                                       eval_homography, eval_model,
                                       update_model)

    t_phase = time.perf_counter()
    dev = ["--device", DEVICE]
    where = {"device": DEVICE}
    hm = bench.rotated_homography()
    launches = {}
    test1 = kept["test1"].astype(np.float32) / 255
    test2 = kept["test2"].astype(np.float32) / 255
    pair = (test1[:1], test2[:1])

    def add(counts, names, label):
        for name in names:
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"{label}: never launched {name}")
            launches[name] = launches.get(name, 0) + counts[name]

    # row 1: HESIC through eval_model, real coder and entropy estimate
    t0 = time.perf_counter()
    stereo = ["--dataset", kept["stereo"], "--workdir", tmp] + dev
    args = ["--arch", "hesic", "--checkpoint", kept["hesic"],
            "--homography-net", kept["homo"]] + stereo
    build.launch_counts.clear()
    real = cli(eval_model.main, args)["results"]
    est = cli(eval_model.main, args + ["--entropy-estimation"])["results"]
    no_kernel_launched("eval_model hesic")
    cdc = zoo.create_model("hesic", checkpoint=kept["hesic"],
                           **where).update()
    enc = cdc.compress(*pair, hm[None], "c7", tmp)
    dec = cdc.decompress("c7", tmp)
    for key in ("y1_hat", "y2_hat"):
        if not torch.equal(dec[key], enc[key]):
            raise AssertionError(f"HESICFastCodec.compress: decoded {key} "
                                 f"differs from the encoder's")
    print(f"eval_model hesic [{card}]: N{N}/M{M}/K{K}, phase 19's "
          f"checkpoint and homography net, {TEST_PAIRS} {HW_IMG}x{HW_IMG} "
          f"pairs: real coder {check_summary('real coder', real)}, encode "
          f"{real['encoding_time']:.3f} s, decode "
          f"{real['decoding_time']:.3f} s a pair; entropy estimate "
          f"{check_summary('estimate', est)} (bpp1 {est['bpp1']:.6f}, "
          f"bpp2 {est['bpp2']:.6f}); HESICFastCodec.compress/decompress "
          f"(the reference-layout container) decodes the encoder's "
          f"latents ({time.perf_counter() - t0:.1f} s)")

    # row 5: update_model's file codes as the checkpoint rebuilt here
    t0 = time.perf_counter()
    upd = cli(update_model.main, [kept["hesic"], "--arch", "hesic",
                                  "--dir", tmp] + dev)
    cdc.update(force=True)
    again = zoo.create_model("hesic", checkpoint=upd, **where)
    want = cdc.compress(*pair, hm[None], "forced", tmp)["strings"]
    got = again.compress(*pair, hm[None], "updated", tmp)["strings"]
    if got != want:
        raise AssertionError("update_model: the rebuilt file codes other "
                             "container bytes")
    print(f"update_model [{card}]: {os.path.basename(upd)} loads and codes "
          f"a test pair to the same {sum(map(len, got))} container bytes "
          f"({time.perf_counter() - t0:.1f} s)")
    del cdc, again
    torch.cuda.empty_cache()

    # rows 2 and 3: the device codecs through eval_model
    mbt_dir = write_images(os.path.join(tmp, "mbt"), "test", mbt_x[:2])
    for arch, ckpt, data, eyes in (
            ("hesic-plus", plus_file, kept["stereo"], 2),
            ("mbt2018", mbt_file, mbt_dir, 1)):
        t0 = time.perf_counter()
        build.launch_counts.clear()
        res = cli(eval_model.main, [
            "--arch", arch, "--checkpoint", ckpt, "--device-codec",
            "--dataset", data, "--workdir", tmp] + dev)["results"]
        counts = dict(build.launch_counts)
        add(counts, ("pairs_rans_encode", "ar_wavefront"),
            f"eval_model {arch}")
        base = zoo.create_model(arch, checkpoint=ckpt, **where)
        if eyes == 2:
            dcdc = HESICPlusDeviceCodec(base.model).update()
            trip_args = (*pair, np.eye(3, dtype=np.float32)[None])
        else:
            dcdc = JointAutoregressiveDeviceCodec(base.model).update()
            trip_args = (mbt_x[:1],)
        trip, _ = device_round_trips(f"eval {arch} device codec",
                                     {"one item": (dcdc, trip_args)}, eyes)
        add(trip, ("pairs_rans_encode", "ar_wavefront"), arch)
        print(f"eval_model {arch} --device-codec [{card}]: "
              f"{check_summary(arch, res)}, encode "
              f"{res['encoding_time']:.3f} s, decode "
              f"{res['decoding_time']:.3f} s an item; launches {counts} "
              f"({time.perf_counter() - t0:.1f} s)")
        del base, dcdc
        torch.cuda.empty_cache()

    # row 4: codec_cli on one PNG with the calibrated mbt2018
    t0 = time.perf_counter()
    src = os.path.join(mbt_dir, "test", "000.png")
    bits = os.path.join(tmp, "mbt.bin")
    rec_png = os.path.join(tmp, "mbt_rec.png")
    build.launch_counts.clear()
    cli(codec_cli.main, ["encode", src, "-o", bits, "--arch", "mbt2018",
                         "--checkpoint", mbt_file] + dev)
    with open(bits, "rb") as f:
        head = f.read(5)
    if head != b"HTPU" + bytes([writer_id(DEVICE)]):
        raise AssertionError(f"codec_cli: header {head!r}, not the card's")
    rec = cli(codec_cli.main, ["decode", bits, "-o", rec_png,
                               "--checkpoint", mbt_file] + dev)
    no_kernel_launched("codec_cli")
    x_hat = rec["x_hat"][0].float().cpu().numpy()
    if not np.array_equal(read_png(rec_png), np.clip(
            x_hat * 255 + 0.5, 0, 255).astype(np.uint8)):
        raise AssertionError("codec_cli: the decoded PNG is not x_hat")
    bpp = os.path.getsize(bits) * 8 / HW_IMG ** 2
    print(f"codec_cli mbt2018 [{card}]: {HW_IMG}x{HW_IMG} PNG, writer byte "
          f"{head[4]}, {os.path.getsize(bits)} bytes ({bpp:.6f} bpp, header "
          f"included); the decoded PNG is the decoder's x_hat rounded "
          f"({time.perf_counter() - t0:.1f} s)")

    # rows 6 and 7: the classical H on textured pairs, then the fast codec
    t0 = time.perf_counter()
    left = np.stack([textured(20 + i, HW_IMG)
                     for i in range(TEXTURE_PAIRS)])
    right = warp_perspective(
        torch.from_numpy(left).permute(0, 3, 1, 2),
        torch.from_numpy(np.tile(hm[None], (TEXTURE_PAIRS, 1, 1))))
    tex = os.path.join(tmp, "textured")
    write_images(os.path.join(tex, "test"), "left", left)
    write_images(os.path.join(tex, "test"), "right",
                 right.permute(0, 2, 3, 1).numpy())
    ds = StereoImageFolder(tex, "test", patch_size=HW_IMG, classical_h=True,
                           h_device=DEVICE, rng=np.random.RandomState(0))
    t_est = time.perf_counter()
    items = [ds[i] for i in range(len(ds))]
    est_s = (time.perf_counter() - t_est) / len(ds)
    errs = [transfer_error(it["h"], hm, HW_IMG) for it in items]
    if not max(errs) < 1.0:
        raise AssertionError(f"classical H: transfer errors {errs} px")
    pts = torch.rand(8, 2, device=DEVICE) * HW_IMG
    idx = torch.tensor([[0, 1, 2, 3], [4, 4, 4, 4], [5, 5, 6, 7]],
                       device=DEVICE)
    score = features.score_hypotheses(pts, pts + 1, torch.ones(
        8, device=DEVICE), idx)[2].cpu().tolist()
    if score[1] != -1 or score[2] != -1 or score[0] < 0:
        raise AssertionError(f"singular hypotheses scored {score}")
    a = np.stack([it["x1"] for it in items])
    b = np.stack([it["x2"] for it in items])
    h_est = np.stack([it["h"] for it in items])
    fast = zoo.create_model("hesic", checkpoint=kept["hesic"],
                            dtype=torch.bfloat16, **where).update()
    build.launch_counts.clear()
    out = fast.compress_fast(a, b, h_est)
    dec = fast.decompress_fast(out["blobs"])
    add(dict(build.launch_counts),
        ("gmm_freq", "grid_rans_encode", "grid_rans_decode"), "row 7")
    check_fast_round_trip("textured pairs", fast, a, b, h_est, out, dec)
    print(f"classical H [{card}]: StereoImageFolder(classical_h=True) on "
          f"{TEXTURE_PAIRS} textured {HW_IMG}x{HW_IMG} pairs (bench.py's "
          f"real H): transfer errors {[round(e, 4) for e in errs]} px, "
          f"{est_s:.3f} s an item with the estimate; singular hypotheses "
          f"score -1 on the card; HESICFastCodec under the estimates: "
          f"bpp_real {out['bpp_real']:.6f}, exact round trip "
          f"({time.perf_counter() - t0:.1f} s)")
    del fast
    torch.cuda.empty_cache()

    # row 8: the homography net's evaluation
    t0 = time.perf_counter()
    hres = cli(eval_homography.main, [
        kept["stereo"], "--checkpoint", kept["homo"], "--n",
        str(TEST_PAIRS)] + dev)
    if not (hres["flops"] > 0 and np.isfinite(hres["mace"])):
        raise AssertionError(f"eval_homography: {hres}")
    print(f"eval_homography [{card}]: MACE {hres['mace']:.4f} px over "
          f"{hres['n']}, forward {hres['forward_ms']:.4f} ms, "
          f"{hres['params']} parameters, {hres['flops']} FLOPs a forward "
          f"(PyTorch's FlopCounterMode) ({time.perf_counter() - t0:.1f} s)")

    # row 9: the traditional-codec harness in a pool of 2 processes
    t0 = time.perf_counter()
    res_json = os.path.join(tmp, "jpeg.json")
    rc = cli(bench_codecs.main, [
        "jpeg", "--dataset", os.path.join(kept["single"], "test"), "-j",
        "2", "--output", res_json])
    with open(res_json) as f:
        jres = json.load(f)["results"]
    if rc != 0 or not all(np.isfinite(jres[k]).all() and len(jres[k]) == 1
                          for k in ("psnr-rgb", "ms-ssim-rgb", "bpp")):
        raise AssertionError(f"bench_codecs: rc {rc}, {jres}")
    print(f"bench_codecs jpeg -j 2: bpp {jres['bpp'][0]:.4f}, psnr-rgb "
          f"{jres['psnr-rgb'][0]:.4f}, ms-ssim-rgb "
          f"{jres['ms-ssim-rgb'][0]:.6f} over {TEST_PAIRS} images "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"phase 20 [{card}]: took {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}")
    return launches


PAR_TRAIN_STEPS = 2


def parallel_train_bits(card: str, mesh) -> None:
    """HESIC at full width in bf16 at bench.py's train point (512x512,
    batch 8): PAR_TRAIN_STEPS steps of make_parallel_train_step on the
    mesh against as many of make_train_step, from the same seeded
    weights, the same noise seed and the codecs' determinism policy:
    every loss and every parameter bit-equal."""
    import numpy as np
    import torch
    from hesic_tpu_torch.models.base import deterministic_backends
    from hesic_tpu_torch.models.hesic import HESIC
    from hesic_tpu_torch.parallel import make_parallel_train_step
    from hesic_tpu_torch.training import (make_loss_fn, make_optimizer,
                                          make_train_step)
    from hesic_tpu_torch.training.recipe import train_batch
    deterministic_backends()
    batch = train_batch(np.random.RandomState(0), TRAIN_B, HW_IMG, DEVICE)
    runs = {}
    for name in ("plain", "parallel"):
        model = HESIC(N=N, M=M, K=K, dtype=torch.bfloat16, device=DEVICE,
                      seed=0)
        opt = make_optimizer(model, 1e-4, 1e-3)
        if name == "plain":
            step = make_train_step(model, opt, make_loss_fn(1e-2))
        else:
            step = make_parallel_train_step(model, opt, make_loss_fn(1e-2),
                                            mesh)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        metrics, ms = [], []
        for _ in range(PAR_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            metrics.append(step(batch, gen))
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name] = (metrics, {n: p.detach().clone()
                                for n, p in model.named_parameters()}, ms)
        del model, opt, step
    (m0, p0, ms0), (m1, p1, ms1) = runs["plain"], runs["parallel"]
    for i, (a, b) in enumerate(zip(m0, m1)):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError(f"parallel train step {i}: {k} "
                                     f"{float(b[k])} != {float(a[k])}")
    differ = [n for n in p0 if not torch.equal(p0[n], p1[n])]
    if differ:
        raise AssertionError(f"parallel train: {len(differ)} parameters "
                             f"differ from make_train_step's, e.g. "
                             f"{differ[:3]}")
    print(f"parallel train [{card}]: HESIC N{N}/M{M}/K{K} bf16 "
          f"{HW_IMG}x{HW_IMG} batch {TRAIN_B} on mesh {tuple(mesh.shape)}: "
          f"{PAR_TRAIN_STEPS} steps bit-equal to make_train_step (losses "
          f"{[float(m['loss']) for m in m1]}, {len(p1)} parameters); "
          f"ms a step (each synchronised) {[round(t, 2) for t in ms1]}, "
          f"make_train_step's {[round(t, 2) for t in ms0]}")
    del runs
    torch.cuda.empty_cache()


def parallel_codec_bytes(card: str, mesh, model, blobs: dict) -> None:
    """Phase 9's codec (the calibrated HESIC, batch containers of
    BENCH_B pairs, mm 16) split over the mesh's data axis: for each
    homography, the split encode of phase 9's pool batch 1 must be byte
    for byte phase 9's container, and the split decode must give the
    one-process decode's outputs bit for bit."""
    import numpy as np
    import torch
    from hesic_tpu_torch import bench
    from hesic_tpu_torch.parallel import (split_compress_fast,
                                          split_decompress_fast_batch)
    codec = bench.make_codec(model, 16, BENCH_B)
    pool = bench.make_pool(np.random.RandomState(1), BENCH_POOL, BENCH_B,
                           HW_IMG, DEVICE)
    for kind, want in blobs.items():
        h = bench.homographies(kind, BENCH_B)
        sync()
        t0 = time.perf_counter()
        out = split_compress_fast(codec, mesh, *pool[1], h)
        rec = split_decompress_fast_batch(codec, mesh, out["blob"])
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        if out["blob"] != want:
            raise AssertionError(
                f"split codec [{kind} H]: container of {len(out['blob'])} "
                f"B differs from phase 9's ({len(want)} B)")
        ref = codec.decompress_fast_batch(want)
        for k, t in rec.items():
            if not torch.equal(t, ref[k]):
                raise AssertionError(f"split codec [{kind} H]: {k} differs "
                                     f"from the one-process decode")
        print(f"parallel codec [{card}] [{kind} H]: {BENCH_B} pairs split "
              f"over mesh {tuple(mesh.shape)}: container {len(want)} B "
              f"byte-equal to phase 9's, bpp_real {out['bpp_real']:.6f}, "
              f"decode bit-equal to one process; {ms:.1f} ms encode and "
              f"decode")
    del codec, pool
    torch.cuda.empty_cache()


def phase_parallel(card: str, model, blobs: dict, tmp: str) -> dict:
    """Phase 21: hesic_tpu_torch.parallel on the card at a world of one
    (NCCL through a file store in `tmp`): the dry run's lines, the
    full-width train step bit-equal to make_train_step, phase 9's codec
    split byte-equal to phase 9.  Returns the phase's kernel launches."""
    import datetime
    import torch
    import torch.distributed as dist
    from hesic_tpu_torch.codecs import build
    from hesic_tpu_torch.parallel import make_mesh
    from hesic_tpu_torch.parallel.dryrun import dry_run
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(tmp, 'pg_store')}",
        rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1))
        build.launch_counts.clear()
        dry_run(mesh, mesh)
        parallel_train_bits(card, mesh)
        parallel_codec_bytes(card, mesh, model, blobs)
        launches = dict(build.launch_counts)
    finally:
        dist.destroy_process_group()
    for name in ("gmm_freq", "grid_rans_encode", "grid_rans_decode",
                 "pairs_rans_encode", "ar_wavefront"):
        if not launches.get(name):
            raise AssertionError(f"phase 21 never launched {name}")
    print(f"phase 21 (parallel, torch {torch.__version__}, NCCL "
          f"{torch.cuda.nccl.version()}) took "
          f"{time.perf_counter() - t0:.1f} s [{card}]; launches {launches}")
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
    # phases 19-20's folders and files, removed when the process exits
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, True)
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
    # kernels 4 and 5 at the benchmark cell's batch
    big = ar_setup(AR_BIG_B)[3]
    for label, args in big.items():
        ar[f"{label}, B={AR_BIG_B}"] = phase_wavefront(
            f"{label}, B={AR_BIG_B}", *args)
    del big
    for k in ("wavefront", "pairs"):
        ar_post[k]["err"] = max(r[k]["err"] for r in ar.values())
    torch.cuda.empty_cache()

    phase_c13_routes()
    torch.cuda.empty_cache()

    launches, random_bpp = phase_main_path()
    plus_launches, plus_random_bpp = phase_hesic_plus_path(model, codec,
                                                           pairs)
    launches.update(plus_launches)
    add_launches(launches, phase_hesic_plus_fast(card))
    torch.cuda.empty_cache()
    del model, codec, eyes, ar
    torch.cuda.empty_cache()

    phase_train(card)
    cal_launches, cal_model = phase_calibrate(random_bpp)
    torch.cuda.empty_cache()
    bench_launches, grids, bench_blobs = phase_bench(cal_model, card)
    torch.cuda.empty_cache()
    dsic_launches, _, dsic_model = phase_dsic(card)
    torch.cuda.empty_cache()
    warp = phase_dense_warp(card)
    torch.cuda.empty_cache()
    gdn_r = phase_gdn(card)
    torch.cuda.empty_cache()
    mbt_launches, mbt_held, (mbt_model, mbt_x, mbt_bpp) = phase_mbt(card)
    torch.cuda.empty_cache()
    plus_cal_launches, plus_model = phase_hesic_plus_calibrated(
        card, pairs, plus_random_bpp)
    torch.cuda.empty_cache()
    flops_launches = phase_flops_cross_check(card)
    t0 = time.perf_counter()
    phase_mbt_host(card, mbt_model, mbt_x, mbt_bpp)
    phase_hesic_plus_host(card, plus_model, pairs, plus_random_bpp)
    print(f"phases 13-14 (the host AR codecs) took "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 20 evaluates the calibrated mbt2018 and HESIC+ from files
    from hesic_tpu_torch.models.codec import JointAutoregressiveCodec
    from hesic_tpu_torch.models.hesic_plus_codec import HESICPlusCodec
    mbt_file = os.path.join(work, "mbt2018.pkl")
    plus_file = os.path.join(work, "hesic_plus.pkl")
    JointAutoregressiveCodec(mbt_model).update().save(mbt_file)
    HESICPlusCodec(plus_model).update().save(plus_file)
    del mbt_model
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
    del pairs, plus_model, dsic_model
    torch.cuda.empty_cache()
    cli_launches, kept = phase_train_cli(card, work)
    eval_launches = phase_eval_cli(card, work, kept, mbt_file, mbt_x,
                                   plus_file)
    del mbt_x
    par_launches = phase_parallel(card, cal_model, bench_blobs, work)
    del cal_model
    for counts in (cal_launches, bench_launches, dsic_launches,
                   mbt_launches, plus_cal_launches, flops_launches,
                   cheng_launches, cli_launches, eval_launches,
                   par_launches):
        add_launches(launches, counts)
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
                              ar_post["wavefront"]),
             "dense_warp": ("hesic_tpu_torch/codecs/csrc/dense_warp.cu",
                            None, warp),
             "gdn": ("hesic_tpu_torch/codecs/csrc/gdn.cu", None, gdn_r)}
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
