"""The wavefront level scan of the autoregressive codec: CUDA kernel 5 and
its plain PyTorch twin.

Counterpart of hesic_tpu/models/ar_device.py (``ar_wavefront``) and of
its Pallas kernel hesic_tpu/models/pallas_wavefront.py
(``ar_wavefront_pallas``, bodies ``_kernel`` and ``_kernel_nopost``).  One
call is one eye pass over every level s = 3i + j of a (B, hy, wy, M)
latent; per level and per pixel of every image:

1. context: ctx = ctx_bias + sum over the 12 mask-A taps of
   y_hat[b, i+di, j+dj] @ tapk[tap] (0 outside the image);
2. entropy parameters: the MLP on cat(pre, ctx[, post]), leaky_relu(0.01)
   after the first two layers; scales = max(g[:M], 0.11), means = g[M:];
3. PMF: A&S 7.1.26 Phi (codecs/det_math) at the S + 1 edges
   (k - mm) - 0.5 over the scale, S = 2mm + 1, bins max(diff, 0), the
   total summed in ascending k;
4. quantisation: f = max(floor(pmf * 65536 / total), 1), the deficit to
   the first maximal bin;
5. teacher (encode): resid = round_half_even(y - mean), symbol
   clip(resid, -mm, mm) + mm, its interval (start, freq) at slot s*G + g,
   lane (b*p_max + p)*Mg + mc, channel m = g*Mg + mc (0 on rows past the
   level);
6. decode: per lane the G groups in order, each a rANS decode transition
   reading words[lane, count - 1] with one renormalisation; escape
   corrections override the decoded residual;
7. y_hat = resid + mean, written back for the next levels.

Returns (starts, freqs (T, L) int32, y_hat (B, hy, wy, M) float32, resid
(B, hy, wy, M) int32): resid is the teacher's true residual on encode and
the decoded (corrected) one on decode.  starts/freqs are zero on decode.

The plain twin loops over levels in Python, vectorised over the rows of a
level, with torch.matmul for the products and det_math for Phi.  Its
products sum in another order than the kernel's fixed-order GEMM, so the
two agree on the parameters to float rounding, not bit for bit; given
equal parameters their frequency rows are bit-equal (both strict IEEE).
Encode and decode must therefore run the same backend: the containers
carry a backend byte (models/ar_device.py).  ``ar_wavefront`` dispatches
on the device of ``pre``: a CPU tensor runs the twin, a CUDA tensor
launches the kernel (codecs/csrc/wavefront.cu) or raises.  It does so
through one registered operator, ``hesic_tpu_torch::ar_wavefront``
(``torch.library.custom_op``), so that PyTorch's FLOP counter
(``torch.utils.flop_counter.FlopCounterMode``, the codecs'
``device_flops``) sees a pass as one opaque call on either device, as
XLA's cost analysis saw the Pallas kernel: the twin's products are not
counted on the CPU, the kernel's cannot be counted on the card.

The kernel computes the first MLP layer in split form: the hoisted
product ``base = pre @ w0[0:P] + post @ w0[P+2M:] + b0`` (twin
``hoisted_base_plain``) once per pass for every pixel, then per level
``base + ctx @ w0[P:P+2M]``.  It works on each level's compacted rows
(``level_rows``): one launch a level runs its four products, tiled by
``level_plan`` from the level's rows, each sum in the order ``k_groups``
fixes from its K alone.  The weights are packed for it once
(``pack_weights``, kept by the codec), with the hidden widths H1, H2
padded with zeros to multiples of 16, which the hoisted product's
k-steps need (Cheng2020 at N=128 has H1 426, H2 341); the twin runs the
real widths.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..codecs import build
from ..codecs.det_math import (det_freq_rows, det_qscale, det_recip,
                               det_std_cdf, f32)
from ..codecs.device_rans import PROB_BITS, RANS_L
from ..utils.tracing import count
from .ar_device import TAPS, schedule
from .autoregressive import ArWeights

SCALE_MIN = f32(0.11)
_NAME = "ar_wavefront"
_U32 = 0xFFFFFFFF


def level_pixels(hy: int, wy: int):
    """(n_levels, p_max, i, j, valid): i/j (n_levels, p_max) int64 pixel
    coordinates of each level's rows (0 past the level), valid bool."""
    n_levels, i_min, count, p_max = schedule(hy, wy)
    p = np.arange(p_max)
    valid = p[None, :] < count[:, None]
    i = i_min[:, None].astype(np.int64) + p[None, :]
    j = np.arange(n_levels)[:, None] - 3 * i
    return (n_levels, p_max, np.where(valid, i, 0), np.where(valid, j, 0),
            valid)


def tap_kernel(weights) -> torch.Tensor:
    """The context kernel's 12 mask-A taps stacked in TAPS order:
    (12M, 2M) float32."""
    k = weights.ctx_kernel
    return torch.cat([k[2 + di, 2 + dj] for di, dj in TAPS], 0).float()


def freq_rows(scales: torch.Tensor, mm: int) -> torch.Tensor:
    """scales (..., M) -> quantized frequency rows (..., M, S) int32 over
    the residual grid [-mm, mm]: steps 3 and 4 of the module docstring."""
    s_dim = 2 * mm + 1
    edges = torch.arange(-mm, mm + 2, dtype=torch.float32,
                         device=scales.device) - 0.5
    cdf = det_std_cdf(edges * det_recip(scales)[..., None])
    pmf = torch.clamp_min(cdf[..., 1:] - cdf[..., :-1], 0.0)
    total = pmf[..., 0]
    for k in range(1, s_dim):
        total = total + pmf[..., k]
    return det_freq_rows(pmf, det_qscale(total)[..., None], dim=-1)


def _check_args(weights, pre, post, mm: int, groups: int):
    m = weights.ctx_kernel.shape[2]
    if m % groups:
        raise ValueError(f"M={m} is not divisible by groups={groups}")
    if mm < 0:
        raise ValueError(f"mm={mm} must be >= 0")
    q = 0 if post is None else post.shape[-1]
    cin = pre.shape[-1] + 2 * m + q
    w0, w1, w2 = weights.ep_kernels
    if (w0.shape[0] != cin or w1.shape[0] != w0.shape[1]
            or w2.shape != (w1.shape[1], 2 * m)):
        shapes = [tuple(w.shape) for w in weights.ep_kernels]
        raise ValueError(f"entropy-parameter kernels {shapes} do not "
                         f"chain from {cin} inputs to {2 * m}")
    return m, q


def ar_wavefront_plain(weights, pre, post, y_true, corr_mask, corr_val,
                       words, counts, states, teacher: bool, mm: int,
                       groups: int):
    """Plain twin of kernel 5 (see the module docstring).  Unused inputs
    may be None: post without a cross-eye input, y_true on decode,
    corr_mask/corr_val without escapes, words/counts/states on encode."""
    m, _ = _check_args(weights, pre, post, mm, groups)
    b, hy, wy, _ = pre.shape
    dev = pre.device
    n_levels, p_max, i_of, j_of, valid_of = level_pixels(hy, wy)
    mg = m // groups
    r_dim = b * p_max
    lanes = r_dim * mg
    # y_hat with 2 zero rows above and 2 zero columns on each side, so
    # every tap of a valid row reads a pixel or a zero (never wrapping)
    buf = torch.zeros((b, hy + 2, wy + 4, m), dtype=torch.float32,
                      device=dev)
    resid_img = torch.zeros((b, hy, wy, m), dtype=torch.int32, device=dev)
    starts = torch.zeros((n_levels * groups, lanes), dtype=torch.int32,
                         device=dev)
    freqs = torch.zeros_like(starts)
    tapk = tap_kernel(weights)
    w0, w1, w2 = weights.ep_kernels
    b0, b1, b2 = weights.ep_biases
    row_b = torch.arange(b, device=dev).repeat_interleave(p_max)
    if not teacher:
        x = states.to(torch.int64).clone()
        ptr = counts.to(torch.int64).clone()
        words64 = words.to(torch.int64)
        cap = words.shape[1]
        lane_ids = torch.arange(lanes, device=dev)

    for s in range(n_levels):
        ii = torch.from_numpy(np.tile(i_of[s], b)).to(dev)
        jj = torch.from_numpy(np.tile(j_of[s], b)).to(dev)
        vrow = torch.from_numpy(np.tile(valid_of[s], b)).to(dev)
        taps = [buf[row_b, ii + 2 + di, jj + 2 + dj] for di, dj in TAPS]
        ctx = torch.cat(taps, 1) @ tapk + weights.ctx_bias
        feat = [pre[row_b, ii, jj].float(), ctx]
        if post is not None:
            feat.append(post[row_b, ii, jj].float())
        g = F.leaky_relu(torch.cat(feat, 1) @ w0 + b0, 0.01)
        g = F.leaky_relu(g @ w1 + b1, 0.01)
        g = g @ w2 + b2
        scales = torch.clamp_min(g[:, :m], SCALE_MIN)
        means = g[:, m:]
        freq = freq_rows(scales, mm)                          # (R, M, S)

        if teacher:
            resid = torch.round(y_true[row_b, ii, jj].float()
                                - means).to(torch.int32)
            sym = (torch.clamp(resid, -mm, mm) + mm).to(torch.int64)
            csum = torch.cumsum(freq, dim=-1, dtype=torch.int32)
            below = torch.gather(csum, 2,
                                 torch.clamp_min(sym - 1, 0)[..., None])
            st = torch.where(sym > 0, below[..., 0], 0)
            fr = torch.gather(freq, 2, sym[..., None])[..., 0]
            keep = vrow[:, None]

            def slots(t):
                t = torch.where(keep, t, 0).reshape(r_dim, groups, mg)
                return t.permute(1, 0, 2).reshape(groups, lanes)

            starts[s * groups:(s + 1) * groups] = slots(st)
            freqs[s * groups:(s + 1) * groups] = slots(fr)
        else:
            vlane = vrow.repeat_interleave(mg)
            sym = torch.empty((r_dim, m), dtype=torch.int32, device=dev)
            for gi in range(groups):
                f_g = freq[:, gi * mg:(gi + 1) * mg].reshape(lanes, -1)
                f_g = f_g.to(torch.int64)
                c_g = torch.cumsum(f_g, dim=-1)               # inclusive
                cf = x & 0xFFFF
                sym_g = (c_g <= cf[:, None]).sum(dim=-1)
                start = torch.where(
                    sym_g > 0, torch.gather(
                        c_g, 1, torch.clamp_min(sym_g - 1, 0)[:, None])[:, 0],
                    0)
                f_d = torch.gather(f_g, 1, sym_g[:, None])[:, 0]
                x_new = (f_d * (x >> PROB_BITS) + cf - start) & _U32
                need = x_new < RANS_L
                word = words64[lane_ids, torch.clamp(ptr - 1, 0, cap - 1)]
                x_new = torch.where(need, ((x_new << PROB_BITS) | word) & _U32,
                                    x_new)
                x = torch.where(vlane, x_new, x)
                ptr = torch.where(vlane & need, ptr - 1, ptr)
                sym[:, gi * mg:(gi + 1) * mg] = sym_g.reshape(r_dim, mg)
            resid = sym - mm
            if corr_mask is not None:
                resid = torch.where(corr_mask[row_b, ii, jj] != 0,
                                    corr_val[row_b, ii, jj].to(torch.int32),
                                    resid)

        y_hat_l = resid.float() + means
        rb, ri, rj = row_b[vrow], ii[vrow], jj[vrow]
        buf[rb, ri + 2, rj + 2] = y_hat_l[vrow]
        resid_img[rb, ri, rj] = resid[vrow]
    y_hat = buf[:, 2:hy + 2, 2:wy + 2].contiguous()
    return starts, freqs, y_hat, resid_img


# the kernel's stage products take K in whole k-groups of 16: the MLP's
# hidden widths are padded up to a multiple of it
WIDTH_QUANTUM = 16


class PackedArWeights(NamedTuple):
    """An eye's ArWeights in the kernel's layout, built once
    (``pack_weights``): the context taps stacked, w0 split into the rows
    the hoisted product reads and the rows the level scan reads, and the
    hidden widths H1, H2 padded with zeros to multiples of
    WIDTH_QUANTUM."""

    raw: ArWeights         # the weights as the plain twin takes them
    q_dim: int             # width of the post input (0: none)
    tapk: torch.Tensor     # (12M, 2M): tap_kernel(raw)
    w0_pp: torch.Tensor    # (P + Q, H1p): w0's pre rows, then its post rows
    w0_ctx: torch.Tensor   # (2M, H1p): w0[P:P+2M]
    b0: torch.Tensor       # (H1p,)
    w1: torch.Tensor       # (H1p, H2p)
    b1: torch.Tensor       # (H2p,)
    w2: torch.Tensor       # (H2p, 2M)


def padded_width(n: int) -> int:
    """`n` rounded up to a multiple of WIDTH_QUANTUM."""
    return -(-n // WIDTH_QUANTUM) * WIDTH_QUANTUM


def _pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    """`t` in the leading corner of a zero float32 tensor of `shape`
    (`t` itself, contiguous, when it has that shape already)."""
    if tuple(t.shape) == tuple(shape):
        return t.float().contiguous()
    out = torch.zeros(shape, dtype=torch.float32, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def pack_weights(weights: ArWeights, q_dim: int = 0) -> PackedArWeights:
    """Pack `weights` for an eye whose post input is `q_dim` wide.

    H1 and H2 are padded to multiples of WIDTH_QUANTUM: w0's columns and
    b0, w1's rows and columns and b1, and w2's rows with zeros.  The
    padding is exact: a padded hidden unit is leaky_relu(0) = 0, so it
    adds exact zeros to the next layer and the real units keep their
    values.  Widths that are multiples already pack unchanged."""
    m = weights.ctx_kernel.shape[2]
    w0 = weights.ep_kernels[0].float()
    p_dim = w0.shape[0] - 2 * m - q_dim
    if p_dim < 0:
        raise ValueError(f"w0 has {w0.shape[0]} rows, fewer than 2M + Q = "
                         f"{2 * m + q_dim}")
    h1, h2 = weights.ep_kernels[1].shape
    h1p, h2p = padded_width(h1), padded_width(h2)
    w0p = _pad_to(w0, (w0.shape[0], h1p))
    return PackedArWeights(
        weights, q_dim, tap_kernel(weights).contiguous(),
        torch.cat([w0p[:p_dim], w0p[p_dim + 2 * m:]], 0).contiguous(),
        w0p[p_dim:p_dim + 2 * m].contiguous(),
        _pad_to(weights.ep_biases[0], (h1p,)),
        _pad_to(weights.ep_kernels[1], (h1p, h2p)),
        _pad_to(weights.ep_biases[1], (h2p,)),
        _pad_to(weights.ep_kernels[2], (h2p, 2 * m)))


def raw_weights(weights) -> ArWeights:
    """The ArWeights of `weights` (an ArWeights or a PackedArWeights)."""
    return weights.raw if isinstance(weights, PackedArWeights) else weights


def hoisted_base_plain(packed: PackedArWeights, pre, post) -> torch.Tensor:
    """Plain twin of the hoisted product: the part of the first MLP layer
    that does not depend on the scan, pre @ w0[0:P] + post @ w0[P+2M:] +
    b0 for every pixel, (B, hy, wy, H1p), its padded columns exactly 0.
    The level scan adds ctx @ w0[P:P+2M] to it (the split form of
    cat(pre, ctx, post) @ w0 + b0)."""
    feat = pre.float() if post is None else torch.cat(
        [pre.float(), post.float()], -1)
    return feat @ packed.w0_pp + packed.b0


def level_rows(hy: int, wy: int, b: int, s: int):
    """Level s's compacted rows r = bi * cnt_s + p, p < cnt_s, in (b, p)
    order, as wavefront.cu maps them: (bi, i, j) int64 arrays of length
    b * cnt_s, pixel (i_min[s] + p, s - 3i) of image bi."""
    _, i_min, count, _ = schedule(hy, wy)
    r = np.arange(b * int(count[s]))
    bi, p = np.divmod(r, int(count[s]))
    i = i_min[s].astype(np.int64) + p
    return bi, i, s - 3 * i


# the hoisted product (wavefront.cu's wavefront_hoist_kernel): tiles of
# 64 rows by one of TILE_WIDTHS columns, in k-steps of a multiple of 16
TILE_WIDTHS = (8, 16, 32, 64)


class StagePlan(NamedTuple):
    """The hoisted product's tiles: `bn` columns, `kt` k per shared-memory
    step (a multiple of 16)."""

    bn: int
    kt: int


HOIST_PLAN = StagePlan(32, 192)


def hoist_plan(k: int) -> tuple:
    """(tile width, k-step) of the hoisted product over k = P + Q rows:
    HOIST_PLAN's, with the k-step cut to k where k is smaller (the
    kernel takes a k-step of at most its one chunk; at the JAX dry run's
    HESIC+ N=8/M=16, k is 32 and 48)."""
    return HOIST_PLAN.bn, min(HOIST_PLAN.kt, k)


def stage_shapes(m: int, h1: int, h2: int) -> dict:
    """Each level product's (K, N): the context product and the three
    layers (layer 0 on its 2M context rows only)."""
    return {"ctx": (12 * m, 2 * m), "layer0": (2 * m, h1),
            "layer1": (h1, h2), "layer2": (h2, 2 * m)}


# wavefront.cu's level kernel (wavefront_level_kernel): its limits
K_GROUPS = 4             # k-groups of every sum: the fixed order of terms
THREADS = 256            # a block
TILES = (4, 8)           # register tiles, u x u sums a thread's item
GATHER = 8               # float4s a thread gathers a k-step
MAX_CLUSTER = 16         # blocks a cluster (non-portable above 8)
MAX_ROWS = 64            # rows a tile
LEVEL_SMEM = 225 * 1024  # dynamic shared memory a block
# clusters of each size the H100 holds at once at one block an SM
# (hesic_ar_level_clusters on the card: 132 SMs in GPCs of 16-18)
CLUSTER_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# level_plan's cost model of a launch's time, in microseconds, fitted by
# least squares to 9,500 level launches of 76 plans timed on an H100 (700
# W; HESIC+ M=192 at B=64 and B=11; median error 2.5%): a block's loop
# cycles (``_loop_cycles``) at this many microseconds per 1,980 cycles,
# a k-step's latency, a megabyte of weights a block reads from L2 and of
# activations it gathers from other blocks, and a launch's fixed cost
LOOP_US, STEP_US, W_US_PER_MB, GATHER_US_PER_MB, LAUNCH_US = (
    1.27, 1.06, 12.2, 68.8, 20.2)


class LevelPlan(NamedTuple):
    """A level's launch: tiles of `bm` rows, each one cluster of
    `cluster` blocks, k-steps of `kq` k a group, and `tile` x `tile`
    register tiles.  It decides who computes an output, never its order
    of terms (``k_groups``)."""

    bm: int
    cluster: int
    kq: int
    tile: int


def k_groups(k: int) -> tuple:
    """The fixed order of a sum over k terms: K_GROUPS runs [g*k/4,
    (g+1)*k/4), each summed k ascending, then added in order."""
    return tuple((g * k // K_GROUPS, (g + 1) * k // K_GROUPS)
                 for g in range(K_GROUPS))


def column_slices(n: int, cluster: int, unit: int) -> list:
    """The columns [lo, hi) of an n-column product that each block of a
    cluster owns, by rank: whole units of `unit` columns (the plan's
    tile), [q*rank/c, q*(rank+1)/c) of its q = n/unit units."""
    q = n // unit
    return [(unit * (q * r // cluster), unit * (q * (r + 1) // cluster))
            for r in range(cluster)]


def _max_cols(n: int, cluster: int, unit: int) -> int:
    return unit * -(-(n // unit) // cluster)


def level_smem(m: int, h1: int, h2: int, plan: LevelPlan) -> int:
    """Dynamic shared memory of a level launch, in bytes (wavefront.cu
    level_smem): the owner table, the block's tap share, output slices
    and base rows, two k-steps of A and of W."""
    bm, c, kq, u = plan
    qmax = max(3 * m, m // 2, h1 // 4, h2 // 4)
    nc = max(_max_cols(n, c, u) for n in (2 * m, h1, h2))
    cols = (_max_cols(12 * m, c, 4)
            + max(_max_cols(2 * m, c, u), _max_cols(h2, c, u))
            + 2 * _max_cols(h1, c, u))
    work = max(2 * 4 * kq * (bm + nc), K_GROUPS * bm * nc)
    return 4 * (-(-qmax // 4) * 4 + cols * bm + work)


def _items(m: int, h1: int, h2: int, plan: LevelPlan) -> list:
    """The (K, items) of each product: an item is one k-group's u x u
    tile of the block's output."""
    bm, c, _, u = plan
    return [(k, K_GROUPS * (bm // u) * (_max_cols(n, c, u) // u))
            for k, n in stage_shapes(m, h1, h2).values()]


def level_plan_ok(m: int, h1: int, h2: int, plan: LevelPlan) -> bool:
    """wavefront.cu level_plan_ok: `plan` is built and fits."""
    bm, c, kq, u = plan
    if not (u in TILES and u <= bm <= MAX_ROWS and bm % u == 0
            and 1 <= c <= MAX_CLUSTER and kq >= 4 and kq % 4 == 0
            and kq * bm <= GATHER * THREADS):
        return False
    if any(n % u for n in (2 * m, h1, h2)):
        return False
    if any(i > THREADS * (64 // (u * u))
           for _, i in _items(m, h1, h2, plan)):
        return False
    return level_smem(m, h1, h2, plan) <= LEVEL_SMEM


def level_ctas(plan: LevelPlan, rows: int) -> int:
    """Blocks of a level launch on `rows` rows."""
    return -(-rows // plan.bm) * plan.cluster


def _loop_cycles(items: int, u: int) -> int:
    """Cycles of one k of a product's loop in a block holding `items`
    items: item i on thread i % 256, warp w on scheduler w % 4; the
    busiest scheduler's FMAs and loads, or the block's shared-memory
    wavefronts (4 a float4 load of a warp), whichever is longer."""
    warps = [0] * (THREADS // 32)
    for start in range(0, items, THREADS):
        for w in range(-(-min(THREADS, items - start) // 32)):
            warps[w] += 1
    sched = max(sum(warps[s::4]) for s in range(4)) * (u * u + u // 2)
    return max(sched, sum(warps) * 2 * u)


def level_cost(m: int, h1: int, h2: int, plan: LevelPlan,
               rows: int) -> float:
    """level_plan's model of a launch's time, in microseconds: the waves
    of clusters times a block's time, the sum of its loops, k-steps,
    weight bytes, gathered bytes and a fixed cost (the constants above)."""
    bm, c, kq, u = plan
    waves = -(-(-(-rows // bm)) // CLUSTER_SLOTS[c])
    shapes = stage_shapes(m, h1, h2).values()
    loop = sum(k // K_GROUPS * _loop_cycles(i, u)
               for k, i in _items(m, h1, h2, plan)) / 1980
    steps = sum(-(-(k // K_GROUPS) // kq) for k, _ in shapes)
    wmb = sum(4 * k * _max_cols(n, c, u) for k, n in shapes) / 1e6
    gmb = 4 * bm * sum(k for k, _ in shapes) * (c - 1) / c / 1e6
    return waves * (LOOP_US * loop + STEP_US * steps + W_US_PER_MB * wmb
                    + GATHER_US_PER_MB * gmb + LAUNCH_US)


@functools.lru_cache(maxsize=None)
def level_plan(m: int, h1: int, h2: int, rows: int) -> LevelPlan:
    """The plan of a level of `rows` compacted rows: of the plans that
    fit (each cluster size and tile, tile heights up to MAX_ROWS, the
    longest k-step that fits), the least ``level_cost``, then the fewest
    rows computed past the level.  Any plan gives the same g bit for
    bit."""
    best = None
    for u in TILES:
        for c in CLUSTER_SLOTS:
            for bm in range(u, MAX_ROWS + 1, u):
                for kq in range(64, 0, -4):
                    plan = LevelPlan(bm, c, kq, u)
                    if level_plan_ok(m, h1, h2, plan):
                        key = (level_cost(m, h1, h2, plan, rows),
                               -(-rows // bm) * bm - rows, -bm)
                        if best is None or key < best[0]:
                            best = (key, plan)
                        break
    if best is None:
        raise ValueError(f"no level plan fits M={m}, H1={h1}, H2={h2}")
    return best[1]


@functools.lru_cache(maxsize=None)
def scan_plan(m: int, h1: int, h2: int, b: int, hy: int, wy: int):
    """Every level's LevelPlan of a (B, hy, wy) pass, as the C entry
    takes them: (bm, cluster, kq, tile) per level, a ctypes int array."""
    _, _, count, _ = schedule(hy, wy)
    flat = [v for n in count for v in level_plan(m, h1, h2, b * int(n))]
    return (ctypes.c_int * len(flat))(*flat)


def level_clusters(cluster: int, smem: int, tile: int = 4) -> int:
    """The most clusters of `cluster` level-kernel blocks (register tile
    `tile`) with `smem` bytes of shared memory each that the current
    card holds at once."""
    out = ctypes.c_int(0)
    build.check_status(_lib().hesic_ar_level_clusters(
        cluster, smem, tile, ctypes.byref(out)), "ar_wavefront occupancy")
    return out.value


def _lib():
    lib = build.load("wavefront")
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_ar_hoist.restype = ci
        lib.hesic_ar_hoist.argtypes = [vp] * 5 + [ci] * 4 + [vp, vp]
        lib.hesic_ar_wavefront.restype = ci
        lib.hesic_ar_wavefront.argtypes = [vp] * 19 + [ci] * 11 + [vp, vp]
        lib.hesic_ar_level_clusters.restype = ci
        lib.hesic_ar_level_clusters.argtypes = [ci, ci, ci,
                                                   ctypes.POINTER(ci)]
        lib._hesic_typed = True
    return lib


def _plan_arg(*plans):
    flat = [v for p in plans for v in p]
    return (ctypes.c_int * len(flat))(*flat)


def _check_packed(pk: PackedArWeights, dev):
    raw = pk.raw
    ts = {"tapk": pk.tapk, "w0_pp": pk.w0_pp, "w0_ctx": pk.w0_ctx,
          "ctx_bias": raw.ctx_bias, "b0": pk.b0, "w1": pk.w1, "b1": pk.b1,
          "w2": pk.w2, "b2": raw.ep_biases[2]}
    for name, t in ts.items():
        build.check_cuda_tensor(t, name, torch.float32)
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned on {dev}")


def hoisted_base_cuda(pk: PackedArWeights, pre, post) -> torch.Tensor:
    """The hoisted product on the card (one wavefront_hoist_kernel
    launch); same contract as hoisted_base_plain, pk checked by the
    caller."""
    b, hy, wy, p_dim = pre.shape
    h1 = pk.w0_pp.shape[1]
    base = torch.empty((b, hy, wy, h1), dtype=torch.float32,
                       device=pre.device)
    rc = _lib().hesic_ar_hoist(
        pre.data_ptr(), 0 if post is None else post.data_ptr(),
        pk.w0_pp.data_ptr(), pk.b0.data_ptr(),
        base.data_ptr(), b * hy * wy, p_dim, pk.q_dim, h1,
        _plan_arg(hoist_plan(p_dim + pk.q_dim)),
        torch.cuda.current_stream(pre.device).cuda_stream)
    build.check_status(rc, "ar_wavefront hoist", "P, Q and H1 multiples "
                       "of 4, P + Q of 16")
    return base


def ar_wavefront_cuda(weights, pre, post, y_true, corr_mask, corr_val,
                      words, counts, states, teacher: bool, mm: int,
                      groups: int):
    """Kernel 5 on the card: one eye pass, the hoisted product then 2
    launches per level (the level kernel, planned by ``level_plan``, and
    the coder); same contract as ar_wavefront_plain.  `weights`
    is a PackedArWeights (an ArWeights is packed on the spot).  Counts
    one launch per call."""
    q = 0 if post is None else post.shape[-1]
    pk = (weights if isinstance(weights, PackedArWeights)
          else pack_weights(weights, q))
    if pk.q_dim != q:
        raise ValueError(f"weights packed for a post input of {pk.q_dim} "
                         f"channels, got {q}")
    m, q = _check_args(pk.raw, pre, post, mm, groups)
    b, hy, wy, p_dim = pre.shape
    h1, h2 = pk.w1.shape        # the padded widths
    dev = pre.device
    n_levels, _, _, p_max = schedule(hy, wy)
    lanes = b * p_max * (m // groups)
    img = (b, hy, wy, m)
    build.check_cuda_tensor(pre, "pre", torch.float32)
    if post is not None:
        build.check_cuda_tensor(post, "post", torch.float32, (b, hy, wy, q))
    _check_packed(pk, dev)
    dummy = torch.zeros(1, dtype=torch.int32, device=dev)
    if teacher:
        build.check_cuda_tensor(y_true, "y_true", torch.float32, img)
        cmask = cval = words = dummy
        cap = 1
        x_st = torch.zeros(1, dtype=torch.int64, device=dev)
        p_st = dummy
    else:
        y_true = torch.zeros(1, dtype=torch.float32, device=dev)
        if corr_mask is None:
            cmask = torch.zeros(img, dtype=torch.int32, device=dev)
            cval = cmask
        else:
            cmask, cval = corr_mask, corr_val
            build.check_cuda_tensor(cmask, "corr_mask", torch.int32, img)
            build.check_cuda_tensor(cval, "corr_val", torch.int32, img)
        build.check_cuda_tensor(words, "words", torch.int32)
        if words.shape[0] != lanes:
            raise ValueError(f"words must have {lanes} lanes, got "
                             f"{tuple(words.shape)}")
        cap = words.shape[1]
        build.check_cuda_tensor(counts, "counts", torch.int32, (lanes,))
        build.check_cuda_tensor(states, "states", torch.int64, (lanes,))
        x_st = states.clone()
        p_st = counts.clone()
    base = hoisted_base_cuda(pk, pre, post)
    g = torch.empty((b * p_max, 2 * m), dtype=torch.float32, device=dev)
    starts = torch.zeros((n_levels * groups, lanes), dtype=torch.int32,
                         device=dev)
    freqs = torch.zeros_like(starts)
    y_hat = torch.zeros(img, dtype=torch.float32, device=dev)
    resid = torch.zeros(img, dtype=torch.int32, device=dev)
    raw = pk.raw
    rc = _lib().hesic_ar_wavefront(
        base.data_ptr(), y_true.data_ptr(), cmask.data_ptr(),
        cval.data_ptr(), words.data_ptr(), x_st.data_ptr(), p_st.data_ptr(),
        pk.tapk.data_ptr(), raw.ctx_bias.data_ptr(), pk.w0_ctx.data_ptr(),
        pk.w1.data_ptr(), pk.b1.data_ptr(), pk.w2.data_ptr(),
        raw.ep_biases[2].data_ptr(), g.data_ptr(), starts.data_ptr(),
        freqs.data_ptr(), y_hat.data_ptr(), resid.data_ptr(),
        b, hy, wy, m, h1, h2, groups, mm, cap, p_max, 1 if teacher else 0,
        scan_plan(m, h1, h2, b, hy, wy),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_status(rc, _NAME, "groups dividing 128, mm <= 32, M a "
                       "multiple of 4, a level plan that fits shared "
                       "memory")
    build.count_launch(_NAME)
    count("wavefront_level_launches", n_levels)
    return starts, freqs, y_hat, resid


def _flat_weights(weights) -> tuple:
    """(the raw weights' tensors, the packed ones or [], q_dim) of an
    ArWeights or a PackedArWeights: the operator's weight arguments."""
    raw = raw_weights(weights)
    flat = [raw.ctx_kernel, raw.ctx_bias, *raw.ep_kernels, *raw.ep_biases]
    if isinstance(weights, PackedArWeights):
        return flat, list(weights[2:]), weights.q_dim
    return flat, [], 0


def _weights_from_flat(raw: list, packed: list, q_dim: int):
    """Inverse of _flat_weights."""
    n = (len(raw) - 2) // 2
    w = ArWeights(raw[0], raw[1], tuple(raw[2:2 + n]), tuple(raw[2 + n:]))
    return PackedArWeights(w, q_dim, *packed) if packed else w


@torch.library.custom_op("hesic_tpu_torch::ar_wavefront", mutates_args=())
def _ar_wavefront_op(
        raw: list[torch.Tensor], packed: list[torch.Tensor], q_dim: int,
        pre: torch.Tensor, post: Optional[torch.Tensor],
        y_true: Optional[torch.Tensor], corr_mask: Optional[torch.Tensor],
        corr_val: Optional[torch.Tensor], words: Optional[torch.Tensor],
        counts: Optional[torch.Tensor], states: Optional[torch.Tensor],
        teacher: bool, mm: int, groups: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    weights = _weights_from_flat(raw, packed, q_dim)
    if pre.is_cuda:
        return ar_wavefront_cuda(weights, pre, post, y_true, corr_mask,
                                 corr_val, words, counts, states, teacher,
                                 mm, groups)
    return ar_wavefront_plain(raw_weights(weights), pre, post, y_true,
                              corr_mask, corr_val, words, counts, states,
                              teacher, mm, groups)


def ar_wavefront(weights, pre, post, y_true, corr_mask, corr_val, words,
                 counts, states, teacher: bool, mm: int, groups: int):
    """One eye pass: the kernel for CUDA tensors, the plain twin on the
    CPU, as the one operator hesic_tpu_torch::ar_wavefront (opaque to
    the FLOP counter)."""
    return torch.ops.hesic_tpu_torch.ar_wavefront(
        *_flat_weights(weights), pre, post, y_true, corr_mask, corr_val,
        words, counts, states, teacher, mm, groups)
