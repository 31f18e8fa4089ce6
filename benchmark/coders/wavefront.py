"""The wavefront coder: HESIC+'s device codec (``HESICPlusDeviceCodec``)
and its level-scan container.

The codec codes each latent as the residual round(y - mean) around the
means its context model gives from the latents decoded before it; the
quantised latent is that residual plus the mean.  Its coder is rANS with
16-bit words and probabilities, each residual coded on the grid [-mm, mm]
(a residual beyond it as its edge bin; the container sends it apart as
an escape) under one Gaussian a latent, of the entropy parameters'
scale, at least 0.11: the bins' masses at the edges (k - mm) - 0.5 over
the scale, each floored after scaling the row to 2^16, at least 1, the
deficit to 2^16 added to the first largest bin.

The container, as its layout is frozen here: the backend byte; u32 B, H,
W, zh, zw; per eye the escapes (u32 n, n u32 flat NHWC indices, n i32
values); the B z1 strings, the B z2 strings (u32 length, bytes each); B
x 9 f32 homographies; per eye the packed stream: u16 lanes, the lanes'
word counts (u8 mode 1: u16 base and u8 deltas; mode 0: u16 each), their
final u32 states and the 16-bit words, lane-major.  The lanes are the
level scan's: levels s = 3i + j of the (hy, wy) latents, each with
p_max rows (pixel p of the level: i = i_min(s) + p, j = s - 3i); slot t
= s G + g of G channel groups; lane (b p_max + p) Mg + c, channel g Mg +
c, Mg = M / G.  A lane codes its valid slots in reverse from the state
2^16, so its code length is 16 bits a word plus log2(final state) - 16.

The hooks are those of ``benchmark/coders/__init__.py``.  ``work`` counts
kernels 5 and 4 as the program's kernel smoke test does: kernel 5's
GEMM FLOPs (every product of a latent: the 12 context taps, the three
entropy-parameter layers at their real widths) and its coder's
operations, a pass; kernel 4's bytes, a launch (the coded words left
out, so its bound is a little low).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.judge import CHUNK, nchw
from benchmark.reference.layers import SCALE_BOUND, f32_backends

PROB_BITS = 16
# kernel 5's coder per latent, counted from the program's deterministic
# CDF chain: each of the S + 1 edges the argument and the CDF (56), each
# bin the difference, clamp and total and the quantisation (11), each
# latent the scale floor, reciprocal and scale (23) and the residual (4)
OPS_PER_EDGE, OPS_PER_BIN, OPS_PER_LATENT = 56, 11, 27


def build(cls, model, cfg: dict, traffic: dict):
    """The codec at the configuration's grid and channel groups."""
    return cls(model, mm=cfg["mm"], groups=cfg["groups"]).update()


def encoded(codec, batch: dict, blob: bytes) -> tuple:
    """The program's encoder on the batch: its teacher chain's latents
    y1, y2 and the z symbols, NCHW float."""
    x1, x2 = nchw(batch["x1"]).contiguous(), nchw(batch["x2"]).contiguous()
    h = torch.as_tensor(batch["h"], device=x1.device).float()
    y1, y2, z1, z2 = codec.coded_latents(x1, x2, h)
    return tuple(t.permute(0, 3, 1, 2).float() for t in (y1, y2)) + (
        z1.float(), z2.float())


def quantise(ref, model, eye: int, y: torch.Tensor, context) -> torch.Tensor:
    """The reference's latents `y` of `eye` as the codec quantises them,
    with the reference's own hyper-latents and, for the right eye, the
    left prior of the decoded left latents that the reference's
    ``analysis`` kept.  With the decoded latents `context`: the
    reference's means from their causal context (one masked
    convolution), and the decoded latent where the reference's residual
    round(y - mean) equals the one the decoded latent holds, moved by
    the residuals' difference where not.  Without (the control): the
    reference's own level scan."""
    h, y1_hat = model.analysed
    z = ref.hyper_eye(model, eye + 1, y)
    post = ref.left_prior(model, y1_hat, h) if eye else None
    if context is None:
        return ref.level_scan(model, eye + 1, y, z, post)
    _, mu = ref.eye_params(model, eye + 1, ref.hyper_params(model, eye + 1,
                                                            z),
                           context, post)
    return context + (torch.round(y - mu) - torch.round(context - mu))


def stated(blob: bytes, cfg: dict) -> dict:
    """The container's lanes' code lengths (B, 2, lanes a pair) and the
    grids it codes on (the configuration's: the container names none)."""
    off = 1
    b = int(np.frombuffer(blob, np.uint32, 1, off)[0])
    off += 20
    for _ in range(2):                              # escapes
        off += 4 + 8 * int(np.frombuffer(blob, np.uint32, 1, off)[0])
    for _ in range(2 * b):                          # z strings
        off += 4 + int(np.frombuffer(blob, np.uint32, 1, off)[0])
    off += 36 * b
    bits = []
    for _ in range(2):
        lanes = int(np.frombuffer(blob, np.uint16, 1, off)[0])
        off += 2
        mode = blob[off]
        off += 1
        if mode == 1:
            base = int(np.frombuffer(blob, np.uint16, 1, off)[0])
            c = base + np.frombuffer(blob, np.uint8, lanes, off + 2).astype(
                np.int64)
            off += 2 + lanes
        else:
            c = np.frombuffer(blob, np.uint16, lanes, off).astype(np.int64)
            off += 2 * lanes
        st = np.frombuffer(blob, np.uint32, lanes, off).astype(np.float64)
        off += 4 * lanes + 2 * int(c.sum())
        bits.append((16 * c + np.log2(st) - 16).reshape(b, -1))
    if off != len(blob):
        raise ValueError(f"wavefront container: the layout ends at byte "
                         f"{off} of {len(blob)}")
    return {"bits": torch.as_tensor(np.stack(bits, 1)),
            "params": (cfg["mm"], cfg["mm"])}


def reference_bits(ref, model, batch: dict, d: dict) -> torch.Tensor:
    """The code length of the decoded latents in the container's lanes
    (its channel groups from its lanes a pair) under rows from the
    reference's conditioning of the encoder's z symbols and of the
    decoded latents."""
    hw = d["y1"].shape[2:]
    groups = model.M * _p_max(*hw) // d["bits"].shape[2]
    return _bits(ref, model, batch, d["y1"], d["y2"], d["z1"], d["z2"],
                 d["params"][0], groups)


def control_stated(ref, model, batch: dict, y1, y2, z1, z2, cfg: dict,
                   traffic: dict) -> dict:
    """The control's code length, in the container's lanes, under rows
    from its own conditioning."""
    return {"params": (cfg["mm"], cfg["mm"]),
            "bits": _bits(ref, model, batch, y1, y2, z1, z2, cfg["mm"],
                          cfg["groups"]).cpu()}


def work(ref, model, pool, programs, cfg: dict) -> dict:
    """Kernels 5 and 4 in the traced stretch, from the shapes of the
    batches its programs coded: {"wavefront": [(GEMM FLOPs, coder
    operations)] a level-scan pass (an encode's two teacher passes, a
    decode's two decode passes), "pairs": [bytes] a kernel-4 launch (an
    encode's two)}."""
    m, g = model.M, cfg["groups"]
    h1, h2 = (model.entropy_parameters1_2.weight.shape[i] for i in (1, 0))
    scan, pairs = [], []
    for kind, idx, mms in programs:
        b, hh, ww, _ = pool[idx]["x1"].shape
        hy, wy = hh // 16, ww // 16
        for q, mm in zip((0, m), mms):
            scan.append(pass_work(b * hy * wy, m, 2 * m, q, h1, h2, mm))
            if kind == "enc":
                pairs.append(launch_bytes(b, hy, wy, m, g))
    return {"wavefront": scan, "pairs": pairs}


def pass_work(pixels: int, m: int, p: int, q: int, h1: int, h2: int,
              mm: int) -> tuple:
    """(GEMM FLOPs, coder operations) of one level-scan pass over
    `pixels` latents of M channels: per latent the 12 context taps (M ->
    2M) and the entropy-parameter layers (P + 2M + Q -> H1 -> H2 -> 2M),
    two FLOPs a multiply-add; and its coder on S = 2 mm + 1 bins."""
    s = 2 * mm + 1
    flops = 2 * pixels * (12 * m * 2 * m + (p + 2 * m + q) * h1 + h1 * h2
                          + h2 * 2 * m)
    ops = pixels * m * ((s + 1) * OPS_PER_EDGE + s * OPS_PER_BIN
                        + OPS_PER_LATENT)
    return float(flops), float(ops)


def launch_bytes(b: int, hy: int, wy: int, m: int, groups: int) -> float:
    """Kernel 4's bytes a launch: each valid slot's (start, freq), every
    slot's valid byte, each lane's count and state."""
    t_slots = groups * (3 * (hy - 1) + wy)
    lanes = b * _p_max(hy, wy) * (m // groups)
    return float(8 * b * hy * wy * m + t_slots * lanes + 12 * lanes)


def _p_max(hy: int, wy: int) -> int:
    return max(len(_level(s, hy, wy)) for s in range(3 * (hy - 1) + wy))


def _level(s: int, hy: int, wy: int) -> list:
    """Level s's rows i, in order (j = s - 3i)."""
    return [i for i in range(hy) if 0 <= s - 3 * i < wy]


def lane_map(hy: int, wy: int, m: int, groups: int):
    """(T, lanes a pair) int64 flat (m, i, j) index into an (M, hy, wy)
    latent of each slot of each lane, and the slots' validity."""
    mg = m // groups
    p_max = _p_max(hy, wy)
    n_levels = 3 * (hy - 1) + wy
    at = np.zeros((n_levels, groups, p_max, mg), np.int64)
    ok = np.zeros(at.shape, bool)
    for s in range(n_levels):
        for p, i in enumerate(_level(s, hy, wy)):
            for g in range(groups):
                ch = g * mg + np.arange(mg)
                at[s, g, p] = (ch * hy + i) * wy + s - 3 * i
                ok[s, g, p] = True
    return (at.reshape(n_levels * groups, p_max * mg),
            ok.reshape(n_levels * groups, p_max * mg))


def code_rows(y: torch.Tensor, scales, means, mm: int) -> tuple:
    """(f, start), each (B, M, h, w) int64: the frequency and interval
    start of each latent's residual round(y - mean), clipped to the grid,
    in the row of its Gaussian (module docstring), float64."""
    r = torch.round(y.double() - means.double())
    sym = (torch.clamp(r, -mm, mm) + mm).long()
    sc = scales.double().clamp_min(SCALE_BOUND)
    edges = [torch.special.ndtr((k - mm - 0.5) / sc)
             for k in range(2 * mm + 2)]
    pmf = torch.stack([(hi - lo).clamp_min(0)
                       for lo, hi in zip(edges[:-1], edges[1:])])
    scale = float(1 << PROB_BITS)
    rows = torch.clamp_min(torch.floor(pmf / pmf.sum(0, keepdim=True)
                                       * scale), 1.0)
    rows.scatter_add_(0, rows.argmax(dim=0, keepdim=True),
                      scale - rows.sum(0, keepdim=True))
    starts = torch.cumsum(rows, 0) - rows
    return (rows.gather(0, sym[None])[0].long(),
            starts.gather(0, sym[None])[0].long())


def rans_bits(f, start, hy: int, wy: int, groups: int) -> torch.Tensor:
    """Per pair and lane (B, lanes): the code length in bits of the
    container's coder over the intervals (f, start) (each (B, M, hy,
    wy)) in its lane order."""
    b, m = f.shape[:2]
    at, ok = (torch.as_tensor(a, device=f.device)
              for a in lane_map(hy, wy, m, groups))
    flat_f, flat_s = f.reshape(b, -1), start.reshape(b, -1)
    x = torch.full((b, at.shape[1]), 1 << PROB_BITS, dtype=torch.int64,
                   device=f.device)
    words = torch.zeros_like(x)
    for t in reversed(range(at.shape[0])):
        v = ok[t][None, :]
        ft, st = flat_f[:, at[t]], flat_s[:, at[t]]
        need = v & (x >= (ft << PROB_BITS))
        words += need
        x = torch.where(need, x >> PROB_BITS, x)
        q = x // ft
        x = torch.where(v, (q << PROB_BITS) + (x - q * ft) + st, x)
    return PROB_BITS * words + torch.log2(x.double()) - PROB_BITS


def _bits(ref, model, batch, y1, y2, z1, z2, mm, groups) -> torch.Tensor:
    """The code length (B, 2, lanes a pair) of y1 and y2 under rows built,
    chunk by chunk, from the reference's conditioning of z1, z2 and the
    latents themselves (their causal context; the right eye's left prior
    from y1)."""
    hy, wy = y1.shape[2:]
    out = []
    with torch.no_grad(), f32_backends():
        for lo in range(0, y1.shape[0], CHUNK):
            s = slice(lo, lo + CHUNK)
            h = torch.as_tensor(batch["h"][s],
                                device=batch["x1"].device).float()
            heads = ref.conditioning(model, z1[s], z2[s], h, y1[s], y2[s])
            out.append(torch.stack(
                [rans_bits(*code_rows(y[s], sc, mu, mm), hy, wy, groups)
                 for y, (sc, mu) in zip((y1, y2), heads)], 1))
    return torch.cat(out)
