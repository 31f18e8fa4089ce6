"""What decides ``correct``: the timed path's own outputs, judged after the
window.

1. Exactness (the codec's guarantee, limit 0): each kept decode's latents
   must equal the latents the program's encoder computes for that batch
   (its ``transforms_enc`` at the container's warp window).  A pair with
   one cell off has not decoded exactly.
2. Against the plain float32 reference (TF32 off), on the same weights,
   images and homographies, per kept pair:
   - ``y_mismatch_pct``: the share of both eyes' latent cells where the
     program's decoded latent differs from the reference's rounded one
     (the analyses, the warp by H or the cost volumes, and the coder's
     round trip);
   - ``x_rel_err_pct``: the RMS gap of the program's reconstructions to
     the reference's synthesis of the program's decoded latents, over
     the reference's RMS (the synthesis and the decoder-side warp);
   - ``z_mismatch_pct``: the share of both eyes' hyper-latent cells
     where the symbol the program's encoder codes (``encoder_side``)
     differs from the reference's (its hyper-analyses of its own
     latents, less the medians, rounded);
   - ``rate_gap_pct``: how far the code length of each lane of each
     eye in the container (``container.y_code_bits``) lies from the
     code length that the container's coder (``rans_bits``) gives the
     program's decoded latents under rows built from the reference's
     conditioning of the program's z symbols (``code_rows``: both GMM
     heads; for HESIC the decoder's synthesis, warp and re-encode of
     the decoded left view): the lanes' absolute gaps over the
     reference's length, the worse eye's; ``rate_gap_left_pct`` the
     same of the left eye alone.  The hyper-analyses, the hyperpriors and both
     eyes' conditioning set the rate alone: encoder and decoder that
     agree decode exactly however they condition.
   Each number is the worst kept pair's.  A configuration's ``limits``
   name the numbers it compares; the others are printed as readings.

The control puts the reference computed in fp8 (e4m3) in the program's
place (``control_outputs``): its latents, its synthesis, and its code
length under rows built from its own fp8 conditioning.
"""

from __future__ import annotations

import torch

from benchmark import container
from benchmark.reference.layers import SCALE_BOUND, f32_backends

CHUNK = 8
# the numbers judged per pair; a configuration's limits name those it
# compares, and the others are readings
NAMES = ("y_mismatch_pct", "x_rel_err_pct", "z_mismatch_pct",
         "rate_gap_pct", "rate_gap_left_pct")
# the container's grid half-widths and its coder's probability scale
MM_BUCKETS = (4, 8, 16, 32)
PROB_BITS = 16


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).float()


def pick_mm(y: torch.Tensor, cap: int) -> int:
    """The container's rule: the smallest bucket that holds the batch's
    widest residual around the centres, at most `cap`."""
    c = torch.clamp(torch.round(y.mean(dim=(2, 3))), -127, 127)
    spread = int((y - c[:, :, None, None]).abs().amax())
    for mm in MM_BUCKETS:
        if mm >= cap:
            return cap
        if spread <= mm:
            return mm
    return cap


def code_rows(y: torch.Tensor, head, k: int, mm: int) -> tuple:
    """(f, start), each (B, M, h, w) int64: the frequency and the
    interval start of each integer latent of y (B, M, h, w) in the
    container's frequency rows built from the GMM head (sigma, means,
    weights).  The rows, as the container's format defines them: per pair
    and channel the centre c = round(mean) within +-127 and the grid
    [c - mm, c + mm]; each bin's mixture mass (scales at least 0.11) over
    the grid's, times 2^16, floored, at least 1, the deficit to 2^16
    added to the first largest bin; a channel whose latents all sit on
    its centre takes the degenerate row (2^16 - 2 mm on the centre, 1
    elsewhere).  A latent beyond the grid is coded as its edge bin (the
    container sends its value apart).  Float64 here, so a row may differ
    from the program's float32 one by a unit in a bin."""
    sigma, means, weights = head
    b, m = y.shape[:2]
    y = y.double()
    c = torch.clamp(torch.round(y.mean(dim=(2, 3))), -127, 127)
    c = c[:, :, None, None]
    sym = (torch.clamp(y - c, -mm, mm) + mm).long()
    dead = ((y - c) == 0).flatten(2).all(dim=2)[:, :, None, None]

    def slab(t):
        return t.double().reshape(b, k, m, *t.shape[2:])

    mu, w = slab(means), slab(weights)
    sc = slab(sigma).clamp_min(SCALE_BOUND)

    def cdf(e):
        return (w * torch.special.ndtr((c[:, None] + e - mu) / sc)).sum(1)

    edges = [cdf(s - mm - 0.5) for s in range(2 * mm + 2)]
    total = (edges[-1] - edges[0]).clamp_min(1e-300)
    scale = float(1 << PROB_BITS)
    rows = torch.stack([torch.clamp_min(torch.floor(
        (hi - lo).clamp_min(0) / total * scale), 1.0)
        for lo, hi in zip(edges[:-1], edges[1:])])     # (S, B, M, h, w)
    rows.scatter_add_(0, rows.argmax(dim=0, keepdim=True),
                      scale - rows.sum(0, keepdim=True))
    starts = torch.cumsum(rows, 0) - rows
    f = rows.gather(0, sym[None])[0]
    start = starts.gather(0, sym[None])[0]
    f = torch.where(dead, scale - 2 * mm, f)
    start = torch.where(dead, float(mm), start)
    return f.long(), start.long()


def rans_bits(rows: list, lanes: int) -> torch.Tensor:
    """Per pair, eye and lane (B, E, lanes): the code length in bits of
    the coder the container names, run over the intervals `rows` (per eye
    (f, start), each (B, M, h, w)): rANS with 16-bit words and
    probabilities, one state a lane from 2^16, lane l coding positions
    j * lanes + l of every channel in slot order (channel, j), the slots
    in reverse; 16 bits a word plus log2(final state) - 16."""
    b, m = rows[0][0].shape[:2]

    def layout(t):
        return t.reshape(b, m, -1, lanes).permute(1, 2, 0, 3).reshape(
            -1, b * lanes)

    f = torch.cat([layout(r[0]) for r in rows], dim=1)
    start = torch.cat([layout(r[1]) for r in rows], dim=1)
    x = torch.full_like(f[0], 1 << PROB_BITS)
    words = torch.zeros_like(x)
    for t in reversed(range(f.shape[0])):
        need = x >= (f[t] << PROB_BITS)
        words += need
        x = torch.where(need, x >> PROB_BITS, x)
        q = x // f[t]
        x = (q << PROB_BITS) + (x - q * f[t]) + start[t]
    bits = PROB_BITS * words + torch.log2(x.double()) - PROB_BITS
    return bits.reshape(len(rows), b, lanes).permute(1, 0, 2)


def lane_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per pair: the lanes' code lengths `got` against `want` (B, lanes),
    the sum of their absolute gaps over the sum of `want`."""
    return (got - want).abs().sum(1) / want.sum(1)


def encoder_side(codec, pool, kept) -> tuple:
    """What the program's encoder computes for each kept decode's batch
    (``transforms_enc`` at the container's warp window): per kept decode
    the pairs whose decoded latents differ anywhere from the encoder's
    ((B,) bool), and the encoder's hyper-latent symbols (z1, z2), NCHW
    float.  A kept decode is (pool index, the decode's outputs, its batch
    container)."""
    bad, zs = [], []
    for idx, rec, blob in kept:
        b = pool[idx]
        x1, x2 = nchw(b["x1"]).contiguous(), nchw(b["x2"]).contiguous()
        h = torch.as_tensor(b["h"], device=x1.device).float()
        enc = codec.transforms_enc(x1, x2, h, blob[3])
        wrong = torch.zeros(x1.shape[0], dtype=torch.bool, device=x1.device)
        for got, want in ((rec["y1_hat"], enc[0]), (rec["y2_hat"], enc[1])):
            want = want.permute(0, 2, 3, 1).float()
            wrong |= (got != want).flatten(1).any(dim=1)
        bad.append(wrong.cpu())
        zs.append((enc[2].float(), enc[3].float()))
    return bad, zs


def reference_numbers(ref, model, pool, decoded) -> list:
    """Per pair of `decoded` (``program_outputs``), the numbers of
    ``NAMES`` against the reference `model`."""
    out = []
    with torch.no_grad(), f32_backends():
        for d in decoded:
            b = pool[d["idx"]]
            y1p, y2p, x1p, x2p = d["y1"], d["y2"], d["x1"], d["x2"]
            z1p, z2p = d["z1"], d["z2"]
            nums, rows = [], []
            for lo in range(0, y1p.shape[0], CHUNK):
                s = slice(lo, lo + CHUNK)
                x1, x2 = nchw(b["x1"][s]), nchw(b["x2"][s])
                h = torch.as_tensor(b["h"][s], device=x1.device).float()
                y1, y2 = ref.analysis(model, x1, x2, h, y1p[s])
                mis = ((torch.round(y1) != y1p[s]).flatten(1).sum(1)
                       + (torch.round(y2) != y2p[s]).flatten(1).sum(1))
                cells = 2 * y1[0].numel()
                z1, z2 = ref.hyper(model, y1, y2)
                zmis = ((z1 != z1p[s]).flatten(1).sum(1)
                        + (z2 != z2p[s]).flatten(1).sum(1))
                zcells = 2 * z1[0].numel()
                r1, r2 = ref.synthesis(model, y1p[s], y2p[s], h)
                err = (((x1p[s] - r1) ** 2).flatten(1).sum(1)
                       + ((x2p[s] - r2) ** 2).flatten(1).sum(1))
                norm = ((r1 ** 2).flatten(1).sum(1)
                        + (r2 ** 2).flatten(1).sum(1))
                nums += [(100.0 * m / cells, 100.0 * (e / n) ** 0.5,
                          100.0 * zm / zcells)
                         for m, e, n, zm in zip(mis.tolist(), err.tolist(),
                                                norm.tolist(),
                                                zmis.tolist())]
                heads = ref.conditioning(model, z1p[s], z2p[s], h, y1p[s])
                rows.append([code_rows(y, hd, model.K, g) for y, hd, g in
                             zip((y1p[s], y2p[s]), heads, d["mm"])])
            rows = [tuple(torch.cat([r[e][i] for r in rows])
                          for i in range(2)) for e in range(2)]
            want = rans_bits(rows, d["bits"].shape[2])
            got = d["bits"].to(want.device)
            gaps = torch.stack([lane_gap(got[:, e], want[:, e])
                                for e in range(2)], dim=1)
            out += [n + (100.0 * max(g), 100.0 * g[0])
                    for n, g in zip(nums, gaps.tolist())]
    return out


def program_outputs(kept, m: int, zs: list) -> list:
    """The kept decodes, each {"idx": pool index, "y1", "y2", "x1",
    "x2": NCHW float, "z1", "z2": the encoder's hyper-latent symbols
    (``encoder_side``), "bits": (B, 2, lanes) float64 code lengths of y1
    and y2 in each lane as the container states them, "mm": its grid
    half-widths}."""
    out = []
    for (idx, rec, blob), (z1, z2) in zip(kept, zs):
        rate = container.y_code_bits(blob, m)
        out.append({"idx": idx, "y1": nchw(rec["y1_hat"]),
                    "y2": nchw(rec["y2_hat"]), "x1": nchw(rec["x1_hat"]),
                    "x2": nchw(rec["x2_hat"]), "z1": z1, "z2": z2,
                    "mm": rate["mm"], "bits": torch.as_tensor(rate["bits"])})
    return out


def control_outputs(ref, model, pool, indices, cap: int,
                    lanes: int) -> list:
    """The reference in the program's place, computed in fp8, for the pool
    batches `indices`: its rounded latents, its synthesis of them, and
    their code length under rows from its own conditioning, on the grids
    the container's rule picks for the batch (at most `cap`), in `lanes`
    lanes a pair; as ``program_outputs``."""
    from benchmark.reference.layers import set_precision

    def chunks(b):
        for lo in range(0, b["x1"].shape[0], CHUNK):
            s = slice(lo, lo + CHUNK)
            yield s, nchw(b["x1"][s]), nchw(b["x2"][s]), torch.as_tensor(
                b["h"][s], device=b["x1"].device).float()

    set_precision(model, "fp8")
    out = []
    try:
        with torch.no_grad(), f32_backends():
            for idx in indices:
                parts = []
                for _, x1, x2, h in chunks(pool[idx]):
                    y1, _ = ref.analysis(model, x1, x2, h)
                    y1r = torch.round(y1)
                    _, y2 = ref.analysis(model, x1, x2, h, y1r)
                    y2r = torch.round(y2)
                    parts.append((y1r, y2r)
                                 + tuple(ref.synthesis(model, y1r, y2r, h))
                                 + tuple(ref.hyper(model, y1, y2)))
                y1, y2, r1, r2, z1, z2 = (torch.cat(p) for p in zip(*parts))
                mm = (pick_mm(y1, cap), pick_mm(y2, cap))
                rows = []
                for s, x1, x2, h in chunks(pool[idx]):
                    heads = ref.conditioning(model, z1[s], z2[s], h, y1[s])
                    rows.append([code_rows(y[s], hd, model.K, g) for
                                 y, hd, g in zip((y1, y2), heads, mm)])
                rows = [tuple(torch.cat([r[e][i] for r in rows])
                              for i in range(2)) for e in range(2)]
                out.append({"idx": idx, "y1": y1, "y2": y2, "x1": r1,
                            "x2": r2, "z1": z1, "z2": z2, "mm": mm,
                            "bits": rans_bits(rows, lanes).cpu()})
    finally:
        set_precision(model, "f32")
    return out


def verdict(bad: list, numbers: list, limits: dict) -> dict:
    """The compared numbers (each the worst pair's) beside their limits,
    the numbers no limit names (``readings``), the failed pairs and
    ``correct``."""
    if not numbers:
        raise RuntimeError("the window ended before any decode the check "
                           "draws was made")
    n_bad = int(sum(int(b.sum()) for b in bad))
    flat_bad = [bool(x) for b in bad for x in b.tolist()] or \
        [False] * len(numbers)
    failed = sum(1 for fb, nums in zip(flat_bad, numbers)
                 if fb or any(v > limits[k] for k, v in zip(NAMES, nums)
                              if k in limits))
    worst = {k: max(v[i] for v in numbers) for i, k in enumerate(NAMES)}
    checks = {"inexact_pairs": {"value": n_bad, "limit": 0}}
    checks.update({k: {"value": v, "limit": limits[k]}
                   for k, v in worst.items() if k in limits})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct and failed == 0, "failed": failed,
            "checks": checks, "pairs_checked": len(numbers),
            "readings": {k: v for k, v in worst.items() if k not in limits}}
