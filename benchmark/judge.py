"""What decides ``correct``: the timed path's own outputs, judged after the
window.  What depends on the codec's container and entropy coder is the
configuration's coder's (``benchmark/coders/``, its hooks numbered as
there); the arithmetic of the comparison is here.

1. Exactness (the codec's guarantee, limit 0): each kept decode's latents
   must equal the latents the program's encoder coded for that batch
   (the coder's ``encoded``).  A pair with one cell off has not decoded
   exactly.
2. Against the plain float32 reference (TF32 off), on the same weights,
   images and homographies, per kept pair:
   - ``y_mismatch_pct``: the share of both eyes' latent cells where the
     program's decoded latent differs from the reference's, quantised as
     the coder quantises (``quantise``) (the analyses, the warp by H or
     the cost volumes, and the coder's round trip);
   - ``x_rel_err_pct``: the RMS gap of the program's reconstructions to
     the reference's synthesis of the program's decoded latents, over
     the reference's RMS (the synthesis and the decoder-side warp);
   - ``z_mismatch_pct``: the share of both eyes' hyper-latent cells
     where the symbol the program's encoder codes differs from the
     reference's (its hyper-analyses of its own latents, less the
     medians, rounded);
   - ``rate_gap_pct``: how far the code length of each lane of each
     eye that the container states (``stated``) lies from the code
     length that the container's coder gives the program's decoded
     latents under rows built from the reference's conditioning of the
     program's z symbols (``reference_bits``; for HESIC the decoder's
     synthesis, warp and re-encode of the decoded left view): the lanes'
     absolute gaps over the reference's length, the worse eye's;
     ``rate_gap_left_pct`` the same of the left eye alone.  The
     hyper-analyses, the hyperpriors and both eyes' conditioning set the
     rate alone: encoder and decoder that agree decode exactly however
     they condition.
   Each number is the worst kept pair's.  A configuration's ``limits``
   name the numbers it compares; the others are printed as readings.
3. Every iteration the run drew for the check has to be judged: the
   pairs of a drawn batch the window never decoded count as failed
   (``unjudged_pairs``, limit 0).

The control puts the reference computed in fp8 (e4m3) in the program's
place (``control_outputs``): its quantised latents, its synthesis, and
its code length under rows built from its own fp8 conditioning
(``control_stated``).
"""

from __future__ import annotations

import torch

from benchmark.reference.layers import f32_backends

CHUNK = 8
# the numbers judged per pair; a configuration's limits name those it
# compares, and the others are readings
NAMES = ("y_mismatch_pct", "x_rel_err_pct", "z_mismatch_pct",
         "rate_gap_pct", "rate_gap_left_pct")


def nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).float()


def lane_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per pair: the lanes' code lengths `got` against `want` (B, lanes),
    the sum of their absolute gaps over the sum of `want`."""
    return (got - want).abs().sum(1) / want.sum(1)


def encoder_side(coder, codec, pool, kept) -> tuple:
    """What the program's encoder coded for each kept decode's batch
    (``coder.encoded``): per kept decode the pairs whose decoded latents
    differ anywhere from the encoder's ((B,) bool), and the encoder's
    hyper-latent symbols (z1, z2), NCHW float.  A kept decode is (pool
    index, the decode's outputs, its container)."""
    bad, zs = [], []
    for idx, rec, blob in kept:
        y1, y2, z1, z2 = coder.encoded(codec, pool[idx], blob)
        wrong = torch.zeros(y1.shape[0], dtype=torch.bool, device=y1.device)
        for got, want in ((rec["y1_hat"], y1), (rec["y2_hat"], y2)):
            want = want.permute(0, 2, 3, 1).float()
            wrong |= (got != want).flatten(1).any(dim=1)
        bad.append(wrong.cpu())
        zs.append((z1, z2))
    return bad, zs


def reference_numbers(ref, model, pool, decoded, coder) -> list:
    """Per pair of `decoded` (``program_outputs``), the numbers of
    ``NAMES`` against the reference `model`."""
    out = []
    with torch.no_grad(), f32_backends():
        for d in decoded:
            b = pool[d["idx"]]
            y1p, y2p, x1p, x2p = d["y1"], d["y2"], d["x1"], d["x2"]
            z1p, z2p = d["z1"], d["z2"]
            nums = []
            for lo in range(0, y1p.shape[0], CHUNK):
                s = slice(lo, lo + CHUNK)
                x1, x2 = nchw(b["x1"][s]), nchw(b["x2"][s])
                h = torch.as_tensor(b["h"][s], device=x1.device).float()
                y1, y2 = ref.analysis(model, x1, x2, h, y1p[s])
                q1 = coder.quantise(ref, model, 0, y1, y1p[s])
                q2 = coder.quantise(ref, model, 1, y2, y2p[s])
                mis = ((q1 != y1p[s]).flatten(1).sum(1)
                       + (q2 != y2p[s]).flatten(1).sum(1))
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
            want = coder.reference_bits(ref, model, b, d)
            got = d["bits"].to(want.device)
            gaps = torch.stack([lane_gap(got[:, e], want[:, e])
                                for e in range(2)], dim=1)
            out += [n + (100.0 * max(g), 100.0 * g[0])
                    for n, g in zip(nums, gaps.tolist())]
    return out


def program_outputs(coder, kept, cfg: dict, zs: list) -> list:
    """The kept decodes, each {"idx": pool index, "y1", "y2", "x1",
    "x2": NCHW float, "z1", "z2": the encoder's hyper-latent symbols
    (``encoder_side``), "bits": (B, 2, lanes) float64 code lengths of y1
    and y2 in each lane as the container states them, "params": the
    coding parameters it states}."""
    out = []
    for (idx, rec, blob), (z1, z2) in zip(kept, zs):
        out.append(dict(coder.stated(blob, cfg), idx=idx,
                        y1=nchw(rec["y1_hat"]), y2=nchw(rec["y2_hat"]),
                        x1=nchw(rec["x1_hat"]), x2=nchw(rec["x2_hat"]),
                        z1=z1, z2=z2))
    return out


def control_outputs(ref, model, pool, indices, coder, cfg: dict,
                    traffic: dict) -> list:
    """The reference in the program's place, computed in fp8, for the pool
    batches `indices`: its latents quantised as the coder quantises them,
    its synthesis of them, and the rate the coder states for them
    (``control_stated``); as ``program_outputs``."""
    from benchmark.reference.layers import set_precision

    set_precision(model, "fp8")
    out = []
    try:
        with torch.no_grad(), f32_backends():
            for idx in indices:
                b = pool[idx]
                parts = []
                for lo in range(0, b["x1"].shape[0], CHUNK):
                    s = slice(lo, lo + CHUNK)
                    x1, x2 = nchw(b["x1"][s]), nchw(b["x2"][s])
                    h = torch.as_tensor(b["h"][s],
                                        device=b["x1"].device).float()
                    y1, _ = ref.analysis(model, x1, x2, h)
                    y1r = coder.quantise(ref, model, 0, y1, None)
                    _, y2 = ref.analysis(model, x1, x2, h, y1r)
                    y2r = coder.quantise(ref, model, 1, y2, None)
                    parts.append((y1r, y2r)
                                 + tuple(ref.synthesis(model, y1r, y2r, h))
                                 + tuple(ref.hyper(model, y1, y2)))
                y1, y2, r1, r2, z1, z2 = (torch.cat(p) for p in zip(*parts))
                out.append(dict(coder.control_stated(
                    ref, model, b, y1, y2, z1, z2, cfg, traffic), idx=idx,
                    y1=y1, y2=y2, x1=r1, x2=r2, z1=z1, z2=z2))
    finally:
        set_precision(model, "f32")
    return out


def verdict(bad: list, numbers: list, limits: dict, unjudged: int) -> dict:
    """The compared numbers (each the worst pair's) beside their limits,
    the numbers no limit names (``readings``), the failed pairs and
    ``correct``.  `unjudged`: the pairs of the batches the run drew for
    the check that were never judged; each counts as failed."""
    n_bad = int(sum(int(b.sum()) for b in bad))
    flat_bad = [bool(x) for b in bad for x in b.tolist()] or \
        [False] * len(numbers)
    failed = unjudged + sum(
        1 for fb, nums in zip(flat_bad, numbers)
        if fb or any(v > limits[k] for k, v in zip(NAMES, nums)
                     if k in limits))
    worst = {k: max(v[i] for v in numbers) for i, k in enumerate(NAMES)
             } if numbers else {}
    checks = {"inexact_pairs": {"value": n_bad, "limit": 0},
              "unjudged_pairs": {"value": unjudged, "limit": 0}}
    checks.update({k: {"value": v, "limit": limits[k]}
                   for k, v in worst.items() if k in limits})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct and failed == 0, "failed": failed,
            "checks": checks, "pairs_checked": len(numbers),
            "readings": {k: v for k, v in worst.items() if k not in limits}}
