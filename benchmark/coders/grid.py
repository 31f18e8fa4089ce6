"""The grid coder: HESIC's and DSIC's fast codecs (``HESICFastCodec``,
``DSICFastCodec``) and their batch container (``container.py``).

The codec quantises by rounding.  Its y coder is rANS with 16-bit words
and probabilities over per-pair, per-channel frequency rows built from
the GMM heads (K components) on a grid of half-width mm around each
channel's centre, round(channel mean); the container states mm per eye,
and each lane's code length through its word counts and final states.
The hooks are those of ``benchmark/coders/__init__.py``.
"""

from __future__ import annotations

import torch

from benchmark import container
from benchmark.judge import CHUNK, nchw
from benchmark.reference.layers import SCALE_BOUND, f32_backends

# the container's grid half-widths and its coder's probability scale
MM_BUCKETS = (4, 8, 16, 32)
PROB_BITS = 16


def build(cls, model, cfg: dict, traffic: dict):
    """The codec at the configuration's grid cap, its batch path sized to
    the traffic's batch."""
    return cls(model, mm=cfg["mm"], codec_batch=traffic["batch"]).update()


def encoded(codec, batch: dict, blob: bytes) -> tuple:
    """The program's encoder on the batch (``transforms_enc`` at the
    container's warp window): y1, y2 and the z symbols, NCHW float."""
    x1, x2 = nchw(batch["x1"]).contiguous(), nchw(batch["x2"]).contiguous()
    h = torch.as_tensor(batch["h"], device=x1.device).float()
    enc = codec.transforms_enc(x1, x2, h, blob[3])
    return tuple(t.float() for t in enc[:4])


def quantise(ref, model, eye: int, y: torch.Tensor, context) -> torch.Tensor:
    """Rounding; the grid coder reads no context."""
    return torch.round(y)


def stated(blob: bytes, cfg: dict) -> dict:
    """The container's lanes' code lengths and its grid half-widths."""
    rate = container.y_code_bits(blob, cfg["widths"]["M"])
    return {"bits": torch.as_tensor(rate["bits"]), "params": rate["mm"]}


def reference_bits(ref, model, batch: dict, d: dict) -> torch.Tensor:
    return _bits(ref, model, batch, d["y1"], d["y2"], d["z1"], d["z2"],
                 d["params"], d["bits"].shape[2])


def control_stated(ref, model, batch: dict, y1, y2, z1, z2, cfg: dict,
                   traffic: dict) -> dict:
    """The grids the container's rule picks for the control's latents (at
    most the configuration's cap), and their code length in the lanes the
    container's format gives the traffic's size."""
    mm = (pick_mm(y1, cfg["mm"]), pick_mm(y2, cfg["mm"]))
    hw = (traffic["size"] // 16) ** 2
    return {"params": mm, "bits": _bits(ref, model, batch, y1, y2, z1, z2,
                                        mm, hw // auto_ppl(hw)).cpu()}


def work(ref, model, pool, programs, cfg: dict) -> dict:
    """The coder kernels' launches in the traced stretch, from the
    reference's rounded latents of the batches the stretch coded, at the
    grids the containers name: {"gmm": [(B, M, K, hw, mm)], "rans":
    [(sum of sym + 1, symbols, lanes)] per eye and program}."""
    lat = {}
    with torch.no_grad(), f32_backends():
        for _, idx, _ in programs:
            if idx in lat:
                continue
            b = pool[idx]
            ys = [[], []]
            for lo in range(0, b["x1"].shape[0], CHUNK):
                s = slice(lo, lo + CHUNK)
                x1, x2 = nchw(b["x1"][s]), nchw(b["x2"][s])
                h = torch.as_tensor(b["h"][s], device=x1.device).float()
                y1, _ = ref.analysis(model, x1, x2, h)
                y1 = torch.round(y1)
                _, y2 = ref.analysis(model, x1, x2, h, y1)
                ys[0].append(y1)
                ys[1].append(torch.round(y2))
            lat[idx] = [torch.cat(y) for y in ys]
    gmm, rans = [], []
    for _, idx, mms in programs:
        for y, mm in zip(lat[idx], mms):
            bsz, m, hy, wy = y.shape
            hw = hy * wy
            c = torch.clamp(torch.round(y.mean(dim=(2, 3))), -127, 127)
            sym = torch.clamp(y - c[:, :, None, None], -mm, mm) + mm
            gmm.append((bsz, m, cfg["widths"]["K"], hw, int(mm)))
            rans.append((int((sym + 1).sum().item()), sym.numel(),
                         bsz * hw // auto_ppl(hw)))
    return {"gmm": gmm, "rans": rans}


def auto_ppl(hw: int) -> int:
    """Positions per rANS lane, as the container format fixes them."""
    for p in (8, 4, 2):
        if hw % p == 0 and (hw // p) % 128 == 0:
            return p
    return 1


def _bits(ref, model, batch, y1, y2, z1, z2, mm, lanes) -> torch.Tensor:
    """The code length of y1 and y2 (B, 2, lanes) under rows built, chunk
    by chunk, from the reference's conditioning of z1 and z2 (and of y1,
    for the right eye) on grids of half-widths `mm`."""
    rows = []
    for lo in range(0, y1.shape[0], CHUNK):
        s = slice(lo, lo + CHUNK)
        h = torch.as_tensor(batch["h"][s], device=batch["x1"].device).float()
        heads = ref.conditioning(model, z1[s], z2[s], h, y1[s])
        rows.append([code_rows(y[s], hd, model.K, g)
                     for y, hd, g in zip((y1, y2), heads, mm)])
    rows = [tuple(torch.cat([r[e][i] for r in rows]) for i in range(2))
            for e in range(2)]
    return rans_bits(rows, lanes)


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
