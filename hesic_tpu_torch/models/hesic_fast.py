"""HESIC fast codec on the card: per-pair and batch containers, and the
pipelined encode.

Counterpart of hesic_tpu/models/hesic_fast.py (``HESICFastCodec``): the
per-pair container of format v3 (``compress_fast`` / ``decompress_fast``)
and the batch container (``compress_fast(batch_container=True)`` /
``decompress_fast_batch``), each byte for byte the JAX package's layout
after a writer byte of the port's own, and the pipelined batch encode
(``compress_fast_start`` / ``compress_fast_finish``).  Public layouts as
the JAX package's: images (B, H, W, 3) float32, homographies (B, 3, 3),
latents out as (B, hy, wy, M).

Pipeline.  Encode, device half: transforms (analysis, hyper-analysis, z
symbols, warp of x1, data-derived grid centres and spreads) -> ``cond1``
(z1 -> GMM heads -> frequency rows, kernel 1) -> grid rANS encode of y1
(kernel 2) -> ``cond2`` (synthesis1 -> warp -> re-encode of the decoded
left view -> GMM heads -> frequency rows, kernel 1) -> grid rANS encode
of y2 -> the words compacted on the device into exact-dense u16 in
(pair, lane) order; counts, states, z symbols, centres, spreads,
out-of-grid counts and dead bitmaps go to pinned host buffers on a copy
stream.  Host half: the words' copy sized from the counts (on a second
side stream, so it never waits behind a later batch's copies), the outlier
records, the z strings on the host rANS coder, the containers.  Decode
mirrors it: the z strings, one pinned upload of counts, states and words,
the cap-major word buffer rebuilt on the device, then cond1 -> kernel 3
-> outlier correction -> cond2 -> kernel 3 -> synthesis.

The synchronous ``compress_fast`` waits once for the spreads (they pick
the grid widths) and then for the copies.  ``compress_fast_start``
dispatches the whole device half without waiting for the device, at the
grid widths the last finished batch picked (its first call runs the
synchronous batch encode, as the JAX package's does); latents outside
the grid travel as escapes, so every container stays exact.
``compress_fast_finish`` waits for that batch's copies only.  All compute
runs on the current stream, in issue order, so a pipelined container is
the synchronous one of the same batch and grids, byte for byte.
``decompress_fast_batch`` only dispatches; ``decompress_fast``
synchronises before it returns.  The four protocol methods, the side
streams and the copies are models/base.py's ``PipelinedCodec``, which
HESIC+'s wavefront device codec shares; so are the container pieces
(escape records, length-prefixed z strings, the decoder's packed upload,
the lane-major word rebuild, the correction maps).  Both decoders parse
into one form and share the tail after it (``_decode_parsed``).

Tracing (utils/tracing.py; entered only while a profiler records).  Each
public call is a span ``codec/<method>`` holding ``count/batch`` (the
encode's sequence number, carried in its handle, or the decode's) and
``count/device_allocs``; inside it, a span at every stage:
``enc/transforms``, ``enc/wait-spreads``, ``enc/cond1``, ``enc/cond2``,
``enc/rans``, ``enc/compact``, ``enc/fetch``, ``enc/wait-copies``,
``enc/words-d2h``, ``enc/wait-words``, ``enc/outliers`` (around
``enc/wait-outliers``), ``enc/z-rans``, ``enc/container``; ``dec/parse``,
``dec/outliers-parse``, ``dec/z-rans``, ``dec/stage``, ``dec/upload``,
``dec/expand-words``, ``dec/corr-map``, ``dec/cond1``, ``dec/rans``,
``dec/cond2``, ``dec/synthesis``, ``dec/wait``.  A ``wait`` stage is the
host blocked on the device.  Counters: ``count/h2d_bytes`` (``_upload``),
``count/d2h_bytes`` (PipelinedCodec's ``_fetch`` and ``_fetch_words``),
``count/latents`` and ``count/escapes`` (``_host_pieces``).

Bit-exactness invariant: everything that parameterizes the coder (GMM
heads -> frequency rows, including the decoded-left re-encoding chain)
must be computed identically by encoder and decoder.  Both sides call the
same ``_cond1``/``_cond2`` at one canonical batch size (``codec_batch``,
padded and chunked), with cuDNN deterministic, not benchmarking, and TF32
off (``deterministic_backends``), so cuDNN runs the same algorithms on the
same shapes; the rows themselves come from kernel 1, whose float chain is
strict IEEE.  Only integers cross between the stages.

Writer byte.  Byte 0 names the writer: the two conditioning chains (the
JAX package's XLA programs, the port's card and its CPU twin) differ in
their last bits, so a container decodes exactly only where it was
written, and any other writer's container is refused.  Bytes 1 onward
keep the JAX package's layouts.  A decoder also refuses a container
whose parse does not end at its last byte (a batch container handed to
the per-pair decoder, or the other way round).

Format notes (as the JAX package): y symbols are coded on a per-channel
grid [c_m - mm, c_m + mm] around the data-derived centre c_m (i8 in the
container), mm picked per eye from MM_BUCKETS by the residual spread;
latents beyond the grid travel exactly as (index, value) corrections;
constant channels are flagged in a bitmap and coded with degenerate rows;
each rANS lane codes ``ppl`` positions; z streams use the host coder.

Container API.  As the JAX class, HESICFastCodec is a HESICCodec
(models/hesic_codec.py): ``compress(x1, x2, h_matrix, output_name,
output_path)``, ``decompress(output_name, output_path, h_matrix)`` and
``decompress_bytes`` write and read the reference-layout container over
the same model and tables, byte for byte what HESICCodec writes.

FLOP count.  ``device_flops`` is PyTorch's count of matmuls and
convolutions (FlopCounterMode, not XLA's cost analysis) of one round
trip's programs under the JAX package's names and sum.  The rANS and PMF
kernels (1-3) are opaque to it, as the Pallas kernels were to XLA, and
so are their plain twins, which do no matmul or convolution: the count
is the same on the CPU and the card.

Not carried over from the JAX codec: the TPU link transport (packed link
vectors, z nibble packing, sticky word budgets and link buckets, decoder
size watermarks) and the synchronous fallback they need; of the sticky
state only the grid widths are kept.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..codecs.device_rans import (pack_counts, pack_stream_dense,
                                  unpack_counts, unpack_stream_dense)
from ..codecs.grid_rans import (default_cap, rans_decode_grid_rows,
                                rans_encode_grid_rows)
from ..codecs.pmf import gmm_freq
from ..geometry import pick_warp_win, pick_warp_xwin, warp_perspective
from ..utils.tracing import call, count, span
from .base import (PipelinedCodec, correction_maps, counted_flops,
                   escape_record, expand_lanes, length_prefixed, pack_parts,
                   prefixed_extents, read_escape_record, split_parts, u16)
from .hesic_codec import HESICCodec

MM_DEFAULT = 32
MM_BUCKETS = (4, 8, 16, 32)
TOTAL_FREQ = 1 << 16
# Byte 0 of a container.  The JAX package's are 0-2 (formats before v3)
# and 3 (format v3); the port's two writers take ids of their own.
WRITER_NAMES = {0: "the JAX package's pre-v2 xla-erfc format",
                1: "the JAX package's pre-v2 pallas-erfc format",
                2: "the JAX package's format v2",
                3: "the JAX package's format v3",
                16: "torch-plain-fast-v3", 17: "cuda-fast-v3"}


def auto_ppl(hw: int) -> int:
    """Positions per lane: the largest of (8, 4, 2) keeping hw/ppl a
    multiple of 128, else 1 (the JAX package's rule, which the container's
    lane count encodes)."""
    for p in (8, 4, 2):
        if hw % p == 0 and (hw // p) % 128 == 0:
            return p
    return 1


def pick_mm(spread: int, cap: int) -> int:
    """Smallest grid half-width bucket covering the residual spread
    (capped; stragglers ride the escape side-channel)."""
    for mm in MM_BUCKETS:
        if mm >= cap:
            return cap
        if spread <= mm:
            return mm
    return cap


def _data_center(y_hat: torch.Tensor):
    """(B, M, h, w) int latents -> (centres (B, M) int32 =
    clip(round(mean), +-127), spread () int32 = max |y - centre|)."""
    dc = torch.clamp(torch.round(y_hat.float().mean(dim=(2, 3))), -127, 127)
    dc = dc.to(torch.int32)
    spread = torch.abs(y_hat - dc[:, :, None, None]).amax()
    return dc, spread.to(torch.int32)


def _dead_override(freq, dead, mm: int):
    """Degenerate rows (centre bin holds all mass but the S-1 minimum
    bins) for constant channels; integer-only, identical on both sides."""
    s = freq.shape[2]
    iota = torch.arange(s, device=freq.device).view(1, 1, s, 1)
    dead_row = torch.where(iota == mm, TOTAL_FREQ - (s - 1), 1).to(
        freq.dtype)
    return torch.where(dead[:, :, None, None], dead_row, freq)


def _gmm_freq_fast(sigma, means, weights, mm: int, k: int, center):
    """(B, K*M, h, w) GMM head outputs + (B, M) int32 data-derived centres
    -> (B, M, S, h*w) frequency rows (kernel 1 on the card)."""
    return gmm_freq(sigma.contiguous(), means.contiguous(),
                    weights.contiguous(), mm, k,
                    center.to(torch.int32).contiguous())


def _encode_stream(freq, y_hat, mm: int, center, ppl: int = 1,
                   cap: int = None):
    """Interleaved-lane encode of (B, M, hy, wy) integer latents on their
    centred grids.  Returns (words (B, CAP, ls), counts (B, ls), states
    (B, ls), per-pair out-of-grid counts (B,), dead channels (B, M))."""
    b, m, s, hw = freq.shape
    rel = y_hat.reshape(b, m, hw) - center[:, :, None]
    over = (torch.abs(rel) > mm).sum(dim=(1, 2))
    dead = (rel == 0).all(dim=2)
    freq = _dead_override(freq, dead, mm)
    sym = (torch.clamp(rel, -mm, mm) + mm).to(torch.int32)
    words, counts, states = rans_encode_grid_rows(
        freq, sym.permute(1, 0, 2).contiguous(), ppl=ppl, cap=cap)
    return words, counts, states, over, dead


def _decode_stream(freq, words, counts, states, mm: int, hy: int, wy: int,
                   center, ppl: int = 1, dead=None):
    """Inverse of _encode_stream: (B, M, hy, wy) int32 latents, clamped to
    the grids (outliers are restored by the caller)."""
    b, m, s, hw = freq.shape
    if dead is not None:
        freq = _dead_override(freq, dead, mm)
    syms = rans_decode_grid_rows(freq, words, counts, states, ppl=ppl)
    y = syms.permute(1, 0, 2) - mm + center[:, :, None]
    return y.reshape(b, m, hy, wy)


def compact_words(words, counts) -> torch.Tensor:
    """(B, CAP, ls) int32 u16 words and (B, ls) counts -> an int16 vector
    whose first sum(counts) entries are each lane's first `count` words
    (u16 bit patterns) in (pair, lane, slot) order: the container's
    exact-dense stream.  Runs where the words are, with no host sync; the
    rest of the vector is scratch (every element writes a slot of its
    own, so the result does not depend on the write order)."""
    b, cap, ls = words.shape
    n = b * ls * cap
    c = counts.reshape(-1).to(torch.int64)
    start = torch.cumsum(c, 0) - c
    j = torch.arange(cap, device=words.device)
    dest = torch.where(j[None, :] < c[:, None], start[:, None] + j[None, :],
                       n + torch.arange(n, device=words.device).view(-1, cap))
    w16 = u16(words.permute(0, 2, 1).reshape(b * ls, cap))
    flat = torch.empty(2 * n, dtype=torch.int16, device=words.device)
    flat.scatter_(0, dest.reshape(-1), w16.reshape(-1))
    return flat[:n]


def expand_words(flat, counts, cap: int) -> torch.Tensor:
    """Inverse of compact_words: exact-dense u16 words (int32 values) and
    (B, ls) counts -> the cap-major (B, cap, ls) int32 buffer kernel 3
    reads (zero past each lane's count): the lane-major rebuild over the
    batch's (pair, lane) lanes, made cap-major."""
    b, ls = counts.shape
    out = expand_lanes(flat, counts.reshape(-1), cap)
    return out.reshape(b, ls, cap).permute(0, 2, 1).contiguous()


def writer_id(device) -> int:
    """The writer byte of containers encoded on `device`: 17 = the card,
    16 = the plain twins (CPU)."""
    return 17 if torch.device(device).type == "cuda" else 16


def _check_format(blob: bytes, device) -> int:
    """Raise unless `blob` was written by the writer `device` runs;
    returns the header bytes consumed (1)."""
    tag, cur = blob[0], writer_id(device)
    if tag != cur:
        raise ValueError(
            f"fast container written by "
            f"{WRITER_NAMES.get(tag, f'an unknown writer ({tag})')} but "
            f"this codec reads {WRITER_NAMES[cur]} only; decode it with "
            f"its writer")
    return 1


def _check_end(blob: bytes, off: int, what: str):
    """Raise unless a parse of `blob` ended at its last byte."""
    if off != len(blob):
        raise ValueError(
            f"{what}: the parse ends at byte {off} of {len(blob)}; not a "
            f"{what} (a per-pair container goes to decompress_fast, a "
            f"batch container to decompress_fast_batch)")


def _check_shape(h_img: int, w_img: int, lanes: int, what: str):
    hw = (h_img // 16) * (w_img // 16)
    if h_img < 64 or w_img < 64 or lanes < 1 or hw % lanes:
        raise ValueError(f"{what}: image {h_img}x{w_img} with {lanes} "
                         f"lanes is not a valid layout")


class HESICFastCodec(HESICCodec, PipelinedCodec):
    """HESIC with the fused on-device coder: ``compress_fast`` /
    ``decompress_fast`` over per-pair v3 containers, the batch container
    (``decompress_fast_batch``) and the pipelined batch encode
    (``compress_fast_start`` / ``compress_fast_finish``), on the protocol
    of models/base.py's PipelinedCodec; ``compress`` / ``decompress`` keep
    HESICCodec's reference-layout container."""

    def __init__(self, model, mm: int = MM_DEFAULT, codec_batch: int = 8):
        super().__init__(model)    # sets the determinism policy
        self.mm = mm
        self.codec_batch = codec_batch
        # the grid widths (mm1, mm2) the last finished encode picked: the
        # pipelined encode's one piece of sticky state
        self._next_mm = None

    # ---- shared conditioning programs (identical on both sides) ----

    def _cond1_fn(self, z1_sym, center, mm: int):
        z1_hat = z1_sym.float() + self._median("entropy_bottleneck1")
        sigma, means, weights = self.model.gmm1(z1_hat)
        return _gmm_freq_fast(sigma, means, weights, mm, self.model.K,
                              center)

    def _cond2_fn(self, y1_hat, z2_sym, h, center, mm: int, win: int):
        """-> (frequency rows of eye 2, the aux input of _synthesize:
        here the decoded left view)."""
        x1_hat = self.model.synthesis1(y1_hat.float())
        x1_warp_ac, _ = warp_perspective(x1_hat, h, win)
        y1_prior = torch.round(self.model.analysis1(x1_warp_ac))
        z2_hat = z2_sym.float() + self._median("entropy_bottleneck2")
        sigma, means, weights = self.model.gmm2(z2_hat, y1_prior)
        freq = _gmm_freq_fast(sigma, means, weights, mm, self.model.K,
                              center)
        return freq, x1_hat

    def _cond1(self, z1_sym, center, mm: int):
        return self._run_canonical(
            lambda z, c: self._cond1_fn(z, c, mm), (z1_sym, center))

    def _cond2(self, y1_hat, z2_sym, h, center, mm: int, win: int):
        return self._run_canonical(
            lambda y, z, hh, c: self._cond2_fn(y, z, hh, c, mm, win),
            (y1_hat, z2_sym, h, center))

    def _run_canonical(self, fn, args):
        """Run `fn` over chunks padded to exactly `codec_batch` items (the
        last item repeated), each argument with contiguous strides: a
        convolution's result can depend on its input's strides, and the
        decoder's corrected latents come out of a channels-last map."""
        b = args[0].shape[0]
        b0 = self.codec_batch
        outs = []
        for lo in range(0, b, b0):
            hi = min(lo + b0, b)
            chunk = [a[lo:hi].contiguous() for a in args]
            pad = b0 - (hi - lo)
            if pad:
                chunk = [torch.cat([c, c[-1:].expand((pad,) + c.shape[1:])])
                         for c in chunk]
            res = fn(*chunk)
            res = res if isinstance(res, tuple) else (res,)
            outs.append(tuple(r[: hi - lo] for r in res))
        merged = tuple(torch.cat([o[i] for o in outs]) if len(outs) > 1
                       else outs[0][i] for i in range(len(outs[0])))
        return merged if len(merged) > 1 else merged[0]

    # ---- cost accounting ----

    def device_flops(self, h_img: int, w_img: int, cap: int = 32,
                     win: int = 64, xwin=None) -> dict:
        """PyTorch's count of matmuls and convolutions (FlopCounterMode) in
        one encode and decode round trip of `codec_batch` h_img x w_img
        pairs.  Runs each program once under torch.no_grad() on seeded
        images of those shapes, on the codec's device, each program's
        inputs the previous ones' outputs: ``transforms_enc``, ``cond1``
        and ``cond2`` (the conditioning at the canonical batch and the
        grid cap), ``encode_stream`` and ``decode_stream`` (kernels 2 and
        3: 0.0, as the kernels are opaque), ``synth_out``
        (``_synthesize``).  flops_total = transforms_enc + 2 cond1 + 2
        cond2 + 2 encode_stream + 2 decode_stream + synth_out, as the JAX
        package sums it.  Returns {"flops_total", "flops_per_pair",
        "per_program"}.

        `cap`, `win` and `xwin` are the JAX signature's.  The port's warp
        is a gather, which the counter does not count, so `win` and
        `xwin` do not move the count (the JAX package's warp is a
        matmul); `cap` is a word budget of kernel 2, which the count does
        not see.  On the card it launches kernel 1 twice and kernels 2
        and 3 once each.  The codec's tables, grids and determinism
        policy are left as they were."""
        b, mm = self.codec_batch, self.mm
        hy, wy = h_img // 16, w_img // 16
        ppl = auto_ppl(hy * wy)
        gen = torch.Generator(device=self.device).manual_seed(0)
        x1, x2 = (self._to_device(torch.rand(
            (b, h_img, w_img, 3), generator=gen, device=self.device))
            for _ in range(2))
        h, _ = self._homographies(np.eye(3, dtype=np.float32)[None], b)
        per = {}

        def count(name, fn, *args):
            out, per[name] = counted_flops(fn, *args)
            return out

        with torch.no_grad():
            y1, y2, z1, z2, dc1, dc2, _, _ = count(
                "transforms_enc", self.transforms_enc, x1, x2, h, win)
            freq1 = count("cond1", self._cond1_fn, z1, dc1, mm)
            freq2, aux = count("cond2", self._cond2_fn, y1, z2, h, dc2, mm,
                               win)
            words, counts, states, _, dead = count(
                "encode_stream", _encode_stream, freq1, y1, mm, dc1, ppl,
                default_cap(self.model.M, ppl))
            count("decode_stream", _decode_stream, freq1, words, counts,
                  states, mm, hy, wy, dc1, ppl, dead)
            count("synth_out", self._synthesize, aux, y2, h, win)
        total = (per["transforms_enc"] + 2 * per["cond1"] + 2 * per["cond2"]
                 + 2 * per["encode_stream"] + 2 * per["decode_stream"]
                 + per["synth_out"])
        return {"flops_total": total, "flops_per_pair": total / b,
                "per_program": per}

    # ---- encoder side ----

    @torch.no_grad()
    def transforms_enc(self, x1, x2, h, win: int):
        """NCHW images -> (y1_hat, y2_hat, z1_sym, z2_sym, dc1, dc2, sp1,
        sp2): the true rounded latents (unclamped), z symbols, grid
        centres and spreads."""
        m = self.model
        y1 = m.analysis1(x1)
        z1 = m.hyper_analysis1(y1)
        z1_sym = torch.round(z1 - self._median("entropy_bottleneck1"))
        y1_hat = torch.round(y1).to(torch.int32)
        x1_warp, _ = warp_perspective(x1, h, win)
        y2 = m.analysis2(x1_warp, x2)
        z2 = m.hyper_analysis2(y2)
        z2_sym = torch.round(z2 - self._median("entropy_bottleneck2"))
        y2_hat = torch.round(y2).to(torch.int32)
        dc1, sp1 = _data_center(y1_hat)
        dc2, sp2 = _data_center(y2_hat)
        return (y1_hat, y2_hat, z1_sym.to(torch.int32),
                z2_sym.to(torch.int32), dc1, dc2, sp1, sp2)

    def _encode_device(self, x1, x2, h_matrix, mm=None, warp=None,
                       agree_spreads=None) -> dict:
        """The encoder's device half, dispatched: transforms, cond1 and
        cond2, the two stream encodes (kernel 2 once per eye at the
        guaranteed word bound, so no lane can overflow it), the words'
        compaction, and the copies of what the host half reads.  With
        `mm` None the spreads are read first (one host sync) to pick the
        grid widths; with `mm` = (mm1, mm2) nothing waits for the device.
        The split encode (parallel/codec.py) passes the batch's choices
        made from every rank's pairs: `warp` = (win, xwin), and
        `agree_spreads`, which maps the (2,) spreads to the batch's before
        the grids are picked.  Returns the handle compress_fast_finish
        reads (its "seq": the encode's sequence number)."""
        t0 = time.perf_counter()
        seq = self._encodes
        self._encodes += 1
        with span("enc/transforms"):
            x1, x2 = self._to_device(x1), self._to_device(x2)
            b, _, h_img, w_img = x1.shape
            h, h_np = self._homographies(h_matrix, b)
            if warp is None:
                warp = (pick_warp_win(h_np, h_img, w_img),
                        pick_warp_xwin(h_np, h_img, w_img))
            win, xw = warp
            (y1_hat, y2_hat, z1_sym, z2_sym, dc1, dc2, sp1,
             sp2) = self.transforms_enc(x1, x2, h, win)
        if mm is None:
            with span("enc/wait-spreads"):
                sp = torch.stack([sp1, sp2])
                if agree_spreads is not None:
                    sp = agree_spreads(sp)
                    sp1, sp2 = sp[0], sp[1]
                sp = sp.tolist()
            mm = (pick_mm(sp[0], self.mm), pick_mm(sp[1], self.mm))
        mm1, mm2 = mm
        with span("enc/cond1"):
            freq1 = self._cond1(z1_sym, dc1, mm1)
        with span("enc/cond2"):
            freq2, _ = self._cond2(y1_hat, z2_sym, h, dc2, mm2, win)
        with span("enc/rans"):
            hy, wy = y1_hat.shape[2], y1_hat.shape[3]
            ppl = auto_ppl(hy * wy)
            cap = default_cap(self.model.M, ppl)
            s1 = _encode_stream(freq1, y1_hat, mm1, dc1, ppl, cap)
            s2 = _encode_stream(freq2, y2_hat, mm2, dc2, ppl, cap)
        with span("enc/compact"):
            words = (compact_words(s1[0], s1[1]),
                     compact_words(s2[0], s2[1]))
        with span("enc/fetch"):
            meta = torch.cat([t.reshape(-1).to(torch.int64) for t in (
                s1[1], s2[1], s1[2], s2[2], dc1, dc2, sp1, sp2, s1[3],
                s2[3], s1[4], s2[4])])
            z = torch.cat([t.permute(0, 2, 3, 1).reshape(-1)
                           for t in (z1_sym, z2_sym)])
            fetched = self._fetch({"meta": meta, "z": z})
        return {"mode": "async", "seq": seq, "t0": t0, "mm": (mm1, mm2),
                "win": win,
                "xwin": xw, "h_np": h_np, "shape": (h_img, w_img),
                "lanes": s1[1].shape[1], "cap": cap,
                "z_shape": tuple(z1_sym.permute(0, 2, 3, 1).shape),
                "y": (y1_hat, y2_hat), "dc": (dc1, dc2), "words": words,
                **fetched}

    def _collect_outliers(self, y_hat, over: np.ndarray, center,
                          mm: int) -> list:
        """Per-pair (flat NHWC index u32, true value i32) of the latents
        beyond the centred grid; empty when ``over`` is all zero."""
        b = y_hat.shape[0]
        total = int(over.sum())
        empty = (np.zeros(0, np.uint32), np.zeros(0, np.int32))
        if total == 0:
            return [empty] * b
        y = y_hat.permute(0, 2, 3, 1).reshape(b, -1)
        cen = center[:, None, None, :].expand(
            b, y_hat.shape[2], y_hat.shape[3], -1).reshape(b, -1)
        # nonzero waits for the device to size its output, .cpu() to copy
        with span("enc/wait-outliers"):
            pair, local = torch.nonzero(torch.abs(y - cen) > mm,
                                        as_tuple=True)
            vals = y[pair, local]
            pair, local, vals = (t.cpu().numpy() for t in (pair, local,
                                                            vals))
        if pair.size != total:
            raise RuntimeError(
                f"outlier collection found {pair.size} latents beyond the "
                f"grid but the stream counted {total}")
        return [(local[pair == i].astype(np.uint32),
                 vals[pair == i].astype(np.int32)) for i in range(b)]

    def _outliers(self, handle, over1, over2):
        """Both eyes' outlier records.  On the card they are collected on
        the finish stream, which waits on the handle's compute event only,
        so they do not queue behind work issued after the encode."""
        (y1, y2), (c1, c2) = handle["y"], handle["dc"]
        mm1, mm2 = handle["mm"]
        ctx = (self._on_finish_stream(handle, (y1, y2, c1, c2))
               if over1.any() or over2.any() else contextlib.nullcontext())
        with ctx:
            return (self._collect_outliers(y1, over1, c1, mm1),
                    self._collect_outliers(y2, over2, c2, mm2))

    def _finish(self, handle, batch_container: bool) -> dict:
        """The encoder's host half: the host pieces (_host_pieces), then
        the z strings and the containers (_containers)."""
        pieces = self._host_pieces(handle)
        out = self._containers(handle, pieces, batch_container)
        out["enctime"] = time.perf_counter() - handle["t0"]
        out["outliers"] = pieces["outlier_counts"]
        return out

    def _host_pieces(self, handle) -> dict:
        """Wait for the handle's copies, fetch the words sized from the
        counts and collect the outliers: the per-pair pieces of the
        containers (z symbols, outlier records, dead bitmaps, centres,
        each eye's words, counts and states), in pair order, and the
        eyes' outlier counts."""
        b = len(handle["y"][0])
        ls, m = handle["lanes"], self.model.M
        with span("enc/wait-copies"):
            host = self._fetched(handle)
            meta, z = host["meta"], host["z"]
        n = b * ls
        sizes = (n, n, n, n, b * m, b * m, 1, 1, b, b, b * m, b * m)
        (c1, c2, st1, st2, dc1, dc2, sp1, sp2, over1, over2, dead1,
         dead2) = np.split(meta, np.cumsum(sizes)[:-1])
        c1, c2 = c1.reshape(b, ls), c2.reshape(b, ls)
        cmax = int(max(c1.max(), c2.max()))
        if cmax > handle["cap"]:
            raise RuntimeError(f"grid encoder counted {cmax} words in a "
                               f"lane, past its bound {handle['cap']}")
        # the next pipelined batch's grids, from this batch's spreads
        self._next_mm = (pick_mm(int(sp1[0]), self.mm),
                         pick_mm(int(sp2[0]), self.mm))
        totals = [int(c1.sum()), int(c2.sum())]
        flat1, flat2 = self._fetch_words(
            handle, totals, handle["words"],
            lambda: [w[:n] for w, n in zip(handle["words"], totals)])
        with span("enc/outliers"):
            out1, out2 = self._outliers(handle, over1, over2)
        count("latents", 2 * handle["y"][0].numel())
        count("escapes", over1.sum() + over2.sum())
        zn = z.size // 2
        pieces = {
            "z": (z[:zn].reshape(handle["z_shape"]),
                  z[zn:].reshape(handle["z_shape"])),
            "outliers": (out1, out2),
            "dead": (dead1.reshape(b, m) != 0, dead2.reshape(b, m) != 0),
            "centres": (dc1.reshape(b, m), dc2.reshape(b, m)),
            "streams": ((flat1, c1, st1.reshape(b, ls).astype(np.uint32)),
                        (flat2, c2, st2.reshape(b, ls).astype(np.uint32))),
            "outlier_counts": (int(over1.sum()), int(over2.sum())),
        }
        return pieces

    def _containers(self, handle, p: dict, batch_container: bool) -> dict:
        """Containers from the host pieces: one per pair (format v3), or
        one for the batch (the JAX package's batch layout).  Each pair's
        fields are written once; the batch layout joins them field by
        field, the per-pair layout pair by pair."""
        with span("enc/z-rans"):
            z_strs = list(zip(
                self.eb_encode_symbols("entropy_bottleneck1", p["z"][0]),
                self.eb_encode_symbols("entropy_bottleneck2", p["z"][1])))
        with span("enc/container"):
            b = len(z_strs)
            h_img, w_img = handle["shape"]
            mm1, mm2 = handle["mm"]
            xw = handle["xwin"]
            lead = bytes([writer_id(self.device), mm1, mm2, handle["win"],
                          0 if xw is None else xw // 16])
            (o1, o2), (d1, d2) = p["outliers"], p["dead"]
            fields = [
                [length_prefixed(pair) for pair in z_strs],
                [escape_record(*o1[i]) + escape_record(*o2[i])
                 for i in range(b)],
                [np.packbits(d1[i]).tobytes() + np.packbits(d2[i]).tobytes()
                 for i in range(b)],
                *([row.tobytes() for row in c.astype(np.int8)]
                  for c in p["centres"]),
                [row.tobytes() for row in
                 handle["h_np"].astype(np.float32).reshape(b, 9)]]
            if batch_container:
                head = lead + np.array([h_img, w_img, b, handle["lanes"]],
                                       np.uint32).tobytes()
                body = b"".join(pack_counts(c.reshape(-1)) + st.tobytes()
                                + flat.tobytes()
                                for flat, c, st in p["streams"])
                blobs = [head + b"".join(b"".join(f) for f in fields)
                         + body]
            else:
                ends = [np.concatenate([[0], np.cumsum(c.sum(axis=1))])
                        for _, c, _ in p["streams"]]
                hw = np.array([h_img, w_img], np.uint16).tobytes()
                blobs = [lead + hw + b"".join(f[i] for f in fields)
                         + b"".join(pack_stream_dense(flat[e[i]:e[i + 1]],
                                                      c[i], st[i])
                                    for (flat, c, st), e in zip(p["streams"],
                                                                ends))
                         for i in range(b)]
        total = sum(len(bl) for bl in blobs)
        return {"blobs": blobs, "blob": blobs[0],
                "bpp_real": total * 8 / (2 * h_img * w_img * b)}

    def _start(self, x1, x2, h_matrix) -> dict:
        """A start at the grid widths the last finished encode picked.  The
        first one (no grids picked yet) runs the synchronous batch encode
        and returns {"mode": "sync", "seq", "out"}."""
        if self._next_mm is None:
            handle = self._encode_device(x1, x2, h_matrix)
            return {"mode": "sync", "seq": handle["seq"],
                    "out": self._finish(handle, True)}
        return self._encode_device(x1, x2, h_matrix, self._next_mm)

    # ---- decoder side ----

    def _corr_map(self, outliers, y_shape):
        """Dense (mask, true value) (B, hy, wy, M) int32 maps on the
        device, or None when no pair has outliers: the records go up as
        one sparse vector and are scattered there.  Set semantics: the
        decoder overwrites the clamped decode with the stored true
        value."""
        if all(idx.size == 0 for idx, _ in outliers):
            return None
        b = len(outliers)
        hy, wy = y_shape
        per = hy * wy * self.model.M
        idx = np.concatenate([i * per + idx.astype(np.int64)
                              for i, (idx, _) in enumerate(outliers)])
        vals = np.concatenate([val.astype(np.int64) for _, val in outliers])
        with span("dec/upload"):
            up = self._upload(np.concatenate([idx, vals]))
        n = idx.size
        shape = (b, hy, wy, self.model.M)
        return tuple(t.reshape(shape) for t in correction_maps(
            up[:n], up[n:].to(torch.int32), b * per))

    @staticmethod
    def _apply_corr(y, corr):
        """(B, M, hy, wy) decoded latents with the corrections applied."""
        if corr is None:
            return y
        mask, vals = (t.permute(0, 3, 1, 2) for t in corr)
        return torch.where(mask != 0, vals, y)

    def _synthesize(self, aux, y2, h, win: int):
        """The reconstructions after the second decode: (x1_hat, x2_hat)
        NCHW float32 from _cond2's aux output (HESIC: the decoded left
        view) and the decoded right latents y2 (B, M, hy, wy) int.  A
        subclass swaps this for its own synthesis."""
        x1_hat_warp, _ = warp_perspective(aux, h, win)
        return aux, self.model.synthesis2(y2.float(), x1_hat_warp)

    def _decode_device(self, z1_sym, z2_sym, h, cen, dead, streams, corr,
                       key) -> dict:
        """cond1 -> kernel 3 -> correction -> cond2 -> kernel 3 ->
        synthesis (_synthesize), dispatched.  streams: per eye (words
        (B, CAP, ls), counts, states) on the device."""
        mm1, mm2, win = key[:3]
        hy, wy = key[4] // 16, key[5] // 16
        (w1, c1, st1), (w2, c2, st2) = streams
        ppl = (hy * wy) // c1.shape[1]
        with span("dec/cond1"):
            freq1 = self._cond1(z1_sym, cen[0], mm1)
        with span("dec/rans"):
            y1 = _decode_stream(freq1, w1, c1, st1, mm1, hy, wy, cen[0],
                                ppl, dead[0])
            y1 = self._apply_corr(y1, corr[0])
        with span("dec/cond2"):
            freq2, aux = self._cond2(y1, z2_sym, h, cen[1], mm2, win)
        with span("dec/rans"):
            y2 = _decode_stream(freq2, w2, c2, st2, mm2, hy, wy, cen[1],
                                ppl, dead[1])
            y2 = self._apply_corr(y2, corr[1])
        with span("dec/synthesis"):
            x1_hat, x2_hat = self._synthesize(aux, y2, h, win)

        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        return {"x1_hat": nhwc(x1_hat), "x2_hat": nhwc(x2_hat),
                "y1_hat": nhwc(y1).float(), "y2_hat": nhwc(y2).float()}

    @staticmethod
    def _read_outliers(blob: bytes, off: int):
        """One pair's outlier records -> ((idx, val) of eye 1, of eye 2,
        the next offset)."""
        i1, v1, off = read_escape_record(blob, off)
        i2, v2, off = read_escape_record(blob, off)
        return (i1, v1), (i2, v2), off

    def _parse_outliers_batch(self, blob: bytes, off: int, b: int):
        """All b pairs' outlier records.  When no pair has outliers the
        records are 2b zero u32 counts, read with one frombuffer (an
        all-zero probe means every count is zero, by induction over the
        records); otherwise the records are walked one by one."""
        probe = np.frombuffer(blob, np.uint32, 2 * b, off)
        if not probe.any():
            empty = (np.zeros(0, np.uint32), np.zeros(0, np.int32))
            return [empty] * b, [empty] * b, off + 8 * b
        out1, out2 = [], []
        for _ in range(b):
            o1, o2, off = self._read_outliers(blob, off)
            out1.append(o1)
            out2.append(o2)
        return out1, out2, off

    def _parse_dead_bitmaps(self, blob: bytes, off: int, b: int):
        """b pairs of constant-channel bitmaps, one unpackbits -> two
        (b, M) bool arrays + the next offset."""
        m = self.model.M
        nbytes = -(-m // 8)
        raw = np.frombuffer(blob, np.uint8, 2 * b * nbytes, off)
        bits = np.unpackbits(raw.reshape(b, 2, nbytes), axis=-1)[..., :m]
        return bits[:, 0] != 0, bits[:, 1] != 0, off + 2 * b * nbytes

    def _parse_pair(self, blob: bytes) -> dict:
        """The layout of one per-pair container, parsed to its last byte
        (nothing decoded yet)."""
        m = self.model.M
        off = _check_format(blob, self.device)
        h_img, w_img = (int(v) for v in
                        np.frombuffer(blob, np.uint16, 2, off + 4))
        key = (blob[off], blob[off + 1], blob[off + 2],
               blob[off + 3] * 16 or None, h_img, w_img)
        ext, off = prefixed_extents(blob, off + 8, 2)
        o1, o2, off = self._read_outliers(blob, off)
        d1, d2, off = self._parse_dead_bitmaps(blob, off, 1)
        cen = np.frombuffer(blob, np.int8, 2 * m, off).reshape(2, m)
        off += 2 * m
        h = np.frombuffer(blob, np.float32, 9, off).reshape(3, 3)
        off += 36
        s1 = unpack_stream_dense(blob, off)
        s2 = unpack_stream_dense(blob, s1[3])
        _check_end(blob, s2[3], "per-pair container")
        _check_shape(h_img, w_img, s1[1].shape[0], "per-pair container")
        return {"key": key, "ext": ext, "outliers": (o1, o2),
                "dead": (d1[0], d2[0]), "centres": cen, "h": h,
                "streams": (s1[:3], s2[:3])}

    def _upload_decode(self, streams, z, cen, dead, h_np):
        """The decoder's inputs on the device, in one pinned upload
        (pack_parts): per eye (exact-dense u16 words in (pair, lane)
        order, (B, ls) counts, (B, ls) u32 states), the z symbols (B, zh,
        zw, C) of both eyes, (2, B, M) centres and constant-channel
        bitmaps, (B, 3, 3) f32 homographies.  The cap-major word buffers
        kernel 3 reads are rebuilt on the device (expand_words).  Returns
        (z1_sym, z2_sym, h, centres, bitmaps, per eye (words, counts,
        states))."""
        b, lanes = streams[0][1].shape
        with span("dec/stage"):
            parts = [streams[0][1], streams[1][1], streams[0][2],
                     streams[1][2], z[0], z[1], cen, dead, h_np,
                     streams[0][0], streams[1][0]]
            packed, sizes = pack_parts(parts)
        with span("dec/upload"):
            buf = self._upload(packed)
        with span("dec/expand-words"):
            (c1, c2, st1, st2, z1d, z2d, cen_d, dead_d, h_d, w1,
             w2) = split_parts(buf, parts, sizes)
            counts = [c.reshape(b, lanes) for c in (c1, c2)]
            states = [s.reshape(b, lanes) for s in (st1, st2)]
            words = [expand_words(w, cd, max(int(c.max()), 1))
                     for w, (_, c, _), cd in zip((w1, w2), streams, counts)]
        z1_sym, z2_sym = (t.reshape(zz.shape).permute(0, 3, 1, 2)
                          .contiguous() for t, zz in zip((z1d, z2d), z))
        m = cen.shape[-1]
        return (z1_sym, z2_sym, h_d.reshape(b, 3, 3),
                cen_d.reshape(2, b, m), (dead_d != 0).reshape(2, b, m),
                list(zip(words, counts, states)))

    def _decode_parsed(self, blob: bytes, p: dict) -> dict:
        """Both decoders' tail after their parse: the z strings at the
        extents p["ext"] of `blob`, the one pinned upload, the correction
        maps and the device half, dispatched.  `p` holds the batch's
        {"key", "ext", "outliers" (per eye, per pair), "dead", "centres"
        (2, B, M), "h" (B, 3, 3), "streams" (per eye)}."""
        key = p["key"]
        y_shape = (key[4] // 16, key[5] // 16)
        z_shape = (y_shape[0] // 4, y_shape[1] // 4)
        with span("dec/z-rans"):
            z = [self.eb_decode_streams(name, blob, ext, z_shape)
                 for name, ext in zip(("entropy_bottleneck1",
                                       "entropy_bottleneck2"), p["ext"])]
        z1_sym, z2_sym, h, cen, dead, streams = self._upload_decode(
            p["streams"], z, p["centres"], p["dead"], p["h"])
        with span("dec/corr-map"):
            corr = tuple(self._corr_map(o, y_shape) for o in p["outliers"])
        return self._decode_device(z1_sym, z2_sym, h, cen, dead, streams,
                                   corr, key)

    @torch.no_grad()
    def decompress_fast(self, blobs) -> dict:
        """Decompress one per-pair container (bytes) or a batch of them
        (list of bytes) that share grid widths, warp windows and image
        size; synchronises before it returns."""
        with call("codec/decompress_fast", self._decodes, self.device):
            self._decodes += 1
            return self._decompress_fast(blobs)

    def _decompress_fast(self, blobs) -> dict:
        """decompress_fast inside its span."""
        start = time.perf_counter()
        if isinstance(blobs, (bytes, bytearray)):
            blobs = [bytes(blobs)]
        with span("dec/parse"):
            parsed = [self._parse_pair(blob) for blob in blobs]
        key = parsed[0]["key"]
        for p in parsed[1:]:
            if p["key"] != key:
                raise ValueError(
                    "per-pair blobs in one decompress_fast call must share "
                    f"(mm1, mm2, win, xwin, H, W): got {key} and "
                    f"{p['key']}")
        with span("dec/stage"):
            # the pairs' z strings decode from their blobs joined
            at = np.cumsum([0] + [len(blob) for blob in blobs])
            joined = b"".join(blobs)
            batch = {
                "key": key,
                "ext": [[(lo + a, hi + a) for (lo, hi), a in zip(
                    (p["ext"][e] for p in parsed), at)] for e in range(2)],
                "outliers": [[p["outliers"][e] for p in parsed]
                             for e in range(2)],
                "dead": np.stack([p["dead"] for p in parsed], 1),
                "centres": np.stack([p["centres"] for p in parsed], 1),
                "h": np.stack([p["h"] for p in parsed]),
                "streams": [
                    (np.concatenate([p["streams"][e][0] for p in parsed]),
                     np.stack([p["streams"][e][1] for p in parsed]),
                     np.stack([p["streams"][e][2] for p in parsed]))
                    for e in range(2)]}
        out = self._decode_parsed(joined, batch)
        with span("dec/wait"):
            if out["x2_hat"].is_cuda:
                torch.cuda.synchronize(out["x2_hat"].device)
        out["dectime"] = time.perf_counter() - start
        return out

    def _decompress_fast_batch(self, blob: bytes, pairs: slice) -> dict:
        """decompress_fast_batch (PipelinedCodec) inside its span: the
        batch container, or only its `pairs` (a slice of the batch, as a
        rank of the split decode takes).  The z strings decode in two
        native calls; counts, states, words, z symbols, centres, bitmaps
        and homographies go up in one pinned upload; the cap-major word
        buffers are rebuilt on the device."""
        start = time.perf_counter()
        m = self.model.M
        with span("dec/parse"):
            off = _check_format(blob, self.device)
            key = (blob[off], blob[off + 1], blob[off + 2],
                   blob[off + 3] * 16 or None)
            h_img, w_img, b, lanes = (int(v) for v in np.frombuffer(
                blob, np.uint32, 4, off + 4))
            off += 20
            if not 0 < b <= (len(blob) - off) // 8:
                raise ValueError(f"batch container: {b} pairs cannot fit "
                                 f"{len(blob)} bytes")
            ext, off = prefixed_extents(blob, off, 2 * b)
        with span("dec/outliers-parse"):
            out1, out2, off = self._parse_outliers_batch(blob, off, b)
        with span("dec/parse"):
            dead1, dead2, off = self._parse_dead_bitmaps(blob, off, b)
            cen = np.frombuffer(blob, np.int8, 2 * b * m, off)
            off += 2 * b * m
            h_np = np.frombuffer(blob, np.float32, 9 * b, off)
            off += 36 * b
            streams = []
            for _ in range(2):
                c, off = unpack_counts(blob, off, b * lanes)
                st = np.frombuffer(blob, np.uint32, b * lanes, off)
                off += 4 * b * lanes
                total = int(c.sum())
                flat = np.frombuffer(blob, np.uint16, total, off)
                off += 2 * total
                streams.append((flat, c.reshape(b, lanes),
                                st.reshape(b, lanes)))
            _check_end(blob, off, "batch container")
            _check_shape(h_img, w_img, lanes, "batch container")
            p = {"key": key + (h_img, w_img), "ext": [ext[0::2], ext[1::2]],
                 "outliers": [out1, out2],
                 "dead": np.stack([dead1, dead2]),
                 "centres": cen.reshape(2, b, m),
                 "h": h_np.reshape(b, 3, 3), "streams": streams}
            if pairs is not None:
                lo, hi, stride = pairs.indices(b)
                if stride != 1 or hi <= lo:
                    raise ValueError(f"pairs must be a non-empty contiguous "
                                     f"slice of the {b} pairs")
                sel = []
                for flat, c, st in streams:
                    ends = np.concatenate([[0], np.cumsum(c.sum(axis=1))])
                    sel.append((flat[ends[lo]:ends[hi]], c[lo:hi],
                                st[lo:hi]))
                p.update(ext=[e[lo:hi] for e in p["ext"]],
                         outliers=[o[lo:hi] for o in p["outliers"]],
                         dead=p["dead"][:, lo:hi],
                         centres=p["centres"][:, lo:hi],
                         h=p["h"][lo:hi], streams=sel)
        out = self._decode_parsed(blob, p)
        out["dectime"] = time.perf_counter() - start
        return out
