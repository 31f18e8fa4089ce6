"""HESIC fast codec: compress_fast -> decompress_fast on the card.

Counterpart of hesic_tpu/models/hesic_fast.py (``HESICFastCodec``), with
the per-pair container of format v3 (byte for byte its layout after a
writer byte of the port's own) and the same public layouts: images (B, H, W, 3) float32, homographies
(B, 3, 3), latents out as (B, hy, wy, M).

Pipeline.  Encode: transforms (analysis, hyper-analysis, z symbols, warp
of x1, data-derived grid centres and spreads) -> ``cond1`` (z1 -> GMM
heads -> frequency rows, kernel 1) -> grid rANS encode of y1 (kernel 2)
-> ``cond2`` (synthesis1 -> warp -> re-encode of the decoded left view ->
GMM heads -> frequency rows, kernel 1) -> grid rANS encode of y2 -> z
strings on the host rANS coder -> containers.  Decode mirrors it with the
grid rANS decode (kernel 3), the outlier correction before ``cond2``, and
the right-eye synthesis.

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
keep the v3 layout.

Format notes (as the JAX package): y symbols are coded on a per-channel
grid [c_m - mm, c_m + mm] around the data-derived centre c_m (i8 in the
container), mm picked per eye from MM_BUCKETS by the residual spread;
latents beyond the grid travel exactly as (index, value) corrections;
constant channels are flagged in a bitmap and coded with degenerate rows;
each rANS lane codes ``ppl`` positions; z streams use the host coder.

Not carried over from the JAX codec: the TPU link transport (packed link
vectors, z nibble packing, sticky shapes, decoder size watermarks), the
batch container and the pipelined encode.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codecs.device_rans import pack_stream_dense, unpack_stream
from ..codecs.grid_rans import (default_cap, rans_decode_grid_rows,
                                rans_encode_grid_rows)
from ..codecs.pmf import gmm_freq
from ..geometry import pick_warp_win, pick_warp_xwin, warp_perspective
from .base import CompressionModel, deterministic_backends

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


class HESICFastCodec(CompressionModel):
    """HESIC with the fused on-device coder: ``compress_fast`` /
    ``decompress_fast`` over per-pair v3 containers."""

    def __init__(self, model, mm: int = MM_DEFAULT, codec_batch: int = 8):
        super().__init__(model)
        deterministic_backends()
        self.mm = mm
        self.codec_batch = codec_batch

    # ---- shared conditioning programs (identical on both sides) ----

    def _cond1_fn(self, z1_sym, center, mm: int):
        z1_hat = z1_sym.float() + self._median("entropy_bottleneck1")
        sigma, means, weights = self.model.gmm1(z1_hat)
        return _gmm_freq_fast(sigma, means, weights, mm, self.model.K,
                              center)

    def _cond2_fn(self, y1_hat, z2_sym, h, center, mm: int, win: int):
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
        last item repeated)."""
        b = args[0].shape[0]
        b0 = self.codec_batch
        outs = []
        for lo in range(0, b, b0):
            hi = min(lo + b0, b)
            chunk = [a[lo:hi] for a in args]
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
        pair, local = torch.nonzero(torch.abs(y - cen) > mm, as_tuple=True)
        vals = y[pair, local]
        pair, local, vals = (t.cpu().numpy() for t in (pair, local, vals))
        if pair.size != total:
            raise RuntimeError(
                f"outlier collection found {pair.size} latents beyond the "
                f"grid but the stream counted {total}")
        return [(local[pair == i].astype(np.uint32),
                 vals[pair == i].astype(np.int32)) for i in range(b)]

    @staticmethod
    def _pack_outliers(o1, o2) -> bytes:
        out = bytearray()
        for idx, val in (o1, o2):
            out += np.array([idx.size], np.uint32).tobytes()
            out += idx.astype(np.uint32).tobytes()
            out += val.astype(np.int32).tobytes()
        return bytes(out)

    @staticmethod
    def _parse_outliers(blob: bytes, off: int):
        eyes = []
        for _ in range(2):
            (n,) = np.frombuffer(blob, np.uint32, 1, off)
            off += 4
            idx = np.frombuffer(blob, np.uint32, int(n), off)
            off += 4 * int(n)
            val = np.frombuffer(blob, np.int32, int(n), off)
            off += 4 * int(n)
            eyes.append((idx, val))
        return eyes[0], eyes[1], off

    @staticmethod
    def _stream_host(words, counts, states):
        """Device stream -> per-pair (exact-dense u16 payload, counts,
        u32 states) on the host, each lane's words in lane order."""
        c = counts.cpu().numpy()
        cmax = max(int(c.max()), 1)
        w = words[:, :cmax].permute(0, 2, 1).cpu().numpy()  # (B, ls, C)
        keep = np.arange(cmax)[None, None, :] < c[:, :, None]
        st = states.cpu().numpy().astype(np.uint32)
        return [(w[i][keep[i]], c[i], st[i]) for i in range(c.shape[0])]

    @torch.no_grad()
    def compress_fast(self, x1, x2, h_matrix) -> dict:
        """Compress a batch of pairs.  x1/x2: (B, H, W, 3); h: (B, 3, 3) or
        (1, 3, 3).  Returns {'blobs': per-pair bytes, 'blob', 'bpp_real',
        'enctime', 'outliers': (eye1, eye2) latent counts beyond the
        grids}."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        b, _, h_img, w_img = x1.shape
        h, h_np = self._homographies(h_matrix, b)
        win = pick_warp_win(h_np, h_img, w_img)
        xw = pick_warp_xwin(h_np, h_img, w_img)

        (y1_hat, y2_hat, z1_sym, z2_sym, dc1, dc2, sp1,
         sp2) = self.transforms_enc(x1, x2, h, win)
        mm1 = pick_mm(int(sp1), self.mm)
        mm2 = pick_mm(int(sp2), self.mm)
        freq1 = self._cond1(z1_sym, dc1, mm1)
        freq2, _ = self._cond2(y1_hat, z2_sym, h, dc2, mm2, win)

        hy, wy = y1_hat.shape[2], y1_hat.shape[3]
        ppl = auto_ppl(hy * wy)
        # one launch per eye at the guaranteed bound (one word per
        # micro-step + 2), so no lane can overflow it
        cap = default_cap(self.model.M, ppl)
        s1 = _encode_stream(freq1, y1_hat, mm1, dc1, ppl, cap)
        s2 = _encode_stream(freq2, y2_hat, mm2, dc2, ppl, cap)
        cmax = int(torch.maximum(s1[1].amax(), s2[1].amax()))
        if cmax > cap:
            raise RuntimeError(f"grid encoder counted {cmax} words in a "
                               f"lane, past its bound {cap}")
        over = torch.stack([s1[3], s2[3]]).cpu().numpy()
        dead = torch.stack([s1[4], s2[4]]).cpu().numpy()
        outliers1 = self._collect_outliers(y1_hat, over[0], dc1, mm1)
        outliers2 = self._collect_outliers(y2_hat, over[1], dc2, mm2)
        streams1 = self._stream_host(*s1[:3])
        streams2 = self._stream_host(*s2[:3])
        z1_np = z1_sym.permute(0, 2, 3, 1).cpu().numpy()
        z2_np = z2_sym.permute(0, 2, 3, 1).cpu().numpy()
        z1_strs = self.eb_encode_symbols("entropy_bottleneck1", z1_np)
        z2_strs = self.eb_encode_symbols("entropy_bottleneck2", z2_np)
        dc1_np, dc2_np = dc1.cpu().numpy(), dc2.cpu().numpy()

        blobs = []
        for i in range(b):
            header = bytearray()
            header += bytes([writer_id(self.device), mm1, mm2, win,
                             0 if xw is None else xw // 16])
            header += np.array([h_img, w_img], np.uint16).tobytes()
            for s in (z1_strs[i], z2_strs[i]):
                header += np.array([len(s)], np.uint32).tobytes() + s
            header += self._pack_outliers(outliers1[i], outliers2[i])
            header += np.packbits(dead[0, i]).tobytes()
            header += np.packbits(dead[1, i]).tobytes()
            header += dc1_np[i].astype(np.int8).tobytes()
            header += dc2_np[i].astype(np.int8).tobytes()
            header += h_np[i].reshape(-1).astype(np.float32).tobytes()
            body = (pack_stream_dense(*streams1[i])
                    + pack_stream_dense(*streams2[i]))
            blobs.append(bytes(header) + body)
        total = sum(len(bl) for bl in blobs)
        return {
            "blobs": blobs,
            "blob": blobs[0],
            "bpp_real": total * 8 / (2 * h_img * w_img * b),
            "enctime": time.perf_counter() - start,
            "outliers": (int(over[0].sum()), int(over[1].sum())),
        }

    # ---- decoder side ----

    def _corr_map(self, outliers, y_shape):
        """Dense (mask, true value) (B, hy, wy, M) maps on the device, or
        None when no pair has outliers.  Set semantics: the decoder
        overwrites the clamped decode with the stored true value."""
        if all(idx.size == 0 for idx, _ in outliers):
            return None
        b = len(outliers)
        hy, wy = y_shape
        m = self.model.M
        mask = np.zeros((b, hy * wy * m), bool)
        vals = np.zeros((b, hy * wy * m), np.int32)
        for i, (idx, val) in enumerate(outliers):
            mask[i, idx] = True
            vals[i, idx] = val
        return (torch.from_numpy(mask.reshape(b, hy, wy, m)).to(self.device),
                torch.from_numpy(vals.reshape(b, hy, wy, m)).to(self.device))

    @staticmethod
    def _apply_corr(y, corr):
        """(B, M, hy, wy) decoded latents with the corrections applied."""
        if corr is None:
            return y
        mask, vals = (t.permute(0, 3, 1, 2) for t in corr)
        return torch.where(mask, vals, y)

    @torch.no_grad()
    def decompress_fast(self, blobs) -> dict:
        """Decompress one blob (bytes) or a batch (list of bytes) that
        share grid widths, warp windows and image size."""
        start = time.perf_counter()
        if isinstance(blobs, (bytes, bytearray)):
            blobs = [bytes(blobs)]
        m = self.model.M
        nbytes = -(-m // 8)
        key = None
        z1_l, z2_l, h_l, o1_l, o2_l = [], [], [], [], []
        d1_l, d2_l, c1_l, c2_l, s1_l, s2_l = [], [], [], [], [], []
        for blob in blobs:
            off = _check_format(blob, self.device)
            h_img, w_img = (int(v) for v in
                            np.frombuffer(blob, np.uint16, 2, off + 4))
            blob_key = (blob[off], blob[off + 1], blob[off + 2],
                        blob[off + 3] * 16 or None, h_img, w_img)
            if key is not None and blob_key != key:
                raise ValueError(
                    "per-pair blobs in one decompress_fast call must share "
                    f"(mm1, mm2, win, xwin, H, W): got {key} and {blob_key}")
            key = blob_key
            off += 8
            y_shape = (h_img // 16, w_img // 16)
            z_shape = (y_shape[0] // 4, y_shape[1] // 4)
            for name, acc in (("entropy_bottleneck1", z1_l),
                              ("entropy_bottleneck2", z2_l)):
                (length,) = np.frombuffer(blob, np.uint32, 1, off)
                off += 4
                acc.append(self.eb_decode_streams(
                    name, blob, [(off, off + int(length))], z_shape)[0])
                off += int(length)
            o1, o2, off = self._parse_outliers(blob, off)
            o1_l.append(o1)
            o2_l.append(o2)
            bits = np.unpackbits(np.frombuffer(blob, np.uint8, 2 * nbytes,
                                               off).reshape(2, nbytes),
                                 axis=-1)[:, :m]
            d1_l.append(bits[0])
            d2_l.append(bits[1])
            off += 2 * nbytes
            c1_l.append(np.frombuffer(blob, np.int8, m, off))
            c2_l.append(np.frombuffer(blob, np.int8, m, off + m))
            off += 2 * m
            h_l.append(np.frombuffer(blob, np.float32, 9, off).reshape(3, 3))
            off += 36
            w1, cn1, st1, off = unpack_stream(blob, off)
            w2, cn2, st2, off = unpack_stream(blob, off)
            s1_l.append((w1, cn1, st1))
            s2_l.append((w2, cn2, st2))
        mm1, mm2, win = key[:3]
        dev = self.device

        def tensor(arrays, dtype):
            return torch.from_numpy(np.stack(arrays).astype(dtype)).to(dev)

        def stack_streams(parts):
            # cap-major (B, CAP, lanes), the layout kernel 3 reads
            cap = max(p[0].shape[1] for p in parts)
            words = np.zeros((len(parts), cap, parts[0][0].shape[0]),
                             np.int32)
            for i, (w, _, _) in enumerate(parts):
                words[i, : w.shape[1], :] = w.T
            return (torch.from_numpy(words).to(dev),
                    tensor([p[1] for p in parts], np.int32),
                    tensor([p[2] for p in parts], np.int64))

        w1d, c1d, st1d = stack_streams(s1_l)
        w2d, c2d, st2d = stack_streams(s2_l)
        z1_sym = tensor(z1_l, np.int32).permute(0, 3, 1, 2).contiguous()
        z2_sym = tensor(z2_l, np.int32).permute(0, 3, 1, 2).contiguous()
        h = tensor(h_l, np.float32)
        dead1, dead2 = tensor(d1_l, bool), tensor(d2_l, bool)
        cen1, cen2 = tensor(c1_l, np.int32), tensor(c2_l, np.int32)
        corr1 = self._corr_map(o1_l, y_shape)
        corr2 = self._corr_map(o2_l, y_shape)
        hy, wy = y_shape
        ppl = (hy * wy) // c1d.shape[1]

        freq1 = self._cond1(z1_sym, cen1, mm1)
        y1 = _decode_stream(freq1, w1d, c1d, st1d, mm1, hy, wy, cen1, ppl,
                            dead1)
        y1 = self._apply_corr(y1, corr1)
        freq2, x1_hat = self._cond2(y1, z2_sym, h, cen2, mm2, win)
        y2 = _decode_stream(freq2, w2d, c2d, st2d, mm2, hy, wy, cen2, ppl,
                            dead2)
        y2 = self._apply_corr(y2, corr2)
        x1_hat_warp, _ = warp_perspective(x1_hat, h, win)
        x2_hat = self.model.synthesis2(y2.float(), x1_hat_warp)

        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        out = {
            "x1_hat": nhwc(x1_hat),
            "x2_hat": nhwc(x2_hat),
            "y1_hat": nhwc(y1).float(),
            "y2_hat": nhwc(y2).float(),
        }
        if out["x2_hat"].is_cuda:
            torch.cuda.synchronize(out["x2_hat"].device)
        out["dectime"] = time.perf_counter() - start
        return out
