"""The wavefront autoregressive device codecs: mbt2018's and HESIC+'s.

Counterpart of hesic_tpu/models/ar_device.py: the integer bookkeeping of
the wavefront schedule (``TAPS``, ``schedule``, ``wavefront_valid_mask``),
the container's backend byte, the coder's ``PROB_BITS``,
``wavefront_encode``/``wavefront_decode`` (one eye's level scan and its
stream, outside a codec), ``JointAutoregressiveDeviceCodec`` (mbt2018)
and ``HESICPlusDeviceCodec`` with its FLOP count (``device_flops``).

The raster recursion runs as a wavefront over levels s = 3i + j: every
mask-A tap of the 5x5 context kernel lands at a strictly smaller level
(worst tap (di=-1, dj=+2) -> s-1), so all pixels of a level, of every
image of the batch, decode in parallel.  The level scan is kernel 5
(models/wavefront.py); its teacher pass emits one rANS interval per
(slot, lane), which kernel 4 (codecs/pairs_rans.py) encodes in one launch
per level scan.  Residual symbols round(y - means) are coded on the grid
[-mm, mm]; residuals beyond it ride an exact escape side-channel that the
decode scan applies in place (the recursion needs the corrected value at
once).  The two codecs share ``_WavefrontCodec``: the grid, the z
symbols, the level scan's validity mask, the escape gather, the header
and the decoder's one pinned upload (the word buffers and escape maps
rebuilt on the device); the container's pieces are models/base.py's.

Bit-exactness invariant: encoder and decoder run the same chain (each
codec's ``_chain``: hyper-synthesis -> level scan, and for HESIC+ then
synthesis -> warp -> re-encode of the decoded left view ->
hyper-synthesis -> level scan of eye 2) at the same batch, with the
codec's determinism policy (deterministic cuDNN, no TF32); the level
scan's parameters come from a fixed-order kernel that encode and decode
both launch.  Only integers cross between the directions.

HESIC+'s fast protocol (the fast codecs' serving path: models/base.py's
``PipelinedCodec``, which HESIC's and DSIC's codec share; this codec
gives its hooks): ``compress_fast`` (one batch container,
synchronously), ``compress_fast_start`` (dispatch only: the transforms,
both eyes' teacher chains, kernel 4 once per eye, the escapes gathered
into a fixed-capacity slab (ESCAPE_CAP a eye) with a device count,
and the copies of what the container needs, into pinned buffers on a
side stream), ``compress_fast_finish`` (waits on that handle's copies
only, copies each eye's counted words on a second side stream, codes
the z strings, packs the container) and ``decompress_fast_batch``
(parse, z strings, one pinned upload, the word buffers and escape maps
rebuilt on the device, both decode chains and the output synthesis,
dispatched; the caller synchronises).  Nothing on the two dispatch paths
waits for the device.  An eye with more escapes than the slab holds
takes a synchronous gather in the finish, on the finish stream (counted
as ``count/escape_fallbacks``).  ``compress`` is a start and its finish,
``decompress`` a ``decompress_fast_batch`` and a synchronise: the
container is packed (``_finish``) and parsed (``_parse``) in one place.

Tracing (utils/tracing.py; entered only while a profiler records).  The
fast protocol's public calls are spans ``codec/compress_fast``,
``codec/compress_fast_start``, ``codec/compress_fast_finish`` and
``codec/decompress_fast_batch``, each holding ``count/batch`` and
``count/device_allocs``.  Inside them: ``enc/transforms``,
``enc/scan1``, ``enc/reencode``, ``enc/scan2`` (the chain: eye 1's
hyper-synthesis and level scan; the decoded left view's synthesis, warp
and re-encode; eye 2's), ``enc/pairs-rans``, ``enc/fetch``,
``enc/wait-counts``, ``enc/words-d2h``, ``enc/wait-words``,
``enc/escapes``, ``enc/z-rans``, ``enc/pack``; ``dec/parse``,
``dec/z-rans``, ``dec/upload``, ``dec/expand``, ``dec/scan1``,
``dec/reencode``, ``dec/scan2``, ``dec/synthesis``.  A ``wait`` stage
is the host blocked on the device.  Counters: ``count/h2d_bytes``
(``_upload``), ``count/d2h_bytes`` (the start's copies, the finish's
words: PipelinedCodec's ``_fetch`` and ``_fetch_words``),
``count/latents`` and ``count/escapes`` (each finish),
``count/escape_fallbacks`` (each finish: its eyes that overflowed the
slab), ``count/scan_levels`` (each level scan: the levels it
launched) and, inside each scan on the card,
``count/wavefront_level_launches`` (``models/wavefront.py``: the levels
the pass launched through ``wavefront_level_kernel``, counted once the
launches were accepted).  ``compress`` and ``decompress`` run the same
chain, so its spans show there too.

Not carried over from the JAX codec: the TPU link devices
(``DENSE_LINK_THRESHOLD``, ``compact_stream``, ``upload_words_auto``,
``pow2_bucket``: words cross with ``.cpu()``) and the ``HESIC_NO_PALLAS``
switch (the tensor's device selects the backend).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codecs.device_rans import (PROB_BITS, pack_stream, pack_stream_dense,
                                  unpack_stream_dense)
from ..geometry import warp_perspective
from ..utils.tracing import count, span
from .autoregressive import extract_ar_weights
from .base import (CompressionModel, PipelinedCodec, correction_maps,
                   counted_flops, deterministic_backends, escape_record,
                   expand_lanes, length_prefixed, pack_parts,
                   prefixed_extents, read_escape_record, split_parts, u16)

# mask-A taps of the 5x5 context kernel: two rows above (all columns)
# plus the two left neighbours in the centre row
TAPS = [(di - 2, dj - 2) for di in range(2) for dj in range(5)] \
    + [(0, -2), (0, -1)]

# the left prior's warp: warp_perspective_mxu's defaults in the JAX codec
WARP_WIN = 64

# escapes a eye that the fast protocol's start gathers without waiting for
# the device; an eye with more takes the finish's synchronous gather
ESCAPE_CAP = 1024

# Stream-format byte.  The JAX package's backends are 0 (lax.scan, XLA
# erfc) and 2 (Pallas level scan); the port's differ from both and from
# each other (other product orders), so they take ids of their own: 3 the
# plain twin, 5 the CUDA kernel's cluster level scan.  4 was the CUDA
# kernel's earlier stage design, whose sums ran in another order: its
# containers are refused by name.
BACKEND_NAMES = {0: "xla-scan", 2: "pallas-level-scan",
                 3: "torch-plain-level-scan", 4: "cuda-level-scan",
                 5: "cuda-level-scan-cluster"}


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _levels(pre: torch.Tensor) -> int:
    """The levels of a level scan over NHWC `pre`'s (hy, wy) latents."""
    return 3 * (pre.shape[1] - 1) + pre.shape[2]


def _compact_lanes(words, counts, total: int) -> torch.Tensor:
    """Kernel 4's (L, cap) word buffer and its (L,) counts -> the `total`
    = sum(counts) counted words, lane-major (each lane's first `count`
    words, in emission order): the container's packed payload, as int16
    u16 bit patterns.  A gather where the words are, sized on the host."""
    c = counts.to(torch.int64)
    ends = torch.cumsum(c, 0)
    k = torch.arange(total, device=words.device)
    lane = torch.searchsorted(ends, k, right=True)
    return u16(words[lane, k - (ends - c)[lane]])


def schedule(hy: int, wy: int):
    """Per-level (i_min, count) for s = 3i + j, plus max pixels/level."""
    n_levels = 3 * (hy - 1) + (wy - 1) + 1
    i_min = np.zeros(n_levels, np.int32)
    count = np.zeros(n_levels, np.int32)
    for s in range(n_levels):
        lo = max(0, -(-(s - (wy - 1)) // 3))   # ceil((s - wy + 1) / 3)
        hi = min(hy - 1, s // 3)
        i_min[s] = lo
        count[s] = max(0, hi - lo + 1)
    return n_levels, i_min, count, int(count.max())


def wavefront_valid_mask(hy: int, wy: int, b: int, groups: int, m: int,
                         device="cpu") -> torch.Tensor:
    """(T_slots, L) bool validity grid matching the level scan's lane
    layout."""
    n_levels, _, count, p_max = schedule(hy, wy)
    mg = m // groups
    valid_p = np.arange(p_max)[None, :] < count[:, None]   # (T_lv, Pmax)
    v = np.broadcast_to(valid_p[:, None, None, :, None],
                        (n_levels, groups, b, p_max, mg))
    return torch.from_numpy(np.ascontiguousarray(v).reshape(
        n_levels * groups, b * p_max * mg)).to(device)


def wavefront_backend_id(device) -> int:
    """The backend byte for level scans on `device`: 5 = the CUDA kernel,
    3 = the plain twin (CPU)."""
    return 5 if torch.device(device).type == "cuda" else 3


def check_wavefront_backend(blob: bytes, device) -> int:
    """Raise unless `blob` was encoded by the backend `device` runs;
    returns the header bytes consumed (1)."""
    tag, cur = blob[0], wavefront_backend_id(device)
    if tag != cur:
        raise ValueError(
            f"wavefront container encoded with the "
            f"{BACKEND_NAMES.get(tag, f'unknown({tag})')} backend but this "
            f"codec runs {BACKEND_NAMES[cur]}; decode on the matching "
            f"backend")
    return 1


def wavefront_encode(weights, y, pre, post=None, mm: int = 16,
                     groups: int = 8):
    """One eye's teacher pass (kernel 5) and the reverse rANS encode of its
    intervals (kernel 4), as the JAX package's function, in the port's
    layout.

    weights: the eye's ArWeights or PackedArWeights (what a codec keeps);
    y (B, hy, wy, M) float32 latents, pre (B, hy, wy, P) and post (B, hy,
    wy, Q) or None float32, NHWC, on one device.  Returns (words (L, T+2)
    int32 [u16 values in emission order, zero past each lane's count],
    counts (L,) int32, states (L,) int64 [u32 values], y_hat (B, hy, wy,
    M) float32, resid (B, hy, wy, M) int32, the escape count as an int),
    T = the scan's slots, L its lanes: the JAX package's word buffer
    (its lax.scan coder's), on the device of `pre`.  The escape count
    reads the device (one host sync)."""
    from ..codecs.pairs_rans import rans_encode_pairs
    from .wavefront import ar_wavefront
    b, hy, wy, m = y.shape
    starts, freqs, y_hat, resid = ar_wavefront(
        weights, pre, post, y, None, None, None, None, None, True, mm,
        groups)
    valid = wavefront_valid_mask(hy, wy, b, groups, m, pre.device)
    cap = starts.shape[0] + 2
    words, counts, states = rans_encode_pairs(starts, freqs, valid, cap)
    keep = torch.arange(cap, device=pre.device)[None, :] < counts[:, None]
    return (torch.where(keep, words, 0), counts, states, y_hat, resid,
            int((resid.abs() > mm).sum()))


def wavefront_decode(weights, pre, words, counts, states, post=None,
                     corr_mask=None, corr_val=None, mm: int = 16,
                     groups: int = 8, m: int = None):
    """One eye's decode pass (kernel 5) of wavefront_encode's stream, as
    the JAX package's function, in the port's layout: pre (B, hy, wy, P)
    and post (B, hy, wy, Q) or None float32 NHWC; words (L, C) u16
    values, counts (L,), states (L,) u32 values; corr_mask/corr_val (B,
    hy, wy, M) int32 escape corrections or None.  `m` is the JAX
    signature's latent width; the scan reads M from the weights, and
    another `m` raises.  Returns y_hat (B, hy, wy, M) float32."""
    from .wavefront import ar_wavefront, raw_weights
    width = raw_weights(weights).ctx_kernel.shape[2]
    if m is not None and m != width:
        raise ValueError(f"m={m}, but the weights code M={width} channels")
    return ar_wavefront(
        weights, pre, post, None, corr_mask, corr_val,
        words.to(torch.int32), counts.to(torch.int32),
        states.to(torch.int64), False, mm, groups)[2]


class _WavefrontCodec(CompressionModel):
    """What the two wavefront codecs share: the determinism policy, the
    grid (``mm``) and channel groups, z symbols, the level scan's validity
    mask, the synchronous escape gather, the header, and the decoder's
    one pinned upload with the word buffers and escape maps rebuilt on
    the device."""

    def __init__(self, model, mm: int, groups: int):
        super().__init__(model)
        deterministic_backends()
        self.mm, self.groups = mm, groups
        self._valid_masks = {}

    def _check_size(self, x):
        b, _, h_img, w_img = x.shape
        if h_img % 64 or w_img % 64:
            raise ValueError("input dims must be multiples of 64 (pad like "
                             "eval_model does); got "
                             f"{(b, h_img, w_img, 3)}")
        return b, h_img, w_img

    def _z_symbols(self, z, name: str) -> torch.Tensor:
        return torch.round(z - self._median(name)).to(torch.int32)

    def _z_hat(self, z_sym, name: str) -> torch.Tensor:
        # canonical strides: a conv's result can depend on its input's
        # strides (even of size-1 dims), and the decoder's z symbols
        # arrive with other strides than the encoder's
        z = z_sym.to(torch.float32, memory_format=torch.contiguous_format)
        return z + self._median(name)

    def _valid(self, b: int, h_img: int, w_img: int) -> torch.Tensor:
        """The level scan's (slot, lane) validity for a batch of `b`
        images of h_img x w_img, made once a shape (uploaded through
        ``_upload``: it does not wait for the device)."""
        key = (b, h_img, w_img)
        if key not in self._valid_masks:
            self._valid_masks[key] = self._upload(wavefront_valid_mask(
                h_img // 16, w_img // 16, b, self.groups, self.latent_ch
            ).numpy())
        return self._valid_masks[key]

    def _gather_escapes(self, resid: torch.Tensor):
        """Residuals beyond the grid -> (flat NHWC indices, values) as
        numpy arrays; waits for the device."""
        flat = resid.reshape(-1)
        idx = torch.nonzero(torch.abs(flat) > self.mm)[:, 0]
        return idx.cpu().numpy(), flat[idx].cpu().numpy()

    def _upload_decode(self, z, h_np, streams, escapes, shape):
        """The decoder's inputs on the device, in one pinned upload
        (pack_parts): each bottleneck's (B, zh, zw, C) z symbols, the
        (B x 9,) f32 homographies (or None), per eye its packed stream
        (lane-major u16 words, counts, u32 states) and its escapes (flat
        NHWC indices, values).  Returns (the z symbols (B, C, zh, zw) per
        bottleneck, h (B, 3, 3) or None, per eye (words (L, cap), counts,
        states) with the word buffer rebuilt on the device, per eye the
        escape (mask, value) maps of `shape`, or None without escapes)."""
        with span("dec/upload"):
            parts = list(z) + ([] if h_np is None else [h_np])
            for flat, counts, states in streams:
                parts += [counts, states, flat]
            for idx, vals in escapes:
                parts += [idx, vals]
            packed, sizes = pack_parts(parts)
            buf = self._upload(packed)
        with span("dec/expand"):
            got = iter(split_parts(buf, parts, sizes))
            z_sym = [next(got).reshape(zz.shape).permute(0, 3, 1, 2)
                     for zz in z]
            h = None if h_np is None else next(got).reshape(-1, 3, 3)
            dev = []
            for _, counts, _ in streams:
                c, st, w = next(got), next(got), next(got)
                dev.append((expand_lanes(w, c, max(int(counts.max()), 1)),
                            c, st))
            corr = []
            for idx, _ in escapes:
                at, vals = next(got), next(got)
                corr.append(None if idx.size == 0 else tuple(
                    t.reshape(shape) for t in correction_maps(
                        at, vals, int(np.prod(shape)))))
        return z_sym, h, dev, corr

    def _header(self, b: int, h_img: int, w_img: int, zh: int,
                zw: int) -> bytes:
        """The backend byte and the 5 x u32 header (B, H, W, zh, zw)."""
        return bytes([wavefront_backend_id(self.device)]) + np.array(
            [b, h_img, w_img, zh, zw], np.uint32).tobytes()

    def _parse_header(self, blob: bytes):
        off = check_wavefront_backend(blob, self.device)
        b, h_img, w_img, zh, zw = (int(v) for v in
                                   np.frombuffer(blob, np.uint32, 5, off))
        return (b, h_img, w_img, zh, zw), off + 20


class JointAutoregressiveDeviceCodec(_WavefrontCodec):
    """Wavefront device codec for mbt2018
    (models/priors.py ``JointAutoregressiveHierarchicalPriors``) and
    Cheng2020 (models/waseda.py), whose y has N channels: the level scan
    without a cross-eye input.  One blob codes the whole batch
    of images.  Images are (B, H, W, 3) float32 with H, W multiples of
    64; latents come out as (B, hy, wy, M) float32.

    Container: backend byte (5 card, 3 CPU twin) | 5 x u32 (B, H, W, zh,
    zw) | escapes (u32 n | u32 flat NHWC index[n] | i32 value[n]) | B z
    strings (u32 length | bytes) | the packed stream."""

    def __init__(self, model, mm: int = 16, groups: int = 8):
        super().__init__(model, mm, groups)
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        from .wavefront import pack_weights
        self.w = pack_weights(extract_ar_weights(self.model))
        # y's channels: M for mbt2018, N for Cheng2020
        self.latent_ch = self.w.raw.ctx_kernel.shape[2]

    @torch.no_grad()
    def _chain(self, z_sym, y, stream, corr, teacher: bool):
        """The coding chain, shared by encode (teacher, y the NHWC
        latents) and decode (stream the (words, counts, states), corr the
        escape (mask, value) maps or None): hyper-synthesis, then the
        level scan.  Returns the scan's (starts, freqs, y_hat, resid)."""
        from .wavefront import ar_wavefront
        pre = _nhwc(self.model.hyper_synthesis(
            self._z_hat(z_sym, "entropy_bottleneck")))
        return ar_wavefront(self.w, pre, None, y, *(corr or (None, None)),
                            *(stream or (None, None, None)), teacher,
                            self.mm, self.groups)

    @torch.no_grad()
    def compress(self, x) -> dict:
        """Compress a batch of images into one blob.  Returns {'strings':
        [blob], 'shape': (zh, zw), 'y_hat' (B, hy, wy, M), 'bpp_real'
        (bytes x 8 over B*H*W), 'enctime', 'escapes'}."""
        start = time.perf_counter()
        x = self._to_device(x)
        b, h_img, w_img = self._check_size(x)
        m = self.model
        y = m.analysis(x)
        z_sym = self._z_symbols(m.hyper_analysis(y), "entropy_bottleneck")
        st, fr, y_hat, resid = self._chain(z_sym, _nhwc(y), None, None,
                                           teacher=True)
        stream = self._encode_level_scan(st, fr,
                                         self._valid(b, h_img, w_img))
        idx, vals = self._gather_escapes(resid)
        z_strs = self.eb_encode_symbols(
            "entropy_bottleneck", z_sym.permute(0, 2, 3, 1).cpu().numpy())
        blob = (self._header(b, h_img, w_img, *z_sym.shape[2:])
                + escape_record(idx, vals) + length_prefixed(z_strs)
                + stream)
        return {"strings": [blob], "shape": tuple(z_sym.shape[2:]),
                "y_hat": y_hat, "bpp_real": len(blob) * 8 / (b * h_img
                                                             * w_img),
                "enctime": time.perf_counter() - start,
                "escapes": int(idx.size)}

    def _encode_level_scan(self, starts, freqs, valid) -> bytes:
        """Pairs-encode one level scan's slot stream in one launch and
        pack it for the container.  A valid slot emits at most one word
        (below 2^32 before the renorm, the state is below 2^16 <= f * 2^16
        after one shift), so no lane's count can pass T, the cap of that
        launch."""
        from ..codecs.pairs_rans import rans_encode_pairs
        cap = starts.shape[0]
        words, counts, states = rans_encode_pairs(starts, freqs, valid, cap)
        c = counts.cpu().numpy()
        cmax = max(int(c.max()), 1)
        if cmax > cap:
            raise RuntimeError(f"pairs encoder counted {cmax} words in a "
                               f"lane of {cap} slots")
        return pack_stream(words[:, :cmax].cpu().numpy(), c,
                           states.cpu().numpy().astype(np.uint32))

    @torch.no_grad()
    def decompress(self, strings, shape=None) -> dict:
        """Inverse of compress: {'x_hat' (B, H, W, 3) clipped to [0, 1],
        'y_hat' (B, hy, wy, M), 'dectime'}.  `shape` is the host codecs'
        argument, taken and not used (the blob's header has the sizes)."""
        start = time.perf_counter()
        blob = strings[0] if isinstance(strings, (list, tuple)) else strings
        (b, h_img, w_img, zh, zw), off = self._parse_header(blob)
        *escapes, off = read_escape_record(blob, off)
        ext, off = prefixed_extents(blob, off, b)
        stream = unpack_stream_dense(blob, off)[:3]
        z = self.eb_decode_streams("entropy_bottleneck", blob, ext, (zh, zw))
        (z_sym,), _, (stream,), (corr,) = self._upload_decode(
            [z], None, [stream], [escapes],
            (b, h_img // 16, w_img // 16, self.latent_ch))
        y_hat = self._chain(z_sym, None, stream, corr, teacher=False)[2]
        x_hat = torch.clamp(self.model.synthesis(y_hat.permute(0, 3, 1, 2)),
                            0.0, 1.0)
        out = {"x_hat": _nhwc(x_hat), "y_hat": y_hat}
        if x_hat.is_cuda:
            torch.cuda.synchronize(x_hat.device)
        out["dectime"] = time.perf_counter() - start
        return out


class HESICPlusDeviceCodec(_WavefrontCodec, PipelinedCodec):
    """Wavefront device codec for HESIC+ (both eyes autoregressive; the
    right eye's entropy parameters also condition on the re-encoded
    decoded-left prior, the ``post`` input of the level scan).  One blob
    codes the whole batch of pairs.

    ``cap`` is the JAX class's word-buffer argument; here it reaches
    neither the container nor the codec's work (the encoder launches once
    per eye with room for every word, and the decoder's buffer is as wide
    as the largest count).  Images are (B, H, W, 3) float32 with H, W
    multiples of 64; homographies (B, 3, 3) or (1, 3, 3); latents come out
    as (B, hy, wy, M) float32.

    Container: backend byte | 5 x u32 (B, H, W, zh, zw) | escapes of eye
    1, of eye 2 | B z1 strings | B z2 strings | B x 9 f32 homographies |
    eye 1's packed stream | eye 2's (``_finish`` packs it, ``_parse``
    reads it).  The fast protocol is models/base.py's PipelinedCodec;
    ``decompress_fast_batch`` decodes the whole batch (``pairs`` None):
    the level scan folds every pair into its lanes."""

    def __init__(self, model, mm: int = 16, groups: int = 8,
                 cap: int = 256):
        super().__init__(model, mm, groups)
        self.cap = cap
        self.latent_ch = model.M
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        from .wavefront import pack_weights
        # packed for the level scan: eye 2's post input is the M channels
        # of the re-encoded decoded left view
        m = self.model
        self.w1 = pack_weights(extract_ar_weights(
            m, "context_prediction1", "entropy_parameters1"))
        self.w2 = pack_weights(extract_ar_weights(
            m, "context_prediction2", "entropy_parameters2"), m.M)

    # ---- device programs ----

    @torch.no_grad()
    def transforms_enc(self, x1, x2, h):
        """Encode-only: NCHW images -> float latents y1, y2 (NCHW) and
        integer z symbols."""
        m = self.model
        y1 = m.analysis1(x1)
        z1_sym = self._z_symbols(m.hyper_analysis1(y1), "entropy_bottleneck1")
        x1_warp, _ = warp_perspective(x1, h, WARP_WIN)
        y2 = m.analysis2(x1_warp, x2)
        z2_sym = self._z_symbols(m.hyper_analysis2(y2), "entropy_bottleneck2")
        return y1, y2, z1_sym, z2_sym

    @torch.no_grad()
    def _chain(self, z1_sym, z2_sym, y1, y2, s1, s2, c1, c2, h,
               teacher: bool, side: str = "enc"):
        """The both-eyes coding chain, shared by encode (teacher, y1/y2
        the NHWC latents) and decode (s1/s2 the (words, counts, states)
        streams, c1/c2 the escape (mask, value) maps or None).  Returns
        ((starts, freqs, y_hat, resid) per eye, x1_hat NCHW).  `side`
        ("enc" or "dec") names its spans only."""
        from .wavefront import ar_wavefront
        m = self.model
        mm, groups = self.mm, self.groups
        none3 = (None, None, None)
        with span(f"{side}/scan1"):
            pre1 = _nhwc(m.hyper_synthesis1(self._z_hat(
                z1_sym, "entropy_bottleneck1")))
            eye1 = ar_wavefront(self.w1, pre1, None, y1,
                                *(c1 or (None, None)), *(s1 or none3),
                                teacher, mm, groups)
            count("scan_levels", _levels(pre1))
        with span(f"{side}/reencode"):
            x1_hat = m.synthesis1(eye1[2].permute(0, 3, 1, 2))
            x1w, _ = warp_perspective(x1_hat, h, WARP_WIN)
            # left prior: eval-quantized re-encode of the decoded left view
            y1_prior = _nhwc(torch.round(m.analysis1(x1w)))
        with span(f"{side}/scan2"):
            pre2 = _nhwc(m.hyper_synthesis2(self._z_hat(
                z2_sym, "entropy_bottleneck2")))
            eye2 = ar_wavefront(self.w2, pre2, y1_prior, y2,
                                *(c2 or (None, None)), *(s2 or none3),
                                teacher, mm, groups)
            count("scan_levels", _levels(pre2))
        return eye1, eye2, x1_hat

    @torch.no_grad()
    def coded_latents(self, x1, x2, h):
        """What the encoder codes for a batch: NCHW images and (B, 3, 3)
        homographies on the codec's device -> (y1_hat, y2_hat (B, hy, wy,
        M) float32, the teacher chain's latents; z1_sym, z2_sym (B, C, zh,
        zw) int32)."""
        y1, y2, z1_sym, z2_sym = self.transforms_enc(x1, x2, h)
        eye1, eye2, _ = self._chain(z1_sym, z2_sym, _nhwc(y1), _nhwc(y2),
                                    None, None, None, None, h, True)
        return eye1[2], eye2[2], z1_sym, z2_sym

    def _dec_out(self, x1_hat, y2_hat, h):
        """The decoder's output synthesis after the chain: x2_hat (B, 3, H,
        W) from the decoded left view x1_hat (B, 3, H, W) and the right
        latents y2_hat (B, hy, wy, M)."""
        x1w, _ = warp_perspective(x1_hat, h, WARP_WIN)
        return self.model.synthesis2(y2_hat.permute(0, 3, 1, 2), x1w)

    def device_flops(self, h_img: int, w_img: int, batch: int = 4) -> dict:
        """PyTorch's count of matmuls and convolutions (FlopCounterMode) in
        one encode and decode round trip of `batch` h_img x w_img pairs,
        the JAX package's programs: ``enc_transforms``
        (``transforms_enc``), ``chain`` (``_chain``, run once as a
        teacher pass; encode and decode each run it) and ``dec_out``
        (``_dec_out``), each once under torch.no_grad() on seeded images
        at the identity H, on the codec's device.  flops_total =
        enc_transforms + 2 chain + dec_out.  Returns {"flops_total",
        "flops_per_pair", "per_program"}.  Kernel 5 (one operator the
        counter does not look into, on either device) is not counted, as
        XLA did not count the Pallas level scan: the count is the same on
        the CPU and the card.  On the card it launches kernel 5 twice."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        x1, x2 = (self._to_device(torch.rand(
            (batch, h_img, w_img, 3), generator=gen, device=self.device))
            for _ in range(2))
        h, _ = self._homographies(np.eye(3, dtype=np.float32)[None], batch)
        per = {}
        with torch.no_grad():
            (y1, y2, z1_sym, z2_sym), per["enc_transforms"] = counted_flops(
                self.transforms_enc, x1, x2, h)
            (_, eye2, x1_hat), per["chain"] = counted_flops(
                self._chain, z1_sym, z2_sym, _nhwc(y1), _nhwc(y2), None,
                None, None, None, h, True)
            _, per["dec_out"] = counted_flops(self._dec_out, x1_hat,
                                              eye2[2], h)
        total = per["enc_transforms"] + 2 * per["chain"] + per["dec_out"]
        return {"flops_total": total, "flops_per_pair": total / batch,
                "per_program": per}

    # ---- container ----

    @torch.no_grad()
    def compress(self, x1, x2, h_matrix) -> dict:
        """Compress a batch of pairs into one blob, synchronously (a start
        and its finish).  Returns {'strings': [blob], 'shape': (hy, wy),
        'y1_hat', 'y2_hat' (B, hy, wy, M), 'bpp_real', 'enctime',
        'escapes': per-eye escape counts}."""
        return self._compressed(self._encode_device(x1, x2, h_matrix))

    @torch.no_grad()
    def _compress_latents(self, y1, y2, z1_sym, z2_sym, h, h_np, size,
                          start: float) -> dict:
        """compress after the transforms: both eyes' level scans over the
        whole batch, kernel 4 once per eye, and the blob (the split encode
        of parallel/codec.py gathers the transforms' outputs of its ranks
        and calls this on every rank).  `size` is (H, W) of the images;
        `start` the perf_counter time enctime counts from."""
        return self._compressed(self._encode_latents(
            y1, y2, z1_sym, z2_sym, h, h_np, size, start))

    def _compressed(self, handle) -> dict:
        """compress's keys for an encode handle, finished."""
        out = self._finish(handle)
        h_img, w_img = handle["shape"]
        return {"strings": out["blobs"], "shape": (h_img // 16, w_img // 16),
                "y1_hat": handle["y_hat"][0], "y2_hat": handle["y_hat"][1],
                **{k: out[k] for k in ("bpp_real", "enctime", "escapes")}}

    @torch.no_grad()
    def decompress(self, strings) -> dict:
        """Inverse of compress, synchronously: {'x1_hat', 'x2_hat' (B, H,
        W, 3), 'y1_hat', 'y2_hat' (B, hy, wy, M), 'dectime'}."""
        start = time.perf_counter()
        blob = strings[0] if isinstance(strings, (list, tuple)) else strings
        self._decodes += 1
        out = self._decompress_fast_batch(blob)
        if out["x2_hat"].is_cuda:
            torch.cuda.synchronize(out["x2_hat"].device)
        out["dectime"] = time.perf_counter() - start
        return out

    # ---- the fast protocol (module docstring) ----

    def _escape_slab(self, resid: torch.Tensor) -> torch.Tensor:
        """(2 ESCAPE_CAP + 1,) int64: the number of residuals beyond the
        grid, then the flat NHWC indices of the first ESCAPE_CAP of them
        (-1 past the count) and their values.  Dispatched: nothing waits
        for the device."""
        flat = resid.reshape(-1)
        hit = torch.abs(flat) > self.mm
        idx = torch.nonzero_static(hit, size=ESCAPE_CAP,
                                   fill_value=-1)[:, 0]
        vals = flat[idx.clamp_min(0)].to(torch.int64)
        return torch.cat([hit.sum().reshape(1), idx, vals])

    def _encode_device(self, x1, x2, h_matrix) -> dict:
        """The encoder's device half, dispatched: the transforms, then
        _encode_latents.  Returns the handle compress_fast_finish reads."""
        t0 = time.perf_counter()
        with span("enc/transforms"):
            x1, x2 = self._to_device(x1), self._to_device(x2)
            b, h_img, w_img = self._check_size(x1)
            h, h_np = self._homographies(h_matrix, b)
            y1, y2, z1_sym, z2_sym = self.transforms_enc(x1, x2, h)
        return self._encode_latents(y1, y2, z1_sym, z2_sym, h, h_np,
                                    (h_img, w_img), t0)

    def _encode_latents(self, y1, y2, z1_sym, z2_sym, h, h_np, size,
                        t0: float) -> dict:
        """The encoder's device half after the transforms, dispatched:
        both eyes' teacher chains, kernel 4 once per eye (room for every
        word), each eye's escape slab and the copies the host half reads
        (counts, states, escapes, z symbols).  Returns the handle; its
        "seq" numbers the encode in the traces."""
        from ..codecs.pairs_rans import rans_encode_pairs
        seq = self._encodes
        self._encodes += 1
        b = y1.shape[0]
        h_img, w_img = size
        eyes = self._chain(z1_sym, z2_sym, _nhwc(y1), _nhwc(y2), None,
                           None, None, None, h, True)[:2]
        with span("enc/pairs-rans"):
            valid = self._valid(b, h_img, w_img)
            streams = [rans_encode_pairs(st, fr, valid, st.shape[0])
                       for st, fr, _, _ in eyes]
        with span("enc/fetch"):
            meta = torch.cat([t.to(torch.int64) for t in (
                streams[0][1], streams[1][1], streams[0][2], streams[1][2],
                self._escape_slab(eyes[0][3]),
                self._escape_slab(eyes[1][3]))])
            z = torch.cat([t.permute(0, 2, 3, 1).reshape(-1)
                           for t in (z1_sym, z2_sym)])
            fetched = self._fetch({"meta": meta, "z": z})
        return {"mode": "async", "seq": seq, "t0": t0,
                "mm": (self.mm, self.mm), "b": b,
                "shape": (h_img, w_img), "h_np": h_np,
                "z_shape": tuple(z1_sym.permute(0, 2, 3, 1).shape),
                "slots": eyes[0][0].shape[0],
                "words": [s[0] for s in streams],
                "counts": [s[1] for s in streams],
                "resid": [e[3] for e in eyes],
                "y_hat": [e[2] for e in eyes], **fetched}

    def _escapes(self, handle, eye: int, slab: np.ndarray):
        """An eye's (indices, values) from its fetched slab; past
        ESCAPE_CAP, a synchronous gather on the finish stream.  Returns
        (indices, values, whether it fell back)."""
        n, cap = int(slab[0]), ESCAPE_CAP
        if n <= cap:
            return slab[1:1 + n], slab[1 + cap:1 + cap + n], False
        resid = handle["resid"][eye]
        with self._on_finish_stream(handle, [resid]):
            idx, vals = self._gather_escapes(resid)
        if idx.size != n:
            raise RuntimeError(f"escape gather found {idx.size} residuals "
                               f"beyond the grid, the device counted {n}")
        return idx, vals, True

    def _finish(self, handle, batch_container: bool = True) -> dict:
        """The encoder's host half: wait for the handle's copies, fetch
        the counted words (gathered lane-major on the finish stream), the
        escapes, the z strings, the container.  The container is always
        the batch's (``batch_container`` is the fast codecs' argument;
        this codec has no per-pair container)."""
        b, lanes = handle["b"], handle["counts"][0].shape[0]
        with span("enc/wait-counts"):
            host = self._fetched(handle)
            meta, z = host["meta"], host["z"]
        slab = 2 * ESCAPE_CAP + 1
        c1, c2, st1, st2, esc1, esc2 = np.split(meta, np.cumsum(
            [lanes] * 4 + [slab])[:5])
        cmax = int(max(c1.max(), c2.max()))
        if cmax > handle["slots"]:
            raise RuntimeError(f"pairs encoder counted {cmax} words in a "
                               f"lane of {handle['slots']} slots")
        totals = [int(c1.sum()), int(c2.sum())]
        flats = self._fetch_words(
            handle, totals, handle["words"] + handle["counts"],
            lambda: [_compact_lanes(w, c, n) for w, c, n in
                     zip(handle["words"], handle["counts"], totals)])
        with span("enc/escapes"):
            escapes = [self._escapes(handle, e, slab_e)
                       for e, slab_e in enumerate((esc1, esc2))]
            records = [escape_record(idx, vals) for idx, vals, _ in escapes]
            n_esc = tuple(int(idx.size) for idx, _, _ in escapes)
        count("latents", 2 * handle["resid"][0].numel())
        count("escapes", sum(n_esc))
        count("escape_fallbacks", sum(fb for _, _, fb in escapes))
        with span("enc/z-rans"):
            zn = z.size // 2
            zb = [length_prefixed(self.eb_encode_symbols(
                name, part.reshape(handle["z_shape"])))
                for name, part in (("entropy_bottleneck1", z[:zn]),
                                   ("entropy_bottleneck2", z[zn:]))]
        with span("enc/pack"):
            h_img, w_img = handle["shape"]
            zh, zw = handle["z_shape"][1:3]
            blob = (self._header(b, h_img, w_img, zh, zw) + records[0]
                    + records[1] + zb[0] + zb[1]
                    + handle["h_np"].astype(np.float32).tobytes()
                    + pack_stream_dense(flats[0], c1, st1.astype(np.uint32))
                    + pack_stream_dense(flats[1], c2,
                                        st2.astype(np.uint32)))
        return {"blob": blob, "blobs": [blob],
                "bpp_real": len(blob) * 8 / (2 * b * h_img * w_img),
                "enctime": time.perf_counter() - handle["t0"],
                "escapes": n_esc, "fallback": False}

    def _parse(self, blob: bytes) -> dict:
        """The container's parts, on the host (views of `blob`): {"dims":
        (B, H, W, zh, zw), "escapes": per eye (flat NHWC indices, values),
        "z": per bottleneck its B strings' (start, end) byte extents, "h":
        (B x 9,) float32, "streams": per eye (lane-major u16 words,
        counts, u32 states)}.  Raises on another backend's container, and
        where the layout does not end with the blob."""
        dims, off = self._parse_header(blob)
        b = dims[0]
        escapes = []
        for _ in range(2):
            *record, off = read_escape_record(blob, off)
            escapes.append(record)
        extents, off = prefixed_extents(blob, off, 2 * b)
        h_np = np.frombuffer(blob, np.float32, 9 * b, off)
        off += 36 * b
        streams = []
        for _ in range(2):
            *stream, off = unpack_stream_dense(blob, off)
            streams.append(stream)
        if off != len(blob):
            raise ValueError(f"wavefront container: the parse ends at byte "
                             f"{off} of {len(blob)}")
        return {"dims": dims, "escapes": escapes,
                "z": [extents[:b], extents[b:]], "h": h_np,
                "streams": streams}

    def _decompress_fast_batch(self, blob: bytes, pairs: slice = None
                               ) -> dict:
        """decompress_fast_batch (PipelinedCodec) inside its span: the
        z strings decode on the host; z symbols, homographies, counts,
        states, words and escapes go up in one pinned upload; the word
        buffers and escape maps are rebuilt on the device.  Returns
        {'x1_hat', 'x2_hat' (B, H, W, 3), 'y1_hat', 'y2_hat' (B, hy, wy,
        M), 'dectime'}."""
        if pairs is not None:
            raise ValueError("a wavefront container codes its pairs as one "
                             "batch: decode it whole (pairs=None)")
        start = time.perf_counter()
        with span("dec/parse"):
            parts = self._parse(blob)
            b, h_img, w_img, zh, zw = parts["dims"]
        with span("dec/z-rans"):
            z = [self.eb_decode_streams(name, blob, ext, (zh, zw))
                 for name, ext in zip(("entropy_bottleneck1",
                                       "entropy_bottleneck2"), parts["z"])]
        (z1_sym, z2_sym), h, streams, corr = self._upload_decode(
            z, parts["h"], parts["streams"], parts["escapes"],
            (b, h_img // 16, w_img // 16, self.latent_ch))
        out = self._decode_device(z1_sym, z2_sym, h, streams, corr)
        out["dectime"] = time.perf_counter() - start
        return out

    def _decode_device(self, z1_sym, z2_sym, h, streams, corr) -> dict:
        """The decoder's device half, dispatched: both decode chains over
        the eyes' (words, counts, states) `streams` and escape maps `corr`
        (None for an eye without escapes), then the output synthesis.
        Returns {'x1_hat', 'x2_hat' (B, H, W, 3), 'y1_hat', 'y2_hat' (B,
        hy, wy, M)}."""
        eye1, eye2, x1_hat = self._chain(z1_sym, z2_sym, None, None,
                                         *streams, *corr, h,
                                         teacher=False, side="dec")
        with span("dec/synthesis"):
            x2_hat = self._dec_out(x1_hat, eye2[2], h)
            return {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
                    "y1_hat": eye1[2], "y2_hat": eye2[2]}
