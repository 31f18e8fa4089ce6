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
once).  The two codecs share the container's parts (``_WavefrontCodec``:
escapes, z strings, the packed streams and the decoder's word buffers).

Bit-exactness invariant: encoder and decoder run the same chain (each
codec's ``_chain``: hyper-synthesis -> level scan, and for HESIC+ then
synthesis -> warp -> re-encode of the decoded left view ->
hyper-synthesis -> level scan of eye 2) at the same batch, with the
codec's determinism policy (deterministic cuDNN, no TF32); the level
scan's parameters come from a fixed-order kernel that encode and decode
both launch.  Only integers cross between the directions.

Not carried over from the JAX codec: the TPU link devices
(``DENSE_LINK_THRESHOLD``, ``compact_stream``, ``upload_words_auto``,
``pow2_bucket``: words cross with ``.cpu()``) and the ``HESIC_NO_PALLAS``
switch (the tensor's device selects the backend).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codecs.device_rans import PROB_BITS, pack_stream, unpack_stream
from ..geometry import warp_perspective
from .autoregressive import extract_ar_weights
from .base import CompressionModel, counted_flops, deterministic_backends

# mask-A taps of the 5x5 context kernel: two rows above (all columns)
# plus the two left neighbours in the centre row
TAPS = [(di - 2, dj - 2) for di in range(2) for dj in range(5)] \
    + [(0, -2), (0, -1)]

# the left prior's warp: warp_perspective_mxu's defaults in the JAX codec
WARP_WIN = 64

# Stream-format byte.  The JAX package's backends are 0 (lax.scan, XLA
# erfc) and 2 (Pallas level scan); the port's two differ from both and
# from each other (other product orders), so they take ids of their own.
BACKEND_NAMES = {0: "xla-scan", 2: "pallas-level-scan",
                 3: "torch-plain-level-scan", 4: "cuda-level-scan"}


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


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
    """The backend byte for level scans on `device`: 4 = the CUDA kernel,
    3 = the plain twin (CPU)."""
    return 4 if torch.device(device).type == "cuda" else 3


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
    grid (``mm``) and channel groups, z symbols and strings, one kernel 4
    launch per level scan, the escape side-channel, the packed streams
    and the decoder's word buffers."""

    def __init__(self, model, mm: int, groups: int):
        super().__init__(model)
        deterministic_backends()
        self.mm, self.groups = mm, groups

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
        images of h_img x w_img."""
        return wavefront_valid_mask(h_img // 16, w_img // 16, b,
                                    self.groups, self.latent_ch, self.device)

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

    def _decoder_stream(self, blob: bytes, off: int):
        """One packed stream -> ((words, counts, states) on the codec
        device, next offset); the word buffer is as wide as the largest
        count."""
        words, counts, states, off = unpack_stream(blob, off)
        return (self._upload(words), self._upload(counts.astype(np.int32)),
                self._upload(states.astype(np.int64))), off

    def _pack_escapes(self, resid: torch.Tensor):
        """Residuals beyond the grid -> (container bytes: u32 n | u32 flat
        NHWC index[n] | i32 value[n], n)."""
        flat = resid.reshape(-1)
        idx = torch.nonzero(torch.abs(flat) > self.mm)[:, 0]
        vals = flat[idx].cpu().numpy().astype(np.int32)
        idx = idx.cpu().numpy().astype(np.uint32)
        return (np.array([idx.size], np.uint32).tobytes() + idx.tobytes()
                + vals.tobytes()), int(idx.size)

    def _parse_escapes(self, blob: bytes, off: int, shape):
        """Inverse of _pack_escapes -> ((mask, value) int32 maps of
        `shape` on the codec device, or None without escapes; next
        offset)."""
        (n,) = np.frombuffer(blob, np.uint32, 1, off)
        off += 4
        idx = np.frombuffer(blob, np.uint32, int(n), off)
        off += 4 * int(n)
        val = np.frombuffer(blob, np.int32, int(n), off)
        off += 4 * int(n)
        if n == 0:
            return None, off
        cm = np.zeros(int(np.prod(shape)), np.int32)
        cv = np.zeros(int(np.prod(shape)), np.int32)
        cm[idx] = 1
        cv[idx] = val
        return (self._upload(cm.reshape(shape)),
                self._upload(cv.reshape(shape))), off

    def _z_bytes(self, name: str, z_sym) -> bytes:
        """One bottleneck's z strings, each behind its u32 length."""
        strs = self.eb_encode_symbols(name,
                                      z_sym.permute(0, 2, 3, 1).cpu().numpy())
        return b"".join(np.array([len(s)], np.uint32).tobytes() + s
                        for s in strs)

    def _parse_z(self, blob: bytes, off: int, name: str, b: int, zh: int,
                 zw: int):
        """Inverse of _z_bytes for `b` strings -> ((B, C, zh, zw) int32 z
        symbols on the codec device, next offset)."""
        extents = []
        for _ in range(b):
            (length,) = np.frombuffer(blob, np.uint32, 1, off)
            extents.append((off + 4, off + 4 + int(length)))
            off += 4 + int(length)
        z = self.eb_decode_streams(name, blob, extents, (zh, zw))
        z = np.ascontiguousarray(z.transpose(0, 3, 1, 2))
        return self._upload(z), off

    def _header(self, b: int, h_img: int, w_img: int, z_sym) -> bytes:
        """The backend byte and the 5 x u32 header (B, H, W, zh, zw)."""
        return bytes([wavefront_backend_id(self.device)]) + np.array(
            [b, h_img, w_img, z_sym.shape[2], z_sym.shape[3]],
            np.uint32).tobytes()

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

    Container: backend byte (4 card, 3 CPU twin) | 5 x u32 (B, H, W, zh,
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
        escapes, n_esc = self._pack_escapes(resid)
        blob = (self._header(b, h_img, w_img, z_sym) + escapes
                + self._z_bytes("entropy_bottleneck", z_sym) + stream)
        return {"strings": [blob], "shape": tuple(z_sym.shape[2:]),
                "y_hat": y_hat, "bpp_real": len(blob) * 8 / (b * h_img
                                                             * w_img),
                "enctime": time.perf_counter() - start, "escapes": n_esc}

    @torch.no_grad()
    def decompress(self, strings, shape=None) -> dict:
        """Inverse of compress: {'x_hat' (B, H, W, 3) clipped to [0, 1],
        'y_hat' (B, hy, wy, M), 'dectime'}.  `shape` is the host codecs'
        argument, taken and not used (the blob's header has the sizes)."""
        start = time.perf_counter()
        blob = strings[0] if isinstance(strings, (list, tuple)) else strings
        (b, h_img, w_img, zh, zw), off = self._parse_header(blob)
        corr, off = self._parse_escapes(
            blob, off, (b, h_img // 16, w_img // 16, self.latent_ch))
        z_sym, off = self._parse_z(blob, off, "entropy_bottleneck", b, zh,
                                   zw)
        stream, off = self._decoder_stream(blob, off)
        y_hat = self._chain(z_sym, None, stream, corr, teacher=False)[2]
        x_hat = torch.clamp(self.model.synthesis(y_hat.permute(0, 3, 1, 2)),
                            0.0, 1.0)
        out = {"x_hat": _nhwc(x_hat), "y_hat": y_hat}
        if x_hat.is_cuda:
            torch.cuda.synchronize(x_hat.device)
        out["dectime"] = time.perf_counter() - start
        return out


class HESICPlusDeviceCodec(_WavefrontCodec):
    """Wavefront device codec for HESIC+ (both eyes autoregressive; the
    right eye's entropy parameters also condition on the re-encoded
    decoded-left prior, the ``post`` input of the level scan).  One blob
    codes the whole batch of pairs.

    ``cap`` is the JAX class's word-buffer argument; here it reaches
    neither the container nor the codec's work (the encoder launches once
    per eye with room for every word, and the decoder's buffer is as wide
    as the largest count).  Images are (B, H, W, 3) float32 with H, W
    multiples of 64; homographies (B, 3, 3) or (1, 3, 3); latents come
    out as (B, hy, wy, M) float32.

    Container: backend byte | 5 x u32 (B, H, W, zh, zw) | escapes of eye
    1, of eye 2 | B z1 strings | B z2 strings | B x 9 f32 homographies |
    eye 1's packed stream | eye 2's."""

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
               teacher: bool):
        """The both-eyes coding chain, shared by encode (teacher, y1/y2
        the NHWC latents) and decode (s1/s2 the (words, counts, states)
        streams, c1/c2 the escape (mask, value) maps or None).  Returns
        ((starts, freqs, y_hat, resid) per eye, x1_hat NCHW)."""
        from .wavefront import ar_wavefront
        m = self.model
        mm, groups = self.mm, self.groups
        none3 = (None, None, None)
        pre1 = _nhwc(m.hyper_synthesis1(self._z_hat(z1_sym,
                                                    "entropy_bottleneck1")))
        eye1 = ar_wavefront(self.w1, pre1, None, y1, *(c1 or (None, None)),
                            *(s1 or none3), teacher, mm, groups)
        x1_hat = m.synthesis1(eye1[2].permute(0, 3, 1, 2))
        x1w, _ = warp_perspective(x1_hat, h, WARP_WIN)
        # left prior: eval-quantized re-encode of the decoded left view
        y1_prior = _nhwc(torch.round(m.analysis1(x1w)))
        pre2 = _nhwc(m.hyper_synthesis2(self._z_hat(z2_sym,
                                                    "entropy_bottleneck2")))
        eye2 = ar_wavefront(self.w2, pre2, y1_prior, y2,
                            *(c2 or (None, None)), *(s2 or none3), teacher,
                            mm, groups)
        return eye1, eye2, x1_hat

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
        """Compress a batch of pairs into one blob.  Returns {'strings':
        [blob], 'shape': (hy, wy), 'y1_hat', 'y2_hat' (B, hy, wy, M),
        'bpp_real', 'enctime', 'escapes': per-eye escape counts}."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        b, h_img, w_img = self._check_size(x1)
        h, h_np = self._homographies(h_matrix, b)
        y1, y2, z1_sym, z2_sym = self.transforms_enc(x1, x2, h)
        return self._compress_latents(y1, y2, z1_sym, z2_sym, h, h_np,
                                      (h_img, w_img), start)

    @torch.no_grad()
    def _compress_latents(self, y1, y2, z1_sym, z2_sym, h, h_np, size,
                          start: float) -> dict:
        """compress after the transforms: both eyes' level scans over the
        whole batch, kernel 4 once per eye, and the blob (the split encode
        of parallel/codec.py gathers the transforms' outputs of its ranks
        and calls this on every rank).  `size` is (H, W) of the images;
        `start` the perf_counter time enctime counts from."""
        b = y1.shape[0]
        h_img, w_img = size
        eye1, eye2, _ = self._chain(z1_sym, z2_sym, _nhwc(y1), _nhwc(y2),
                                    None, None, None, None, h, teacher=True)
        valid = self._valid(b, h_img, w_img)
        streams = [self._encode_level_scan(st, fr, valid)
                   for st, fr, _, _ in (eye1, eye2)]
        escapes = [self._pack_escapes(eye[3]) for eye in (eye1, eye2)]
        blob = (self._header(b, h_img, w_img, z1_sym)
                + escapes[0][0] + escapes[1][0]
                + self._z_bytes("entropy_bottleneck1", z1_sym)
                + self._z_bytes("entropy_bottleneck2", z2_sym)
                + h_np.astype(np.float32).tobytes() + streams[0]
                + streams[1])
        return {"strings": [blob], "shape": (h_img // 16, w_img // 16),
                "y1_hat": eye1[2], "y2_hat": eye2[2],
                "bpp_real": len(blob) * 8 / (2 * b * h_img * w_img),
                "enctime": time.perf_counter() - start,
                "escapes": (escapes[0][1], escapes[1][1])}

    @torch.no_grad()
    def decompress(self, strings) -> dict:
        """Inverse of compress: {'x1_hat', 'x2_hat' (B, H, W, 3), 'y1_hat',
        'y2_hat' (B, hy, wy, M), 'dectime'}."""
        start = time.perf_counter()
        blob = strings[0] if isinstance(strings, (list, tuple)) else strings
        (b, h_img, w_img, zh, zw), off = self._parse_header(blob)
        shp = (b, h_img // 16, w_img // 16, self.latent_ch)
        corr1, off = self._parse_escapes(blob, off, shp)
        corr2, off = self._parse_escapes(blob, off, shp)
        z1_sym, off = self._parse_z(blob, off, "entropy_bottleneck1", b, zh,
                                    zw)
        z2_sym, off = self._parse_z(blob, off, "entropy_bottleneck2", b, zh,
                                    zw)
        h = self._upload(np.frombuffer(blob, np.float32, 9 * b, off)
                         .reshape(b, 3, 3))
        off += 36 * b
        s1, off = self._decoder_stream(blob, off)
        s2, off = self._decoder_stream(blob, off)
        eye1, eye2, x1_hat = self._chain(z1_sym, z2_sym, None, None, s1, s2,
                                         corr1, corr2, h, teacher=False)
        x2_hat = self._dec_out(x1_hat, eye2[2], h)
        out = {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
               "y1_hat": eye1[2], "y2_hat": eye2[2]}
        if out["x2_hat"].is_cuda:
            torch.cuda.synchronize(out["x2_hat"].device)
        out["dectime"] = time.perf_counter() - start
        return out
