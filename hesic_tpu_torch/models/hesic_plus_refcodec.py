"""HESIC+'s reference-layout container codec (a ``.npz`` header and a
``.bin`` body).

Counterpart of hesic_tpu/models/hesic_plus_refcodec.py, over the port's
``HESICPlusCodec`` machinery (models/hesic_plus_codec.py):

* y is rounded without the means (the reference's quirk), unlike
  ``HESICPlusCodec``, which rounds about them;
* every y symbol is coded with its own pixel's single-Gaussian PMF
  (sigma and mean from the masked context conv and the
  entropy-parameter MLP, sigma bounded below at 0.11) on the grid
  [-minmax, minmax], clipped to 1/65536, scaled to a 65536 total,
  rounded and summed into a CDF row, through the range coder;
* the layout is HESICCodec's (models/hesic_codec.py): u16 H, W | per eye
  [u16 len(z), u16 minmax | the M/8-byte nonzero-channel bitmap | z
  string] | 9 x f32 homography; body y1 then y2, in the joint codec's
  pixel-major order (raster pixels outer, nonzero channels ascending
  inner).  minmax is max(|y|) at least 1, not bucketed.

Both directions run one host routine, ``_walk_eye``: a row-pipelined
numpy walk (the upper context as one (W, 10M) x (10M, 2M) product a
row, the two left taps and the 1x1 MLP a pixel), a copy of the JAX
package's, so on identical numpy inputs it emits the JAX walk's bytes.
The decoded context values are integers, so the encoder's and the
decoder's walks see the same inputs and compute the same rows.  The
transforms, the warps (the full bilinear gather) and the left prior run
on the codec's device; both sides compute ``pre`` from the same z_hat
and ``post`` from the same decoded left view (contiguous inputs, the
determinism policy set when the codec is built).  No writer byte: a
container decodes exactly only on the device that wrote it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.special import erfc

from ..codecs.host_rans import RangeDecoder, RangeEncoder
from ..geometry import homography
from .autoregressive import _PAD, extract_ar_weights
from .hesic_codec import (_nhwc, nonzero_channels, read_files, read_header,
                          write_files, write_header)
from .hesic_plus_codec import HESICPlusCodec

_HALF = np.float32(0.5)
_NEG_RSQRT2 = np.float32(-(2.0 ** -0.5))
_SCALE_BOUND = np.float32(0.11)  # the Gaussian conditional's scale bound


def _std_cumulative(x):
    """float32 0.5 * erfc(-x / sqrt(2))."""
    return _HALF * erfc(_NEG_RSQRT2 * x).astype(np.float32)


def _leaky(v):
    return np.where(v >= 0, v, np.float32(0.01) * v)


def _walk_eye(w, pre, post, minmax, nz, m, *, y_hat=None, enc=None,
              dec=None):
    """The encode/decode raster walk of one eye.

    w: the eye's ``ArWeights`` (extract_ar_weights); pre: (H, W, P)
    float32 hyper-synthesis output; post: (H, W, Q) or None; nz:
    ascending nonzero channel indexes.  Encode: pass ``y_hat`` (H, W, M)
    integers as float32 and ``enc``.  Decode: pass ``dec``; returns the
    reconstructed (H, W, M) float32 latent."""
    ctx_k = np.asarray(w.ctx_kernel.cpu(), np.float32)   # (5, 5, M, 2M)
    ctx_b = np.asarray(w.ctx_bias.cpu(), np.float32)
    ep_ks = [np.asarray(k.cpu(), np.float32) for k in w.ep_kernels]
    ep_bs = [np.asarray(b.cpu(), np.float32) for b in w.ep_biases]

    h, w_dim = pre.shape[:2]
    k_up = ctx_k[:_PAD].reshape(_PAD * 5 * m, 2 * m)    # rows above
    k_left2 = ctx_k[_PAD, 0]                            # (M, 2M)
    k_left1 = ctx_k[_PAD, 1]

    samples = np.arange(0, 2 * minmax + 1, dtype=np.float32)
    shift = np.float32(minmax)
    buf = np.zeros((h + 2 * _PAD, w_dim + 2 * _PAD, m), np.float32)
    out = None if enc is not None else np.zeros((h, w_dim, m), np.float32)

    for hh in range(h):
        rows = buf[hh:hh + _PAD]                        # (2, W+4, M)
        windows = np.lib.stride_tricks.sliding_window_view(rows, 5, axis=1)
        x_up = windows.transpose(1, 0, 3, 2).reshape(w_dim, _PAD * 5 * m)
        ctx_up = x_up @ k_up                            # (W, 2M)
        p_row = pre[hh]
        q_row = None if post is None else post[hh]
        row_buf = buf[hh + _PAD]                        # (W+4, M) view
        for ww in range(w_dim):
            ctx = (ctx_up[ww] + row_buf[ww] @ k_left2
                   + row_buf[ww + 1] @ k_left1 + ctx_b)
            feat = (np.concatenate([p_row[ww], ctx]) if q_row is None
                    else np.concatenate([p_row[ww], ctx, q_row[ww]]))
            g = _leaky(feat @ ep_ks[0] + ep_bs[0])
            g = _leaky(g @ ep_ks[1] + ep_bs[1])
            g = g @ ep_ks[2] + ep_bs[2]
            sigma = np.maximum(g[:m], _SCALE_BOUND)
            mean = g[m:]

            # the pixel's Gaussian PMF over the shifted symbol grid,
            # nonzero channels only
            values = np.abs(samples[None, :]
                            - (mean[nz, None] + shift))     # (nz, S)
            s = sigma[nz, None]
            pmf = (_std_cumulative((_HALF - values) / s)
                   - _std_cumulative((-_HALF - values) / s))
            pmf = np.clip(pmf, np.float32(1.0 / 65536), np.float32(1.0))
            freq = np.round(pmf / pmf.sum(axis=1, keepdims=True)
                            * np.float32(65536))
            cdf_rows = np.zeros((nz.size, samples.size + 1), np.int32)
            cdf_rows[:, 1:] = np.cumsum(freq, axis=1).astype(np.int32)

            if enc is not None:
                vals = y_hat[hh, ww]
                syms = vals[nz].astype(np.int32) + minmax
                enc.encode_rows(syms, cdf_rows)
            else:
                syms = dec.decode_rows(cdf_rows)
                vals = np.zeros(m, np.float32)
                vals[nz] = (syms - minmax).astype(np.float32)
                out[hh, ww] = vals
            row_buf[ww + _PAD] = vals
    return out


def _minmax_of(y_np) -> int:
    """The reference's minmax: max(|min|, |max|), at least 1."""
    return int(max(abs(float(y_np.max())), abs(float(y_np.min())), 1.0))


def _host_nhwc(t: torch.Tensor) -> np.ndarray:
    """(1, C, h, w) -> (h, w, C) float32 contiguous host array."""
    return np.ascontiguousarray(t[0].permute(1, 2, 0).float().cpu().numpy())


class HESICPlusRefCodec(HESICPlusCodec):
    """HESIC+ in the reference's own container (see the module
    docstring).  One pair per container: images (1, H, W, 3) float32 with
    H, W multiples of 64, the homography (1, 3, 3).  ``coder_s`` of a
    result is the wall time of the host walks."""

    def _weights(self, eye: int):
        return extract_ar_weights(self.model, f"context_prediction{eye}",
                                  f"entropy_parameters{eye}")

    @torch.no_grad()
    def compress(self, x1, x2, h_matrix, output_name, output_path="") -> dict:
        """Code one pair into ``{output_name}.npz`` and ``.bin`` under
        `output_path`.  Returns {'bpp_real', 'bpp_side', 'enctime',
        'coder_s', 'y1_hat', 'y2_hat' (1, hy, wy, M), 'strings': [header,
        body]}."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        if x1.shape[0] != 1:
            raise ValueError("the reference-layout codec takes one pair at "
                             "a time")
        h, h_np = self._homographies(h_matrix, 1)
        m = self.model
        size = tuple(x1.shape[2:])

        y1 = m.analysis1(x1)
        z1 = m.hyper_analysis1(y1)
        z1_strings = self.eb_compress("entropy_bottleneck1", z1)
        z1_hat = self.eb_decompress("entropy_bottleneck1", z1_strings,
                                    z1.shape[2:])
        params1 = m.hyper_synthesis1(z1_hat)
        y1_hat = torch.round(y1).contiguous()      # no means (quirk)
        x1_hat = m.synthesis1(y1_hat).contiguous()

        x1_warp = homography.warp_perspective(x1, h).contiguous()
        y2 = m.analysis2(x1_warp, x2)
        z2 = m.hyper_analysis2(y2)
        z2_strings = self.eb_compress("entropy_bottleneck2", z2)
        z2_hat = self.eb_decompress("entropy_bottleneck2", z2_strings,
                                    z2.shape[2:])
        params2 = m.hyper_synthesis2(z2_hat)
        y2_hat = torch.round(y2).contiguous()
        y1_prior = m.left_prior(x1_hat, h).contiguous()

        y1_np, y2_np = _host_nhwc(y1_hat), _host_nhwc(y2_hat)
        flags1 = nonzero_channels(y1_np.transpose(2, 0, 1))
        flags2 = nonzero_channels(y2_np.transpose(2, 0, 1))
        mm1, mm2 = _minmax_of(y1_np), _minmax_of(y2_np)
        header = write_header(size, ((z1_strings[0], mm1, flags1),
                                     (z2_strings[0], mm2, flags2)),
                              h_np[0])
        pre1, pre2 = _host_nhwc(params1), _host_nhwc(params2)
        post2 = _host_nhwc(y1_prior)
        t0 = time.perf_counter()
        enc = RangeEncoder()
        _walk_eye(self._weights(1), pre1, None, mm1, np.flatnonzero(flags1),
                  m.M, y_hat=y1_np, enc=enc)
        _walk_eye(self._weights(2), pre2, post2, mm2,
                  np.flatnonzero(flags2), m.M, y_hat=y2_np, enc=enc)
        body = enc.close()
        coder_s = time.perf_counter() - t0
        write_files(header, body, output_name, output_path)
        pixels = 2 * size[0] * size[1]
        return {"bpp_real": (len(header) + len(body)) * 8 / pixels,
                "bpp_side": len(header) * 8 / pixels,
                "enctime": time.perf_counter() - start, "coder_s": coder_s,
                "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
                "strings": [header, body]}

    def decompress(self, output_name, output_path="", h_matrix=None) -> dict:
        """Decode ``{output_name}.npz``/``.bin`` (see decompress_bytes)."""
        return self.decompress_bytes(*read_files(output_name, output_path),
                                     h_matrix=h_matrix)

    @torch.no_grad()
    def decompress_bytes(self, header: bytes, body: bytes,
                         h_matrix=None) -> dict:
        """-> {'x1_hat', 'x2_hat' (1, H, W, 3), 'y1_hat', 'y2_hat',
        'h_matrix' (1, 3, 3) numpy, 'dectime', 'coder_s'}.  `h_matrix`
        overrides the header's homography."""
        start = time.perf_counter()
        m = self.model
        size, eyes, h_head = read_header(header, m.M, with_h=True)
        h, h_np = self._homographies(
            h_head if h_matrix is None else h_matrix, 1)
        z_shape = (size[0] // 64, size[1] // 64)
        dec = RangeDecoder(body)

        z1_hat = self.eb_decompress("entropy_bottleneck1", [eyes[0][2]],
                                    z_shape)
        pre1 = _host_nhwc(m.hyper_synthesis1(z1_hat))
        t0 = time.perf_counter()
        y1_np = _walk_eye(self._weights(1), pre1, None, eyes[0][0],
                          np.flatnonzero(eyes[0][1]), m.M, dec=dec)
        coder_s = time.perf_counter() - t0
        y1_hat = self._upload(np.ascontiguousarray(
            y1_np.transpose(2, 0, 1)[None]))
        x1_hat = m.synthesis1(y1_hat).contiguous()

        z2_hat = self.eb_decompress("entropy_bottleneck2", [eyes[1][2]],
                                    z_shape)
        pre2 = _host_nhwc(m.hyper_synthesis2(z2_hat))
        post2 = _host_nhwc(m.left_prior(x1_hat, h).contiguous())
        t0 = time.perf_counter()
        y2_np = _walk_eye(self._weights(2), pre2, post2, eyes[1][0],
                          np.flatnonzero(eyes[1][1]), m.M, dec=dec)
        coder_s += time.perf_counter() - t0
        y2_hat = self._upload(np.ascontiguousarray(
            y2_np.transpose(2, 0, 1)[None]))

        x1_hat_warp = homography.warp_perspective(x1_hat, h).contiguous()
        x2_hat = m.synthesis2(y2_hat, x1_hat_warp)
        out = {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
               "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
               "h_matrix": h_np}
        if x2_hat.is_cuda:
            torch.cuda.synchronize(x2_hat.device)
        out["dectime"] = time.perf_counter() - start
        out["coder_s"] = coder_s
        return out
