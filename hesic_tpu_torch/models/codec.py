"""The host codecs of the single-image priors.

Counterpart of hesic_tpu/models/codec.py.  The transforms run on the
codec's device; the coders are host C++ (codecs/host_rans.py), one
string per image, channel-major (the reference's NCHW flatten order):

* ``FactorizedPriorCodec`` (bmshj2018-factorized): y through the
  EntropyBottleneck's tables (``eb_compress``/``eb_decompress``);
* ``ScaleHyperpriorCodec`` (bmshj2018-hyperprior) and
  ``MeanScaleHyperpriorCodec`` (mbt2018-mean): z through the
  EntropyBottleneck's tables, y through the Gaussian tables at the
  scale-table indexes of ``h_s(z_hat)`` (``build_indexes``,
  ``gc_compress``/``gc_decompress``), about its means for mbt2018-mean;
* ``JointAutoregressiveCodec`` (mbt2018): z as above, y through the
  native raster-causal coder over the Gaussian tables
  (models/autoregressive.py), a batch's images on a thread pool.

Each encoder decodes its own z strings, so both sides derive y's
indexes (or the AR coder's ``pre``) from the same z_hat.  The codecs set
the determinism policy (``deterministic_backends``) when they are built,
as the other codecs do, so the conditioning is the same on both sides
at the same batch.  The strings carry no writer byte, as the JAX
package's carry none: they decode exactly only on the device that wrote
them.
"""

from __future__ import annotations

import time

import torch

from ..entropy_models import build_indexes
from .autoregressive import ar_compress, ar_decompress
from .base import CompressionModel, deterministic_backends


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


class _PriorCodec(CompressionModel):
    """Shared flow of the factorized and hyperprior codecs.  Images are
    (B, H, W, 3) float32 with H, W multiples of 64 (16 for the factorized
    prior); latents come out as (B, hy, wy, M) float32."""

    def __init__(self, model):
        super().__init__(model)
        deterministic_backends()

    def _encode_y(self, y) -> tuple:
        """-> (strings, y_hat, shape, z strings or None)."""
        raise NotImplementedError

    def _decode_y(self, strings, shape) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def compress(self, x) -> dict:
        """Returns {'strings' (the JAX codec's list: [y strings] or
        [y strings, z strings]), 'shape' (the latent's or z's spatial
        shape, as the JAX codec's), 'y_hat' (B, hy, wy, M), 'bpp_real'
        (every string's bytes x 8 over the pixels), 'enctime'}."""
        start = time.perf_counter()
        x = self._to_device(x)
        b, _, h_img, w_img = x.shape
        strings, y_hat, shape = self._encode_y(self.model.analysis(x))
        nbytes = sum(len(s) for group in strings for s in group)
        out = {"strings": strings, "shape": shape, "y_hat": _nhwc(y_hat),
               "bpp_real": nbytes * 8 / (b * h_img * w_img)}
        if y_hat.is_cuda:
            torch.cuda.synchronize(y_hat.device)
        out["enctime"] = time.perf_counter() - start
        return out

    @torch.no_grad()
    def decompress(self, strings, shape) -> dict:
        """Inverse of compress: {'x_hat' (B, H, W, 3) clipped to [0, 1],
        'y_hat' (B, hy, wy, M), 'dectime'}."""
        start = time.perf_counter()
        y_hat = self._decode_y(strings, shape)
        x_hat = torch.clamp(self.model.synthesis(y_hat), 0.0, 1.0)
        out = {"x_hat": _nhwc(x_hat), "y_hat": _nhwc(y_hat)}
        if x_hat.is_cuda:
            torch.cuda.synchronize(x_hat.device)
        out["dectime"] = time.perf_counter() - start
        return out


class FactorizedPriorCodec(_PriorCodec):
    """Host codec of bmshj2018-factorized: y through the
    EntropyBottleneck's tables; y_hat = round(y - medians) + medians.
    Strings are [y strings]."""

    def _encode_y(self, y):
        strings = self.eb_compress("entropy_bottleneck", y)
        medians = self._median("entropy_bottleneck")
        return [strings], torch.round(y - medians) + medians, \
            tuple(y.shape[2:])

    def _decode_y(self, strings, shape):
        if len(strings) != 1:
            raise ValueError("expected [y_strings]")
        return self.eb_decompress("entropy_bottleneck", strings[0], shape)


class ScaleHyperpriorCodec(_PriorCodec):
    """Host codec of bmshj2018-hyperprior (and, through the model's
    ``gaussian_params``, of mbt2018-mean): z through the
    EntropyBottleneck's tables, y through the Gaussian tables at the
    scale indexes of h_s(z_hat), rounded about the means where the model
    has them.  Strings are [y strings, z strings]."""

    def _params(self, z_hat):
        """-> (scale-table indexes, means or None), from z_hat."""
        scales, means = self.model.gaussian_params(z_hat)
        return build_indexes(scales, self.scale_table), means

    def _encode_y(self, y):
        z = self.model.hyper_analysis(y)
        z_strings = self.eb_compress("entropy_bottleneck", z)
        z_hat = self.eb_decompress("entropy_bottleneck", z_strings,
                                   z.shape[2:])
        indexes, means = self._params(z_hat)
        y_strings = self.gc_compress("gaussian_conditional", y, indexes,
                                     means)
        # the decoder's y_hat: the integer symbols, plus the means
        y_hat = (torch.round(y) if means is None
                 else torch.round(y - means) + means)
        return [y_strings, z_strings], y_hat, tuple(z.shape[2:])

    def _decode_y(self, strings, shape):
        if len(strings) != 2:
            raise ValueError("expected [y_strings, z_strings]")
        z_hat = self.eb_decompress("entropy_bottleneck", strings[1], shape)
        indexes, means = self._params(z_hat)
        return self.gc_decompress("gaussian_conditional", strings[0],
                                  indexes, means)


class MeanScaleHyperpriorCodec(ScaleHyperpriorCodec):
    """Host codec of mbt2018-mean: ScaleHyperpriorCodec's flow, y coded
    about the means that the model's h_s gives beside the scales."""


class JointAutoregressiveCodec(CompressionModel):
    """Host AR codec of mbt2018 (``JointAutoregressiveHierarchicalPriors``).
    Images are (B, H, W, 3) float32 with H, W multiples of 64; latents
    come out as (B, hy, wy, M) float32.  Strings are [y strings, z
    strings], one of each per image, as the JAX codec's."""

    def __init__(self, model):
        super().__init__(model)
        deterministic_backends()

    @torch.no_grad()
    def compress(self, x) -> dict:
        """Returns {'strings': [y_strings, z_strings], 'shape': (zh, zw),
        'y_hat' (B, hy, wy, M), 'bpp_real' (y and z bytes x 8 over the
        pixels), 'enctime', 'coder_s' (wall seconds in the native
        coder)}."""
        start = time.perf_counter()
        x = self._to_device(x)
        b, _, h_img, w_img = x.shape
        m = self.model
        y = m.analysis(x)
        z = m.hyper_analysis(y)
        z_strings = self.eb_compress("entropy_bottleneck", z)
        z_hat = self.eb_decompress("entropy_bottleneck", z_strings,
                                   z.shape[2:])
        params = m.hyper_synthesis(z_hat)
        t0 = time.perf_counter()
        y_strings, y_hat = ar_compress(self, y, params)
        coder_s = time.perf_counter() - t0
        nbytes = sum(len(s) for s in y_strings + z_strings)
        return {"strings": [y_strings, z_strings],
                "shape": tuple(z.shape[2:]), "y_hat": _nhwc(y_hat),
                "bpp_real": nbytes * 8 / (b * h_img * w_img),
                "enctime": time.perf_counter() - start, "coder_s": coder_s}

    @torch.no_grad()
    def decompress(self, strings, shape) -> dict:
        """Inverse of compress: {'x_hat' (B, H, W, 3) clipped to [0, 1],
        'y_hat' (B, hy, wy, M), 'dectime', 'coder_s'}."""
        start = time.perf_counter()
        if len(strings) != 2:
            raise ValueError("expected [y_strings, z_strings]")
        m = self.model
        z_hat = self.eb_decompress("entropy_bottleneck", strings[1], shape)
        params = m.hyper_synthesis(z_hat)
        t0 = time.perf_counter()
        y_hat = ar_decompress(self, strings[0], params)
        coder_s = time.perf_counter() - t0
        x_hat = torch.clamp(m.synthesis(y_hat), 0.0, 1.0)
        out = {"x_hat": _nhwc(x_hat), "y_hat": _nhwc(y_hat)}
        if x_hat.is_cuda:
            torch.cuda.synchronize(x_hat.device)
        out["dectime"] = time.perf_counter() - start
        out["coder_s"] = coder_s
        return out
