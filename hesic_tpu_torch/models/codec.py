"""The host autoregressive codec of mbt2018.

Counterpart of hesic_tpu/models/codec.py ``JointAutoregressiveCodec``:
the transforms run on the codec's device, z is coded channel-major
through the EntropyBottleneck tables, and y through the native
raster-causal coder over the Gaussian tables (models/autoregressive.py),
a batch's images on a thread pool.  The encoder decodes its own z
strings, so both sides derive the coder's ``pre`` from the same z_hat.
The codec sets the determinism policy (``deterministic_backends``) when
it is built, as the other codecs do, so ``pre`` is the same on both
sides at the same batch.
"""

from __future__ import annotations

import time

import torch

from .autoregressive import ar_compress, ar_decompress
from .base import CompressionModel, deterministic_backends


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


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
