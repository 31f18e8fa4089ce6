"""DSIC's reference-layout container codec.

Counterpart of hesic_tpu/models/dsic_codec.py: HESICCodec's container
(models/hesic_codec.py) without the homography.  The right eye's GMM
prior is the rounded left latent itself, which the decoder has once it
has decoded y1; the left encoder's taps feed the right encoder and the
left decoder's taps the right decoder, through the global contexts of
the rounded left latent.  Header: u16 H, W, then per eye u16 len(z), u16
minmax, the nonzero-channel bitmap and the z string; body: y1 then y2,
range-coded channel-major.  No writer byte: a container decodes exactly
only on the device that wrote it.  ``DSICPlusCodec`` is DSIC+'s: this
codec, then the per-eye enhancement.
"""

from __future__ import annotations

import time

import torch

from ..codecs.host_rans import RangeDecoder, RangeEncoder
from .base import TogetherCodec
from .hesic_codec import (ContainerCodec, _nhwc, read_files, read_header,
                          write_files, write_header)


class DSICCodec(ContainerCodec):
    """DSIC's reference-layout codec.  One pair per container: images
    (1, H, W, 3) float32 with H, W multiples of 64."""

    @torch.no_grad()
    def compress(self, x1, x2, output_name, output_path="") -> dict:
        """Code one pair into ``{output_name}.npz`` and ``.bin`` under
        `output_path`.  Returns {'bpp_real', 'bpp_side', 'enctime',
        'coder_s', 'y1_hat', 'y2_hat' (1, hy, wy, M), 'strings': [header,
        body]}, as HESICCodec.compress."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        if x1.shape[0] != 1:
            raise ValueError("the DSIC container codec takes one pair at a "
                             "time")
        m = self.model
        size = tuple(x1.shape[2:])

        y1, g1_1, g1_2, g1_3 = m.analysis1(x1)
        z1_str, z1_hat = self._z("entropy_bottleneck1",
                                 m.hyper_analysis1(y1))
        gmm1 = m.gmm1(z1_hat)
        y1_hat = torch.round(y1).contiguous()      # no means (quirk)
        contexts = m.contexts(y1_hat)
        y2 = m.analysis2(x2, g1_1, g1_2, g1_3, contexts)
        z2_str, z2_hat = self._z("entropy_bottleneck2",
                                 m.hyper_analysis2(y2))
        gmm2 = m.gmm2(z2_hat, y1_hat)
        y2_hat = torch.round(y2).contiguous()

        enc = RangeEncoder()
        mm1, flags1, c1 = self._encode_eye(enc, gmm1, y1_hat)
        mm2, flags2, c2 = self._encode_eye(enc, gmm2, y2_hat)
        t0 = time.perf_counter()
        body = enc.close()
        coder_s = c1 + c2 + time.perf_counter() - t0
        header = write_header(size, ((z1_str, mm1, flags1),
                                     (z2_str, mm2, flags2)))
        write_files(header, body, output_name, output_path)
        pixels = 2 * size[0] * size[1]
        return {"bpp_real": (len(header) + len(body)) * 8 / pixels,
                "bpp_side": len(header) * 8 / pixels,
                "enctime": time.perf_counter() - start, "coder_s": coder_s,
                "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
                "strings": [header, body]}

    def decompress(self, output_name, output_path="") -> dict:
        """Decode ``{output_name}.npz``/``.bin`` (see decompress_bytes)."""
        return self.decompress_bytes(*read_files(output_name, output_path))

    @torch.no_grad()
    def decompress_bytes(self, header: bytes, body: bytes) -> dict:
        """-> {'x1_hat', 'x2_hat' (1, H, W, 3), 'y1_hat', 'y2_hat',
        'dectime', 'coder_s'}."""
        start = time.perf_counter()
        m = self.model
        size, eyes, _ = read_header(header, m.M, with_h=False)
        y_shape = (size[0] // 16, size[1] // 16)
        z_shape = (y_shape[0] // 4, y_shape[1] // 4)
        z1_hat = self.eb_decompress("entropy_bottleneck1", [eyes[0][2]],
                                    z_shape)
        z2_hat = self.eb_decompress("entropy_bottleneck2", [eyes[1][2]],
                                    z_shape)
        dec = RangeDecoder(body)
        y1_hat, c1 = self._decode_eye(dec, m.gmm1(z1_hat), *eyes[0][:2],
                                      y_shape)
        x1_hat, g1_4, g1_5, g1_6 = m.synthesis1(y1_hat)
        contexts = m.contexts(y1_hat)
        y2_hat, c2 = self._decode_eye(dec, m.gmm2(z2_hat, y1_hat),
                                      *eyes[1][:2], y_shape)
        x2_hat = m.synthesis2(y2_hat, g1_4, g1_5, g1_6, contexts)
        out = {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
               "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat)}
        if x2_hat.is_cuda:
            torch.cuda.synchronize(x2_hat.device)
        out["dectime"] = time.perf_counter() - start
        out["coder_s"] = c1 + c2
        return out


class DSICPlusCodec(TogetherCodec):
    """DSICPlus's codec: DSICCodec codes the pair, the per-eye
    enhancement (no homography) runs after decoding."""

    inner_codec_cls = DSICCodec
    enhance_with_h = False
