"""The host codec of HESIC+: both eyes through the native AR coder.

Counterpart of hesic_tpu/models/hesic_plus.py ``HESICPlusCodec``.  One
pair at a time.  The left eye is mbt2018's flow (models/codec.py): z1
coded channel-major, the encoder decoding its own z strings, y1 through
the native raster-causal coder (models/autoregressive.py), whose y1_hat
is the decoder's exactly.  The right eye's analysis input is the left
view warped by the pair's homography (the full bilinear gather,
geometry/homography.py); its entropy parameters also take ``post``, the
left prior: the left view synthesised from the coder's y1_hat, warped,
re-encoded and rounded (``HESICPlus.left_prior``).  The decoder warps
its x1_hat for ``synthesis2``.  Every conditioning input is contiguous
before its convolution (a CPU convolution's result can depend on its
input's strides), and the codec sets the determinism policy when it is
built, so both sides compute the same left prior.

Container: writer byte | the JAX layout: u16 H, W | u16 len(z1) | z1 |
u16 len(z2) | z2 | u32 len(y1) | y1 | u32 len(y2) | y2 | 9 x f32
homography.  The writer byte names the device whose transforms wrote it
(6 the card, 5 the CPU); the decoder refuses any other writer.
``HESICPlusTogetherCodec`` is HESICPlusTogether's: this codec, then the
cross-view enhancement (models/base.py ``TogetherCodec``).
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch

from ..geometry import homography
from .autoregressive import ar_compress, ar_decompress
from .base import CompressionModel, TogetherCodec, deterministic_backends

# Byte 0 of a container.  The JAX package's container has no writer byte;
# the port's two writers take ids no other container of the port uses.
WRITER_NAMES = {5: "torch-cpu-host-ar", 6: "cuda-host-ar"}


def writer_id(device) -> int:
    """The writer byte of containers encoded on `device`: 6 = the card,
    5 = the CPU."""
    return 6 if torch.device(device).type == "cuda" else 5


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


class HESICPlusCodec(CompressionModel):
    """Host AR codec of HESIC+.  Images are (1, H, W, 3) float32 with H,
    W multiples of 64, the homography (1, 3, 3)."""

    def __init__(self, model):
        super().__init__(model)
        deterministic_backends()

    def _eye1(self, z1_hat, y1=None, y1_string=None):
        """Eye 1 from z1_hat: encode y1 (-> (strings, y1_hat)) or decode
        y1_string (-> (None, y1_hat)); y1_hat (1, M, h, w) contiguous."""
        m = self.model
        params1 = m.hyper_synthesis1(z1_hat).contiguous()
        kw = dict(ctx_name="context_prediction1",
                  ep_prefix="entropy_parameters1",
                  gc_name="gaussian_conditional1")
        if y1 is not None:
            return ar_compress(self, y1, params1, **kw)
        return None, ar_decompress(self, [y1_string], params1, **kw)

    def _eye2(self, z2_hat, x1_hat, h, y2=None, y2_string=None):
        """Eye 2 from z2_hat and the decoded left view: the left prior,
        then encode y2 or decode y2_string, as _eye1."""
        m = self.model
        params2 = m.hyper_synthesis2(z2_hat).contiguous()
        y1_prior = m.left_prior(x1_hat, h).contiguous()
        kw = dict(post=y1_prior, ctx_name="context_prediction2",
                  ep_prefix="entropy_parameters2",
                  gc_name="gaussian_conditional2")
        if y2 is not None:
            return ar_compress(self, y2, params2, **kw)
        return None, ar_decompress(self, [y2_string], params2, **kw)

    @torch.no_grad()
    def compress(self, x1, x2, h_matrix, output_name=None,
                 output_path="") -> dict:
        """Compress one pair.  Returns {'strings': [blob], 'bpp_real'
        (blob bytes x 8 over both views' pixels), 'enctime', 'y1_hat',
        'y2_hat' (1, hy, wy, M)}; writes ``{output_name}.hesicp`` under
        `output_path` when a name is given."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        if x1.shape[0] != 1:
            raise ValueError("the HESIC+ codec takes one pair at a time")
        h, h_np = self._homographies(h_matrix, 1)
        m = self.model
        h_img, w_img = x1.shape[2:]

        y1 = m.analysis1(x1)
        z1 = m.hyper_analysis1(y1)
        z1_strings = self.eb_compress("entropy_bottleneck1", z1)
        z1_hat = self.eb_decompress("entropy_bottleneck1", z1_strings,
                                    z1.shape[2:])
        y1_strings, y1_hat = self._eye1(z1_hat, y1=y1)
        x1_hat = m.synthesis1(y1_hat).contiguous()

        x1_warp = homography.warp_perspective(x1, h).contiguous()
        y2 = m.analysis2(x1_warp, x2)
        z2 = m.hyper_analysis2(y2)
        z2_strings = self.eb_compress("entropy_bottleneck2", z2)
        z2_hat = self.eb_decompress("entropy_bottleneck2", z2_strings,
                                    z2.shape[2:])
        y2_strings, y2_hat = self._eye2(z2_hat, x1_hat, h, y2=y2)

        blob = bytearray([writer_id(self.device)])
        blob += np.array([h_img, w_img], np.uint16).tobytes()
        for s in (z1_strings[0], z2_strings[0]):
            blob += struct.pack("<H", len(s)) + s
        for s in (y1_strings[0], y2_strings[0]):
            blob += struct.pack("<I", len(s)) + s
        blob += h_np[0].astype(np.float32).tobytes()
        blob = bytes(blob)
        if output_name is not None:
            with open(os.path.join(output_path, f"{output_name}.hesicp"),
                      "wb") as f:
                f.write(blob)
        return {"strings": [blob],
                "bpp_real": len(blob) * 8 / (2 * h_img * w_img),
                "enctime": time.perf_counter() - start,
                "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat)}

    def _parse(self, blob: bytes):
        """-> ((H, W), [z1, z2], [y1, y2], the 9 homography floats)."""
        tag, cur = blob[0], writer_id(self.device)
        if tag != cur:
            raise ValueError(
                f"HESIC+ container written by "
                f"{WRITER_NAMES.get(tag, f'an unknown writer ({tag})')} "
                f"but this codec reads {WRITER_NAMES[cur]} only; decode "
                f"it with its writer")
        off = 1
        size = tuple(int(v) for v in np.frombuffer(blob, np.uint16, 2, off))
        off += 4
        strs = []
        for fmt in ("<H", "<H", "<I", "<I"):
            (length,) = struct.unpack_from(fmt, blob, off)
            off += struct.calcsize(fmt)
            strs.append(blob[off:off + length])
            off += length
        h = np.frombuffer(blob, np.float32, 9, off)
        if off + 36 != len(blob):
            raise ValueError(f"HESIC+ container of {len(blob)} bytes ends "
                             f"at byte {off + 36}")
        return size, strs[:2], strs[2:], h

    @torch.no_grad()
    def decompress(self, blob, output_path="", h_matrix=None) -> dict:
        """Inverse of compress (`blob` the bytes, or the name of a file
        under `output_path`): {'x1_hat', 'x2_hat' (1, H, W, 3), 'y1_hat',
        'y2_hat' (1, hy, wy, M), 'h_matrix', 'dectime'}.  `h_matrix`
        overrides the container's homography."""
        if isinstance(blob, (list, tuple)):
            blob = blob[0]
        if isinstance(blob, str):
            with open(os.path.join(output_path, f"{blob}.hesicp"),
                      "rb") as f:
                blob = f.read()
        start = time.perf_counter()
        (h_img, w_img), z_strs, y_strs, h_np = self._parse(blob)
        h, h_np = self._homographies(
            h_np.reshape(1, 3, 3) if h_matrix is None else h_matrix, 1)
        m = self.model
        z_shape = (h_img // 64, w_img // 64)

        z1_hat = self.eb_decompress("entropy_bottleneck1", [z_strs[0]],
                                    z_shape)
        _, y1_hat = self._eye1(z1_hat, y1_string=y_strs[0])
        x1_hat = m.synthesis1(y1_hat).contiguous()
        z2_hat = self.eb_decompress("entropy_bottleneck2", [z_strs[1]],
                                    z_shape)
        _, y2_hat = self._eye2(z2_hat, x1_hat, h, y2_string=y_strs[1])
        x1_hat_warp = homography.warp_perspective(x1_hat, h).contiguous()
        x2_hat = m.synthesis2(y2_hat, x1_hat_warp)
        out = {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
               "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
               "h_matrix": h_np}
        if x2_hat.is_cuda:
            torch.cuda.synchronize(x2_hat.device)
        out["dectime"] = time.perf_counter() - start
        return out


class HESICPlusTogetherCodec(TogetherCodec):
    """HESICPlusTogether's codec: HESICPlusCodec codes the pair, the
    cross-view enhancement runs after decoding (the container is
    HESICPlusCodec's, so ``decompress`` takes what it takes)."""

    inner_codec_cls = HESICPlusCodec
