"""HESIC's reference-layout container codec (a ``.npz`` header and a
``.bin`` body), and the container parts DSICCodec and HESICPlusRefCodec
share.

Counterpart of hesic_tpu/models/hesic_codec.py.  The layout is the
reference's, field for field:

  header (".npz"):  u16 H, u16 W | [u16 len(z), u16 minmax, u8[M/8]
  nonzero-channel bitmap, z rANS string] x 2 | 9 x f32 homography
  body   (".bin"):  range-coded y symbols, nonzero channels in ascending
  order, raster order within each channel; y1 then y2.

As in the JAX package, the homography is appended to the header (36
bytes) so the decoder is self-contained (an ``h_matrix`` argument
overrides it), and minmax is bucketed to a multiple of 8.  A container
carries no writer byte (the layout is the reference's): the decoder
recomputes the GMM heads on its own device, so a container decodes
exactly only on the device that wrote it.

y is rounded without the means (the reference's quirk) and each symbol
is coded with its own pixel's mixture PMF on the grid [-minmax, minmax]:
clipped to 1/65536, scaled to a 65536 total and rounded, then summed
into a CDF row (``_gmm_cdf_rows``, on the codec's device, in channel
chunks of at most ``CHUNK_BYTES`` of PMF terms, since the (h, w, M, K,
S) terms grow with minmax).  The host runs only the serial range-coder
walk, one native call per eye.  Both sides compute the rows from the
same z_hat (the encoder decodes its own z strings) and the same decoded
left view, in one pair per container, under the codecs' determinism
policy (``deterministic_backends``, set when the codec is built), with
contiguous inputs to every conditioning program.  Warps are the full
bilinear gather of geometry/homography.py (the JAX codec's
``warp_perspective``), not the fast codec's banded warp.
``HESICTogetherCodec`` is HESICTogether's: this codec, then the
cross-view enhancement (models/base.py ``TogetherCodec``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..codecs.host_rans import RangeDecoder, RangeEncoder
from ..entropy_models import gmm_pmf
from ..geometry import homography
from .base import CompressionModel, TogetherCodec, deterministic_backends

# the largest (h, w, channels, K, S) float32 PMF tensor _gmm_cdf_rows
# evaluates at once: 512x512 at M 192, K 5 and minmax 64 is ~0.5 GB
CHUNK_BYTES = 1 << 28
_TOTAL = 65536.0


def _gmm_cdf_rows(sigma, means, weights, y_hat, minmax: int, k: int):
    """Quantized per-pixel CDF rows and shifted symbols, channel-major.

    sigma, means (1, K*M, h, w) and weights (1, K*M, 1, 1) (the GMM
    heads, component k's channel m at k*M + m); y_hat (1, M, h, w) or
    None.  Returns (cdf_rows (M, h*w, S+1) int32 on the heads' device,
    symbols (M, h*w) int32 or None) with S = 2*minmax + 1: each row the
    PMF on [-minmax, minmax] clipped to [1/65536, 1], scaled to a 65536
    total and rounded, summed, after a leading zero; symbols y_hat +
    minmax."""
    km, h, w = sigma.shape[1:]
    m, s = km // k, 2 * minmax + 1
    samples = torch.arange(-minmax, minmax + 1, dtype=torch.float32,
                           device=sigma.device)

    def channels(t, lo, hi):          # channels-last, components k-major
        t = t[0].permute(1, 2, 0)
        return t.reshape(*t.shape[:2], k, m)[..., lo:hi].reshape(
            *t.shape[:2], k * (hi - lo))

    step = max(1, CHUNK_BYTES // (h * w * k * s * 4))
    rows = []
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        pmf = gmm_pmf(samples, channels(sigma, lo, hi),
                      channels(means, lo, hi), channels(weights, lo, hi), k)
        pmf = torch.clamp(pmf, 1.0 / _TOTAL, 1.0)       # (h, w, c, S)
        freq = torch.round(pmf / pmf.sum(-1, keepdim=True) * _TOTAL)
        cdf = torch.nn.functional.pad(torch.cumsum(freq, -1), (1, 0))
        rows.append(cdf.to(torch.int32).permute(2, 0, 1, 3).reshape(
            hi - lo, h * w, s + 1))
    symbols = None if y_hat is None else (
        y_hat[0].to(torch.int32) + minmax).reshape(m, h * w)
    return torch.cat(rows), symbols


def _bucket_minmax(v) -> int:
    """The grid's half-width: max(v, 1) rounded up to a multiple of 8."""
    v = max(int(v), 1)
    return ((v + 7) // 8) * 8


def nonzero_channels(y_np: np.ndarray) -> np.ndarray:
    """(M,) uint8 flags of the channels of a (M, h, w) latent that hold a
    nonzero symbol."""
    return (np.abs(y_np).sum(axis=(1, 2)) > 0).astype(np.uint8)


def write_header(size, eyes, h_np=None) -> bytes:
    """The reference header: u16 H, W, then per eye u16 len(z), u16
    minmax, the packed nonzero-channel bitmap and the z string; then the
    homography as 9 float32 when one is given.  `eyes` is [(z string,
    minmax, flags)] x 2."""
    out = bytearray(np.array(size, np.uint16).tobytes())
    for z_str, minmax, flags in eyes:
        if len(z_str) > 0xFFFF or minmax > 0xFFFF:
            raise ValueError(f"a z string of {len(z_str)} bytes or minmax "
                             f"{minmax} does not fit the header's u16")
        out += np.array([len(z_str), minmax], np.uint16).tobytes()
        out += np.packbits(flags).tobytes()
        out += z_str
    if h_np is not None:
        out += np.asarray(h_np, np.float32).reshape(9).tobytes()
    return bytes(out)


def read_header(header: bytes, m: int, with_h: bool):
    """Inverse of write_header for M channels -> ((H, W), [(minmax,
    flags (M,), z string)] x 2, the (1, 3, 3) homography or None)."""
    size = tuple(int(v) for v in np.frombuffer(header, np.uint16, 2, 0))
    off, eyes = 4, []
    for _ in range(2):
        length, minmax = (int(v) for v in np.frombuffer(header, np.uint16,
                                                         2, off))
        off += 4
        flags = np.unpackbits(np.frombuffer(header, np.uint8, m // 8, off))
        off += m // 8
        eyes.append((minmax, flags, header[off:off + length]))
        off += length
    h_np = None
    if with_h:
        h_np = np.frombuffer(header, np.float32, 9, off).reshape(1, 3, 3)
        off += 36
    if off != len(header):
        raise ValueError(f"a header of {len(header)} bytes ends at byte "
                         f"{off}")
    return size, eyes, h_np


def write_files(header: bytes, body: bytes, output_name: str,
                output_path: str) -> None:
    for ext, data in (("npz", header), ("bin", body)):
        with open(os.path.join(output_path, f"{output_name}.{ext}"),
                  "wb") as f:
            f.write(data)


def read_files(output_name: str, output_path: str) -> tuple:
    out = []
    for ext in ("npz", "bin"):
        with open(os.path.join(output_path, f"{output_name}.{ext}"),
                  "rb") as f:
            out.append(f.read())
    return tuple(out)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


class ContainerCodec(CompressionModel):
    """The GMM container flow HESICCodec and DSICCodec share: z coded
    channel-major (the encoder decoding its own strings), y rounded
    without means and range-coded from the GMM heads' CDF rows.  Sets
    the determinism policy when built.  ``coder_s`` of a result is the
    wall time in the host range coder."""

    def __init__(self, model):
        super().__init__(model)
        deterministic_backends()

    def _z(self, name: str, z):
        """-> (the z string, z_hat (1, N, zh, zw) as the decoder sees
        it)."""
        strings = self.eb_compress(name, z)
        return strings[0], self.eb_decompress(name, strings, z.shape[2:])

    def _encode_eye(self, enc: RangeEncoder, gmm, y_hat) -> tuple:
        """Range-code one eye's y_hat (1, M, h, w) under the rows of its
        GMM heads -> (minmax, flags, coder seconds)."""
        y_np = y_hat[0].cpu().numpy()
        flags = nonzero_channels(y_np)
        minmax = _bucket_minmax(np.abs(y_np).max())
        rows, symbols = _gmm_cdf_rows(*gmm, y_hat, minmax, self.model.K)
        nz = np.flatnonzero(flags)
        if not nz.size:
            return minmax, flags, 0.0
        sel = torch.from_numpy(nz).to(rows.device)
        rows_np = rows[sel].reshape(-1, rows.shape[-1]).cpu().numpy()
        syms_np = symbols[sel].reshape(-1).cpu().numpy()
        t0 = time.perf_counter()
        enc.encode_rows(syms_np, rows_np)
        return minmax, flags, time.perf_counter() - t0

    def _decode_eye(self, dec: RangeDecoder, gmm, minmax: int, flags,
                    shape) -> tuple:
        """Inverse of _encode_eye -> (y_hat (1, M, h, w) float32 on the
        codec device, contiguous; coder seconds)."""
        m = self.model.M
        y_np = np.zeros((1, m, *shape), np.float32)
        nz = np.flatnonzero(flags)
        coder_s = 0.0
        if nz.size:
            rows, _ = _gmm_cdf_rows(*gmm, None, minmax, self.model.K)
            sel = torch.from_numpy(nz).to(rows.device)
            rows_np = rows[sel].reshape(-1, rows.shape[-1]).cpu().numpy()
            t0 = time.perf_counter()
            syms = dec.decode_rows(rows_np) - minmax
            coder_s = time.perf_counter() - t0
            y_np[0, nz] = syms.reshape(nz.size, *shape)
        return self._upload(y_np), coder_s


class HESICCodec(ContainerCodec):
    """HESIC's reference-layout codec (see the module docstring).  One
    pair per container: images (1, H, W, 3) float32 with H, W multiples of
    64, the homography (1, 3, 3)."""

    @torch.no_grad()
    def compress(self, x1, x2, h_matrix, output_name, output_path="") -> dict:
        """Code one pair into ``{output_name}.npz`` and ``.bin`` under
        `output_path`.  Returns {'bpp_real' (both files' bytes x 8 over
        both views' pixels), 'bpp_side' (the header's), 'enctime',
        'coder_s', 'y1_hat', 'y2_hat' (1, hy, wy, M), 'z1_hat', 'z2_hat'
        (1, zh, zw, N), 'strings': [header, body]}."""
        start = time.perf_counter()
        x1, x2 = self._to_device(x1), self._to_device(x2)
        if x1.shape[0] != 1:
            raise ValueError("the HESIC container codec takes one pair at "
                             "a time")
        h, h_np = self._homographies(h_matrix, 1)
        m = self.model
        size = tuple(x1.shape[2:])

        y1 = m.analysis1(x1)
        z1_str, z1_hat = self._z("entropy_bottleneck1",
                                 m.hyper_analysis1(y1))
        gmm1 = m.gmm1(z1_hat)
        y1_hat = torch.round(y1).contiguous()      # no means (quirk)
        x1_hat = m.synthesis1(y1_hat).contiguous()

        x1_warp = homography.warp_perspective(x1, h).contiguous()
        y2 = m.analysis2(x1_warp, x2)
        z2_str, z2_hat = self._z("entropy_bottleneck2",
                                 m.hyper_analysis2(y2))
        y1_prior = m.left_prior(x1_hat, h).contiguous()
        gmm2 = m.gmm2(z2_hat, y1_prior)
        y2_hat = torch.round(y2).contiguous()

        enc = RangeEncoder()
        mm1, flags1, c1 = self._encode_eye(enc, gmm1, y1_hat)
        mm2, flags2, c2 = self._encode_eye(enc, gmm2, y2_hat)
        t0 = time.perf_counter()
        body = enc.close()
        coder_s = c1 + c2 + time.perf_counter() - t0
        header = write_header(size, ((z1_str, mm1, flags1),
                                     (z2_str, mm2, flags2)), h_np[0])
        write_files(header, body, output_name, output_path)
        pixels = 2 * size[0] * size[1]
        return {"bpp_real": (len(header) + len(body)) * 8 / pixels,
                "bpp_side": len(header) * 8 / pixels,
                "enctime": time.perf_counter() - start, "coder_s": coder_s,
                "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
                "z1_hat": _nhwc(z1_hat), "z2_hat": _nhwc(z2_hat),
                "strings": [header, body]}

    def decompress(self, output_name, output_path="", h_matrix=None) -> dict:
        """Decode ``{output_name}.npz``/``.bin`` (see decompress_bytes)."""
        return self.decompress_bytes(*read_files(output_name, output_path),
                                     h_matrix=h_matrix)

    @torch.no_grad()
    def decompress_bytes(self, header: bytes, body: bytes,
                         h_matrix=None) -> dict:
        """-> {'x1_hat', 'x2_hat' (1, H, W, 3), 'y1_hat', 'y2_hat', 'z1_hat',
        'z2_hat', 'h_matrix' (1, 3, 3) numpy, 'dectime', 'coder_s'}.
        `h_matrix` overrides the header's homography."""
        start = time.perf_counter()
        m = self.model
        size, eyes, h_head = read_header(header, m.M, with_h=True)
        h, h_np = self._homographies(
            h_head if h_matrix is None else h_matrix, 1)
        y_shape = (size[0] // 16, size[1] // 16)
        z_shape = (y_shape[0] // 4, y_shape[1] // 4)
        z1_hat = self.eb_decompress("entropy_bottleneck1", [eyes[0][2]],
                                    z_shape)
        z2_hat = self.eb_decompress("entropy_bottleneck2", [eyes[1][2]],
                                    z_shape)
        dec = RangeDecoder(body)
        y1_hat, c1 = self._decode_eye(dec, m.gmm1(z1_hat), *eyes[0][:2],
                                      y_shape)
        x1_hat = m.synthesis1(y1_hat).contiguous()
        y1_prior = m.left_prior(x1_hat, h).contiguous()
        y2_hat, c2 = self._decode_eye(dec, m.gmm2(z2_hat, y1_prior),
                                      *eyes[1][:2], y_shape)
        x1_hat_warp = homography.warp_perspective(x1_hat, h).contiguous()
        x2_hat = m.synthesis2(y2_hat, x1_hat_warp)
        out = {"x1_hat": _nhwc(x1_hat), "x2_hat": _nhwc(x2_hat),
               "y1_hat": _nhwc(y1_hat), "y2_hat": _nhwc(y2_hat),
               "z1_hat": _nhwc(z1_hat), "z2_hat": _nhwc(z2_hat),
               "h_matrix": h_np}
        if x2_hat.is_cuda:
            torch.cuda.synchronize(x2_hat.device)
        out["dectime"] = time.perf_counter() - start
        out["coder_s"] = c1 + c2
        return out


class HESICTogetherCodec(TogetherCodec):
    """HESICTogether's codec: HESICCodec codes the pair, the cross-view
    enhancement runs after decoding."""

    inner_codec_cls = HESICCodec
