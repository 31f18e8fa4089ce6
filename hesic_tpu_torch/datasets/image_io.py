"""Image I/O of the datasets, without PIL: a PNG reader and writer over
the standard library's zlib, and PIL's bilinear resize of 8-bit images.

``read_png`` decodes 8-bit, non-interlaced PNGs of colour types 0 (gray),
2 (RGB), 4 (gray + alpha) and 6 (RGBA), all five row filters, and returns
(H, W, 3) uint8 as PIL's ``convert("RGB")`` does (gray replicated, alpha
dropped); it raises on anything else.  ``write_png`` writes (H, W, 3)
uint8 as colour type 2 with filter 0 on every row.

``resize_bilinear`` is PIL's ``Image.resize(size, BILINEAR)`` of a uint8
image (Pillow's ``Resample.c``): the triangle filter widened by the
scale when reducing (antialiasing), its double coefficients normalised
per output pixel and rounded to 22-bit fixed point, then a horizontal
pass and a vertical pass, each accumulating in integers, rounding and
clipping to uint8.  It gives PIL's bytes.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        yield kind, data[pos + 8: pos + 8 + length]
        pos += 12 + length


def _paeth_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def _average_row(row: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        row[i] = (row[i] + ((a + prior[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        base = y * (stride + 1)
        kind = raw[base]
        row = np.frombuffer(raw, np.uint8, stride, base + 1)
        if kind == 0:
            cur = row
        elif kind == 1:       # Sub: a running sum along each channel
            cur = row.reshape(-1, bpp).cumsum(0, dtype=np.uint8).reshape(-1)
        elif kind == 2:       # Up
            cur = row + prior
        elif kind in (3, 4):  # Average, Paeth: serial along the row
            buf = bytearray(row.tobytes())
            (_average_row if kind == 3 else _paeth_row)(
                buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit, non-interlaced PNG of colour type
    0, 2, 4 or 6."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (the port reads PNG only)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace}); "
                         f"the reader takes 8-bit, non-interlaced colour "
                         f"types 0, 2, 4 and 6")
    ch = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * ch + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, want "
                         f"{h * (w * ch + 1)}")
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if ch in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an RGB PNG, filter 0 on every row."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


@functools.lru_cache(maxsize=16)
def _coefficients(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear filter, then
    normalize_coeffs_8bpc: (first input index (out,), fixed-point weights
    (out, ksize) int64)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for wgt in ws:
            ww += wgt
        for x, wgt in enumerate(ws):
            v = wgt / ww if ww != 0.0 else wgt
            kk[xx, x] = int((-0.5 if v < 0 else 0.5)
                            + v * (1 << _PRECISION_BITS))
        starts[xx] = xmin
    return starts, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8bpc resample along `axis` (0 rows, 1
    columns) of (H, W, C) uint8."""
    in_size = img.shape[axis]
    starts, kk = _coefficients(in_size, out_size)
    idx = np.minimum(starts[:, None] + np.arange(kk.shape[1]), in_size - 1)
    taps = np.take(img.astype(np.int64), idx, axis=axis)
    # taps: (out, ksize, W, C) for rows, (H, out, ksize, C) for columns
    w = kk[:, :, None, None] if axis == 0 else kk[None, :, :, None]
    acc = (taps * w).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize((w, h), Image.BILINEAR)`` of
    (H, W, C) uint8 -> (h, w, C) uint8; `size` is (h, w)."""
    out_h, out_w = size
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return img
