"""Single-image encode/decode CLI with a self-describing file header.

Counterpart of hesic_tpu/utils/codec_cli.py (the reference's
examples/codec.py).  File layout: the magic ``HTPU``, one writer byte
(17 = the card, 16 = the CPU twin: ``models.hesic_fast.writer_id``),
then the JAX package's layout: u8 model id, u8 metric and quality
nibbles, u16 H, W of the image, u16 the latent shape, u8 the group
count, and per group a u32 length and the string.  The host codecs'
strings decode exactly only on the device that computed their
conditioning, so the decoder refuses another writer's file (the JAX
package's files carry no writer byte and are refused too).  Images are
read and written as PNG by ``datasets.image_io``.

Usage:
  python -m hesic_tpu_torch.utils.codec_cli encode in.png -o out.bin \
      --arch bmshj2018-factorized --checkpoint model.pkl [--device cpu]
  python -m hesic_tpu_torch.utils.codec_cli decode out.bin -o rec.png \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import struct

import numpy as np

from ..datasets.image_io import read_png, write_png
from ..models.hesic_fast import WRITER_NAMES, writer_id
from ..zoo import create_model, model_architectures
from .eval_model import pad_to_multiple, unpad

_MAGIC = b"HTPU"
_ARCH_IDS = {name: i for i, name in
             enumerate(sorted(model_architectures))}
_ID_ARCHS = {i: name for name, i in _ARCH_IDS.items()}
_METRIC_IDS = {"mse": 0, "ms-ssim": 1}


def _write_header(f, device, arch: str, metric: str, quality: int, shape):
    f.write(_MAGIC + bytes([writer_id(device)]))
    code = (_METRIC_IDS[metric] << 4) | (quality & 0x0F)
    f.write(struct.pack("<BB", _ARCH_IDS[arch], code))
    f.write(struct.pack("<HH", shape[0], shape[1]))


def _read_header(f, device):
    if f.read(4) != _MAGIC:
        raise ValueError("invalid bitstream (bad magic)")
    tag, cur = f.read(1)[0], writer_id(device)
    if tag != cur:
        raise ValueError(
            f"bitstream written by "
            f"{WRITER_NAMES.get(tag, f'an unknown writer ({tag})')} but "
            f"this decoder runs {WRITER_NAMES[cur]}; decode it where it "
            f"was encoded")
    arch_id, code = struct.unpack("<BB", f.read(2))
    h, w = struct.unpack("<HH", f.read(4))
    metric = {v: k for k, v in _METRIC_IDS.items()}[code >> 4]
    return _ID_ARCHS[arch_id], metric, code & 0x0F, (h, w)


def encode(args) -> dict:
    img = read_png(args.input).astype(np.float32) / 255.0
    codec = create_model(args.arch, quality=args.quality,
                         checkpoint=args.checkpoint, device=args.device)
    codec.update()
    x, _ = pad_to_multiple(img[None])
    out = codec.compress(x)
    with open(args.output, "wb") as f:
        _write_header(f, args.device, args.arch, args.metric, args.quality,
                      img.shape[:2])
        shape = out["shape"]
        f.write(struct.pack("<HH", shape[0], shape[1]))
        f.write(struct.pack("<B", len(out["strings"])))
        for group in out["strings"]:
            s = group[0]
            f.write(struct.pack("<I", len(s)) + s)
    bpp = sum(len(g[0]) for g in out["strings"]) * 8 / (
        img.shape[0] * img.shape[1])
    print(f"encoded {args.input} -> {args.output} ({bpp:.4f} bpp)")
    return out


def decode(args) -> dict:
    with open(args.input, "rb") as f:
        arch, metric, quality, (h, w) = _read_header(f, args.device)
        sh, sw = struct.unpack("<HH", f.read(4))
        (n_groups,) = struct.unpack("<B", f.read(1))
        strings = []
        for _ in range(n_groups):
            (length,) = struct.unpack("<I", f.read(4))
            strings.append([f.read(length)])
    codec = create_model(arch, quality=quality, checkpoint=args.checkpoint,
                         device=args.device)
    codec.update()
    rec = codec.decompress(strings, (sh, sw))
    _, meta = pad_to_multiple(np.zeros((1, h, w, 1), np.float32))
    x = unpad(rec["x_hat"].detach().float().cpu().numpy(), meta)[0]
    write_png(args.output,
              np.clip(x * 255 + 0.5, 0, 255).astype(np.uint8))
    print(f"decoded {args.input} -> {args.output} ({arch}, q{quality})")
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    enc = sub.add_parser("encode")
    enc.add_argument("input")
    enc.add_argument("-o", "--output", required=True)
    enc.add_argument("--arch", default="bmshj2018-factorized")
    enc.add_argument("--checkpoint", default=None)
    enc.add_argument("--metric", default="mse", choices=sorted(_METRIC_IDS))
    enc.add_argument("--quality", type=int, default=1)
    dec = sub.add_parser("decode")
    dec.add_argument("input")
    dec.add_argument("-o", "--output", required=True)
    dec.add_argument("--checkpoint", default=None)
    for p in (enc, dec):
        p.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return encode(args) if args.command == "encode" else decode(args)


if __name__ == "__main__":
    main()
