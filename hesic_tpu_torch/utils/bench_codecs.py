"""Traditional-codec benchmark harness.

Counterpart of hesic_tpu/utils/bench_codecs.py (the reference's
``python -m compressai.utils.bench``): a Codec base, Pillow's JPEG,
JPEG2000 and WebP, and wrappers of external binaries (BPG, HEVC/AV1
through ffmpeg, VTM, HM, TFCI) that activate where the binaries are
installed (``shutil.which``).  Metrics: RGB and Y PSNR, and RGB MS-SSIM
from ``utils.metrics`` on CPU tensors.  Host code throughout: PIL is
imported where an image is read or coded, and ``-j N`` runs a pool of N
``spawn`` processes that never touch CUDA (a forked child of a process
that has initialised CUDA cannot use it, and the metric is host work).

Usage: python -m hesic_tpu_torch.utils.bench_codecs jpeg --dataset DIR \
           [--qualities 50,75] [-j 2] [--output res.json]
"""

from __future__ import annotations

import argparse
import io
import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from .metrics import ms_ssim


def _load_rgb(path: str) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1], through PIL."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x) * 255 + 0.5, 0, 255).astype(np.uint8)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 full-range conversion (reference codecs.py:52-85)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b + 0.5
    return np.stack([y, cb, cr], axis=-1)


def compute_metrics(a: np.ndarray, b: np.ndarray) -> dict:
    def _psnr(x, y):
        mse = np.mean((x.astype(np.float64) - y.astype(np.float64)) ** 2)
        return float(10 * np.log10(1.0 / max(mse, 1e-12)))

    out = {"psnr-rgb": _psnr(a, b)}
    ya, yb = rgb_to_ycbcr(a), rgb_to_ycbcr(b)
    out["psnr-y"] = _psnr(ya[..., 0], yb[..., 0])
    out["ms-ssim-rgb"] = float(ms_ssim(torch.from_numpy(
        np.asarray(a, np.float32)[None]), torch.from_numpy(
            np.asarray(b, np.float32)[None])))
    return out


class Codec:
    """Base codec interface (reference codecs.py:145-177)."""

    fmt: str = ""
    quality_range = (1, 100)
    #: True where the quality knob is a QP/ratio: larger values mean
    #: MORE compression (lower bpp/psnr).  Mirrors the reference
    #: find_close `rev` flag (utils/find_close/__main__.py:24-50).
    quality_reversed = False

    @property
    def name(self):
        return type(self).__name__

    def encode(self, img: np.ndarray, quality: int) -> bytes:
        raise NotImplementedError

    def decode(self, blob: bytes) -> np.ndarray:
        raise NotImplementedError

    def run(self, path: str, quality: int) -> dict:
        img = _load_rgb(path)
        t0 = time.time()
        blob = self.encode(img, quality)
        enc_t = time.time() - t0
        t0 = time.time()
        rec = self.decode(blob)
        dec_t = time.time() - t0
        num_pixels = img.shape[0] * img.shape[1]
        out = compute_metrics(img, rec)
        out.update({
            "bpp": len(blob) * 8 / num_pixels,
            "encoding_time": enc_t,
            "decoding_time": dec_t,
        })
        return out


class PillowCodec(Codec):
    def encode(self, img, quality):
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(_to_uint8(img)).save(buf, format=self.fmt,
                                             quality=quality)
        return buf.getvalue()

    def decode(self, blob):
        from PIL import Image
        img = Image.open(io.BytesIO(blob)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0


class JPEG(PillowCodec):
    fmt = "JPEG"
    quality_range = (1, 95)


class JPEG2000(PillowCodec):
    """JPEG2000 via Pillow/OpenJPEG (reference codecs.py:237-266 wraps the
    opj binaries; Pillow's bindings expose the same encoder).  'quality'
    is the compression RATIO (reference -r flag semantics)."""

    fmt = "JPEG2000"
    quality_range = (1, 400)
    quality_reversed = True  # quality = compression ratio

    def encode(self, img, quality):
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(_to_uint8(img)).save(
            buf, format="JPEG2000", quality_mode="rates",
            quality_layers=[max(int(quality), 1)], irreversible=True)
        return buf.getvalue()


class WebP(PillowCodec):
    fmt = "WEBP"
    quality_range = (1, 100)


class BinaryCodec(Codec):
    """Wrapper for external encoder/decoder binaries
    (reference codecs.py:237-459)."""

    encode_bin = ""
    decode_bin = ""

    def available(self) -> bool:
        return (shutil.which(self.encode_bin) is not None
                and shutil.which(self.decode_bin) is not None)

    def _run(self, cmd: List[str]):
        subprocess.run(cmd, check=True, capture_output=True)


class BPG(BinaryCodec):
    """BPG (HEVC intra) via bpgenc/bpgdec."""

    encode_bin = "bpgenc"
    decode_bin = "bpgdec"
    quality_range = (0, 51)
    quality_reversed = True  # quality = QP

    def run(self, path: str, quality: int) -> dict:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            out_bpg = os.path.join(td, "out.bpg")
            out_png = os.path.join(td, "out.png")
            t0 = time.time()
            self._run([self.encode_bin, "-q", str(quality), "-o", out_bpg,
                       path])
            enc_t = time.time() - t0
            t0 = time.time()
            self._run([self.decode_bin, "-o", out_png, out_bpg])
            dec_t = time.time() - t0
            img = _load_rgb(path)
            rec = _load_rgb(out_png)
            num_pixels = img.shape[0] * img.shape[1]
            out = compute_metrics(img, rec)
            out.update({
                "bpp": os.path.getsize(out_bpg) * 8 / num_pixels,
                "encoding_time": enc_t,
                "decoding_time": dec_t,
            })
            return out


class _FFmpegVideoIntra(BinaryCodec):
    """Single-frame intra coding through ffmpeg (HEVC/AV1 etc.),
    standing in for the reference's VTM/HM/AV1 wrappers
    (codecs.py:460-856) when those reference binaries are absent."""

    encode_bin = "ffmpeg"
    decode_bin = "ffmpeg"
    vcodec = ""
    quality_flag = "-crf"
    quality_range = (0, 51)
    quality_reversed = True  # quality = CRF/QP

    def run(self, path: str, quality: int) -> dict:
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            out_vid = os.path.join(td, "out.mp4")
            out_png = os.path.join(td, "out.png")
            t0 = time.time()
            self._run(["ffmpeg", "-y", "-i", path, "-frames:v", "1",
                       "-c:v", self.vcodec, self.quality_flag,
                       str(quality), out_vid])
            enc_t = time.time() - t0
            t0 = time.time()
            self._run(["ffmpeg", "-y", "-i", out_vid, out_png])
            dec_t = time.time() - t0
            img = _load_rgb(path)
            rec = _load_rgb(out_png)
            num_pixels = img.shape[0] * img.shape[1]
            out = compute_metrics(img, rec)
            out.update({
                "bpp": os.path.getsize(out_vid) * 8 / num_pixels,
                "encoding_time": enc_t,
                "decoding_time": dec_t,
            })
            return out


class HEVC(_FFmpegVideoIntra):
    """HEVC (x265) intra — HM/VTM-class anchor."""

    vcodec = "libx265"


class AV1(_FFmpegVideoIntra):
    vcodec = "libaom-av1"
    quality_range = (0, 63)


def _rgb_to_ycbcr444_u8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] -> planar YCbCr 4:4:4 uint8."""
    ycc = _to_uint8(rgb_to_ycbcr(img))
    return np.ascontiguousarray(ycc.transpose(2, 0, 1))


def _ycbcr444_u8_to_rgb(planes: np.ndarray) -> np.ndarray:
    ycc = planes.transpose(1, 2, 0).astype(np.float32) / 255.0
    y, cb, cr = ycc[..., 0], ycc[..., 1] - 0.5, ycc[..., 2] - 0.5
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0, 1)


class _ReferenceSoftware(BinaryCodec):
    """HM/VTM-style reference-software wrapper (reference
    codecs.py:460-856): PNG -> planar YCbCr444 yuv -> EncoderApp with the
    intra cfg -> DecoderApp -> metrics.  The intra cfg path comes from the
    class env var (the reference takes it via --build-dir/--config)."""

    cfg_env = ""
    quality_range = (0, 51)
    quality_reversed = True  # quality = QP

    def _cfg(self) -> str:
        cfg = os.environ.get(self.cfg_env, "")
        if not cfg or not os.path.isfile(cfg):
            raise FileNotFoundError(
                f"set ${self.cfg_env} to the encoder intra cfg file")
        return cfg

    def run(self, path: str, quality: int) -> dict:  # pragma: no cover
        # (exercised only where the reference binaries are installed)
        import tempfile

        img = _load_rgb(path)
        h, w, _ = img.shape
        with tempfile.TemporaryDirectory() as td:
            yuv = os.path.join(td, "in.yuv")
            bit = os.path.join(td, "out.bin")
            rec = os.path.join(td, "rec.yuv")
            _rgb_to_ycbcr444_u8(img).tofile(yuv)
            t0 = time.time()
            self._run([
                shutil.which(self.encode_bin), "-c", self._cfg(),
                "-i", yuv, "-b", bit, "-o", "",
                "-wdt", str(w), "-hgt", str(h),
                "-q", str(quality), "-f", "1", "-fr", "1",
                "--InputChromaFormat=444", "--InputBitDepth=8",
                "--ConformanceWindowMode=1",
            ])
            enc_t = time.time() - t0
            t0 = time.time()
            self._run([shutil.which(self.decode_bin), "-b", bit, "-o", rec,
                       "-d", "8"])
            dec_t = time.time() - t0
            planes = np.fromfile(rec, np.uint8)[: 3 * h * w]
            out_img = _ycbcr444_u8_to_rgb(planes.reshape(3, h, w))
            size = os.path.getsize(bit)
        out = compute_metrics(img, out_img)
        out.update({"bpp": size * 8 / (h * w), "encoding_time": enc_t,
                    "decoding_time": dec_t})
        return out


class VTM(_ReferenceSoftware):
    """VVC VTM (EncoderApp/DecoderApp); cfg via $VTM_CFG."""

    encode_bin = "EncoderApp"
    decode_bin = "DecoderApp"
    cfg_env = "VTM_CFG"
    quality_range = (0, 63)


class HM(_ReferenceSoftware):
    """HEVC HM (TAppEncoder/TAppDecoder); cfg via $HM_CFG."""

    encode_bin = "TAppEncoder"
    decode_bin = "TAppDecoder"
    cfg_env = "HM_CFG"
    quality_range = (0, 51)


class TFCI(BinaryCodec):
    """tensorflow/compression `tfci.py` models (reference
    codecs.py:401-457).  Model + script path via env:
    $TFCI_PATH = tfci.py location, $TFCI_MODEL in
    {bmshj2018-factorized-mse, bmshj2018-hyperprior-mse,
    mbt2018-mean-mse} (quality 1-8 appended like the reference)."""

    quality_range = (1, 8)
    _models = ("bmshj2018-factorized-mse", "bmshj2018-hyperprior-mse",
               "mbt2018-mean-mse")

    def available(self) -> bool:
        return os.path.isfile(os.environ.get("TFCI_PATH", ""))

    def run(self, path: str, quality: int) -> dict:  # pragma: no cover
        # (exercised only where tensorflow-compression is installed)
        import sys
        import tempfile
        if not 1 <= quality <= 8:
            raise ValueError(f"invalid TFCI quality: {quality}")
        script = os.environ["TFCI_PATH"]
        model = os.environ.get("TFCI_MODEL", self._models[0])
        img = _load_rgb(path)
        with tempfile.TemporaryDirectory() as td:
            out_tfci = os.path.join(td, "out.tfci")
            out_png = out_tfci + ".png"
            t0 = time.time()
            self._run([sys.executable, script, "compress",
                       f"{model}-{quality:d}", path, out_tfci])
            enc_t = time.time() - t0
            t0 = time.time()
            self._run([sys.executable, script, "decompress", out_tfci,
                       out_png])
            dec_t = time.time() - t0
            rec = _load_rgb(out_png)
            size = os.path.getsize(out_tfci)
        num_pixels = img.shape[0] * img.shape[1]
        out = compute_metrics(img, rec)
        out.update({"bpp": size * 8 / num_pixels, "encoding_time": enc_t,
                    "decoding_time": dec_t})
        return out


CODECS = {"jpeg": JPEG, "jpeg2000": JPEG2000, "webp": WebP, "bpg": BPG,
          "hevc": HEVC, "av1": AV1, "vtm": VTM, "hm": HM, "tfci": TFCI}


def _host_only():
    """A pool worker's set-up: no CUDA device, one intra-op thread."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)


def _worker(task):
    codec_name, path, quality = task
    codec = CODECS[codec_name]()
    return quality, codec.run(path, quality)


def collect(codec_name: str, dataset: str, qualities, jobs: int = 1):
    paths = sorted(
        os.path.join(dataset, p) for p in os.listdir(dataset)
        if os.path.isfile(os.path.join(dataset, p)))
    tasks = [(codec_name, p, q) for q in qualities for p in paths]
    if jobs > 1:
        with mp.get_context("spawn").Pool(jobs,
                                          initializer=_host_only) as pool:
            results = pool.map(_worker, tasks)
    else:
        results = [_worker(t) for t in tasks]
    by_quality: dict = {}
    for q, res in results:
        by_quality.setdefault(q, []).append(res)
    out = {"name": codec_name, "results": {}}
    keys = next(iter(by_quality.values()))[0].keys()
    for k in keys:
        out["results"][k] = [
            float(np.mean([r[k] for r in by_quality[q]]))
            for q in sorted(by_quality)
        ]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("codec", choices=sorted(CODECS))
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--qualities", type=str, default="75")
    parser.add_argument("-j", "--jobs", type=int, default=1)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    qualities = [int(q) for q in args.qualities.split(",")]
    codec = CODECS[args.codec]()
    if isinstance(codec, BinaryCodec) and not codec.available():
        print(f"binary for '{args.codec}' not found", file=sys.stderr)
        return 1
    result = collect(args.codec, args.dataset, qualities, args.jobs)
    print(json.dumps(result, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
