"""Evaluate trained models on image folders with the real coder.

Counterpart of hesic_tpu/utils/eval_model.py (the reference's
``python -m compressai.utils.eval_model``): inputs replicate-padded to
multiples of 64, real compress/decompress timed, PSNR / MS-SSIM / bpp
reported as JSON, and an ``--entropy-estimation`` mode that sums the
likelihoods' bits instead of running the coder.  Stereo models follow
test3real's protocol: both eyes, bpp over 2*H*W.

Routes: entropy estimation through ``CompressionModel.forward``; a
single-image codec through ``compress(x)`` / ``decompress(strings,
shape)``; a stereo codec through its reference-layout files
(``compress(..., output_name, output_path)``, ``decompress(name,
path)``); ``--device-codec`` through the wavefront device codecs, built
over the codec's model and tables.  Encoding and decoding times
synchronise the device before the clock is read, so they time the work,
not its launch.  The stereo dataset's random draws (crop, the homography
net's patch) come from ``RandomState(0)``.

Usage: python -m hesic_tpu_torch.utils.eval_model --arch hesic \
           --checkpoint model.pkl --dataset /path [--entropy-estimation] \
           [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from ..datasets.stereo import ImageFolder, StereoImageFolder
from ..training.losses import bits
from ..zoo import create_model, is_stereo, uses_homography
from .metrics import ms_ssim, np_psnr


def pad_to_multiple(x: np.ndarray, m: int = 64):
    """Symmetric replicate-pad H, W of (B, H, W, C) to multiples of m
    (the reference pads to x64)."""
    _, h, w, _ = x.shape
    ph = (m - h % m) % m
    pw = (m - w % m) % m
    pads = ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
            (0, 0))
    return np.pad(x, pads, mode="edge"), (h, w, pads)


def unpad(x, meta):
    h, w, pads = meta
    return x[:, pads[1][0]: pads[1][0] + h, pads[2][0]: pads[2][0] + w, :]


def _host(t) -> np.ndarray:
    """A tensor (or array) as a float32 numpy array."""
    if torch.is_tensor(t):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _timed(device, fn, *args, **kwargs):
    """(fn's result, its wall seconds), the device synchronised before
    and after."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync()
    return out, time.perf_counter() - t0


def eval_single(codec, x: np.ndarray, entropy_estimation: bool) -> dict:
    xp, meta = pad_to_multiple(x)
    num_pixels = x.shape[1] * x.shape[2]
    if entropy_estimation:
        out = codec.forward(xp, training=False)
        bpp = float(sum(bits(lik) for lik in
                        out["likelihoods"].values())) / num_pixels
        x_hat = np.clip(_host(out["x_hat"]), 0, 1)
        enc_t = dec_t = 0.0
    else:
        comp, enc_t = _timed(codec.device, codec.compress, xp)
        rec, dec_t = _timed(codec.device, codec.decompress,
                            comp["strings"], comp["shape"])
        total_bytes = sum(
            len(group) if isinstance(group, (bytes, bytearray))
            else sum(len(s) for s in group)
            for group in comp["strings"])
        bpp = total_bytes * 8 / num_pixels
        x_hat = _host(rec["x_hat"])
    x_hat = unpad(x_hat, meta)
    return {
        "psnr": np_psnr(x, x_hat),
        "ms-ssim": float(ms_ssim(x, x_hat)),
        "bpp": bpp,
        "encoding_time": enc_t,
        "decoding_time": dec_t,
    }


def eval_stereo(codec, x1, x2, h_matrix, entropy_estimation: bool,
                with_h: bool, workdir: str, name: str,
                device_blob: bool = False) -> dict:
    """One pair through test3real's protocol: per-eye PSNR / MS-SSIM and
    their averages, bpp over 2*H*W, and in estimation mode the per-eye
    bpp1/bpp2 (each over H*W).

    ``device_blob``: the codec is a wavefront device codec (one blob in
    memory, ``compress(x1, x2, h)`` / ``decompress(strings)``) rather
    than the reference-layout files."""
    num_pixels = 2 * x1.shape[1] * x1.shape[2]
    eye_pixels = x1.shape[1] * x1.shape[2]
    args = (x1, x2) + ((h_matrix,) if with_h else ())
    extra = {}
    if entropy_estimation:
        out = codec.forward(*args, training=False)
        lik = out["likelihoods"]
        bpp = float(sum(bits(v) for v in lik.values())) / num_pixels
        if "y1" in lik:
            extra["bpp1"] = float(bits(lik["y1"])
                                  + bits(lik["z1"])) / eye_pixels
            extra["bpp2"] = float(bits(lik["y2"])
                                  + bits(lik["z2"])) / eye_pixels
        x1_hat, x2_hat = out["x1_hat"], out["x2_hat"]
        enc_t = dec_t = 0.0
    elif device_blob:
        comp, enc_t = _timed(codec.device, codec.compress, *args)
        rec, dec_t = _timed(codec.device, codec.decompress, comp["strings"])
        bpp = comp["bpp_real"]
        x1_hat, x2_hat = rec["x1_hat"], rec["x2_hat"]
    else:
        comp, enc_t = _timed(codec.device, codec.compress, *args,
                             output_name=name, output_path=workdir)
        rec, dec_t = _timed(codec.device, codec.decompress, name, workdir)
        bpp = comp["bpp_real"]
        x1_hat, x2_hat = rec["x1_hat"], rec["x2_hat"]
    x1_hat = np.clip(_host(x1_hat), 0, 1)
    x2_hat = np.clip(_host(x2_hat), 0, 1)
    psnr1 = np_psnr(x1, x1_hat)
    psnr2 = np_psnr(x2, x2_hat)
    ms1 = float(ms_ssim(x1, x1_hat))
    ms2 = float(ms_ssim(x2, x2_hat))
    return {"psnr": (psnr1 + psnr2) / 2, "psnr1": psnr1, "psnr2": psnr2,
            "ms-ssim": (ms1 + ms2) / 2, "ms-ssim1": ms1, "ms-ssim2": ms2,
            "bpp": bpp, **extra,
            "encoding_time": enc_t, "decoding_time": dec_t}


def _device_codec(parser, args, codec):
    """(the wavefront device codec over `codec`'s model and tables,
    whether it codes pairs into one blob)."""
    from ..models.ar_device import (HESICPlusDeviceCodec,
                                    JointAutoregressiveDeviceCodec)
    if args.arch == "hesic-plus":
        cls, blob = HESICPlusDeviceCodec, True
    elif args.arch in ("mbt2018", "cheng2020-anchor", "cheng2020-attn"):
        cls, blob = JointAutoregressiveDeviceCodec, False
    else:
        parser.error("--device-codec supports mbt2018, cheng2020-*, "
                     "and hesic-plus (hesic/dsic already default to "
                     "their fast device codecs)")
    return cls(codec.model).load_state_dict(codec.state_dict()), blob


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="test")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--quality", type=int, default=1)
    parser.add_argument("--entropy-estimation", action="store_true")
    parser.add_argument("--homography-net", default=None,
                        help="homography-net checkpoint: predict H per "
                        "pair instead of identity (test3real protocol)")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--workdir", default=tempfile.gettempdir(),
                        help="where the stereo containers are written")
    parser.add_argument("--output", default=None)
    parser.add_argument("--device-codec", action="store_true",
                        help="code AR y-latents with the wavefront device "
                        "codec (mbt2018 / cheng2020-* / hesic-plus; its "
                        "own stream format, one blob per batch)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.device_codec and args.entropy_estimation:
        parser.error("--device-codec runs the real coder; drop "
                     "--entropy-estimation")
    codec = create_model(args.arch, quality=args.quality,
                         checkpoint=args.checkpoint, device=args.device)
    if not args.entropy_estimation:
        codec.update()
    device_blob = False
    if args.device_codec:
        codec, device_blob = _device_codec(parser, args, codec)

    results = []
    if is_stereo(args.arch):
        with_h = uses_homography(args.arch)
        ds = StereoImageFolder(args.dataset, split=args.split,
                               patch_size=(512, 512), need_file_name=True,
                               rng=np.random.RandomState(0))
        identity = np.eye(3, dtype=np.float32)[None]
        homography_fn = None
        if args.homography_net is not None:
            from ..training.train import make_homography_fn, to_device
            item0 = ds[0]
            homography_fn = make_homography_fn(
                args.homography_net, item0["x1"].shape[:2], args.device)
        for i in range(len(ds)):
            if args.max_images and i >= args.max_images:
                break
            item = ds[i]
            if homography_fn is not None:
                batch = to_device({k: v[None] for k, v in item.items()
                                   if not isinstance(v, str)}, args.device)
                h = _host(homography_fn(batch))
            else:
                h = identity
            res = eval_stereo(codec, item["x1"][None], item["x2"][None],
                              h, args.entropy_estimation, with_h,
                              args.workdir, f"eval_{i}",
                              device_blob=device_blob)
            results.append(res)
            print(f"[{i}] {item.get('name', i)}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
    else:
        ds = ImageFolder(args.dataset, split=args.split)
        for i in range(len(ds)):
            if args.max_images and i >= args.max_images:
                break
            res = eval_single(codec, ds[i]["x"][None],
                              args.entropy_estimation)
            results.append(res)
            print(f"[{i}]: "
                  + " ".join(f"{k}={v:.4f}" for k, v in res.items()))

    summary = {
        "name": args.arch,
        "description": ("entropy estimation" if args.entropy_estimation
                        else "real coder"),
        "results": {
            k: float(np.mean([r[k] for r in results]))
            for k in results[0]
        } if results else {},
    }
    print(json.dumps(summary, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
