"""Homography-net evaluation: corner error, timing, FLOPs, warp GIFs.

Counterpart of hesic_tpu/utils/eval_homography.py (the reference's udh
test3_f1.py and test3_time.py): over the synthetic test set it reports
MACE (the mean absolute corner error against the known perturbation),
the photometric loss, the forward's latency (CUDA events after a
warm-up on the card, the wall clock on the CPU), the parameter count and
the forward's FLOPs as ``torch.utils.flop_counter.FlopCounterMode``
counts them (PyTorch's count of the matmuls and convolutions; not
comparable to the JAX package's XLA cost analysis), and with
``--figures`` writes (input, warped) GIF pairs through PIL.  ``main``
returns the summary as a dict.

Usage:
    python -m hesic_tpu_torch.utils.eval_homography DATASET \
        [--checkpoint homo_best.pkl] [--n 5] [--rho 20] [--figures DIR] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


def _to_uint8(img) -> np.ndarray:
    """Un-normalise a (1, H, W) or (H, W, 1) grayscale map for a GIF."""
    from ..datasets.stereo import MEAN, STD
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    g = np.asarray(img).squeeze() * STD + MEAN
    return np.clip(g * 255.0, 0, 255).astype(np.uint8)


def save_gif(a, b, path: str):
    """A two-frame flip GIF (the reference's tensors_to_gif)."""
    from PIL import Image
    fa = Image.fromarray(_to_uint8(a))
    fb = Image.fromarray(_to_uint8(b))
    fa.save(path, save_all=True, append_images=[fb], duration=1000, loop=0)


def count_params(net: torch.nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())


def _nchw(a, device) -> torch.Tensor:
    """(H, W, C) numpy -> (1, C, H, W) float32 on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(
        2, 0, 1)[None].to(device)


def _forward_ms(net, a, b, reps: int) -> float:
    """Mean milliseconds of one forward after a warm-up."""
    net(a, b)
    if a.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            net(a, b)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        net(a, b)
    return (time.perf_counter() - t0) / reps * 1e3


@torch.no_grad()
def main(argv=None) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    from ..datasets.synthetic import SyntheticHomographyDataset
    from ..geometry.homography import (get_perspective_transform,
                                       warp_perspective)
    from ..geometry.net import HomographyNet, photometric_loss
    from ..training.train import load_homography_net

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", help="stereo dataset root (left/right dirs)")
    p.add_argument("--checkpoint", default="",
                   help="homo_best.pkl from train_homography (else a "
                   "fresh init)")
    p.add_argument("--n", type=int, default=5, help="samples to evaluate")
    p.add_argument("--rho", type=int, default=20)
    p.add_argument("--patch-size", type=int, default=128)
    p.add_argument("--figures", default="", help="write warp GIFs here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timing-reps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)

    if args.checkpoint:
        net = load_homography_net(args.checkpoint, device)
    else:
        print("no checkpoint given: evaluating a fresh init", file=sys.stderr)
        net = HomographyNet(patch_size=args.patch_size, device=device,
                            seed=args.seed)
    net.eval()
    ds = SyntheticHomographyDataset(
        args.dataset, "test", rho=args.rho,
        rng=np.random.RandomState(args.seed))

    sample = ds[0]
    pa = _nchw(sample["patch_a"], device)
    pb = _nchw(sample["patch_b"], device)
    with FlopCounterMode(display=False) as counter:
        net(pa, pb)
    flops = counter.get_total_flops()
    params = count_params(net)
    print(f"params: {params:,}   flops/forward (PyTorch FlopCounterMode): "
          f"{flops:,}")
    forward_ms = _forward_ms(net, pa, pb, args.timing_reps)
    print(f"forward latency: {forward_ms:.3f} ms")

    maces, photo = [], []
    n = min(args.n, len(ds))
    for i in range(n):
        s = ds[i]
        img_a = _nchw(s["img_a"], device)
        b = _nchw(s["patch_b"], device)
        corners = torch.from_numpy(s["corners"][None]).to(device)
        delta_hat = net(_nchw(s["patch_a"], device), b)
        delta_gt = torch.from_numpy(s["delta_gt"][None]).to(device)
        maces.append(float(torch.mean(torch.abs(delta_hat - delta_gt))))
        photo.append(float(photometric_loss(delta_hat, img_a, b, corners)))

        if args.figures:
            os.makedirs(args.figures, exist_ok=True)
            # warp(img_a, h^-1) beside img_b and patch_b, as the reference
            c0 = corners - corners[:, 0:1, :]
            h_inv = torch.linalg.inv(
                get_perspective_transform(c0, c0 + delta_hat))
            patch_b_hat = warp_perspective(
                img_a, h_inv, (args.patch_size, args.patch_size))
            img_b_hat = warp_perspective(img_a, h_inv)
            save_gif(s["img_a"], s["img_b"],
                     os.path.join(args.figures, f"input_{i}.gif"))
            save_gif(patch_b_hat[0], b[0],
                     os.path.join(args.figures, f"output_patch{i}.gif"))
            save_gif(img_b_hat[0], s["img_b"],
                     os.path.join(args.figures, f"output_{i}.gif"))

        print(f"[{i}] MACE {maces[-1]:.3f} px   photometric {photo[-1]:.4f}")

    summary = {"params": params, "flops": flops, "forward_ms": forward_ms,
               "mace": float(np.mean(maces)),
               "photometric": float(np.mean(photo)), "n": n}
    print(f"mean MACE over {n}: {summary['mace']:.3f} px   "
          f"mean photometric: {summary['photometric']:.4f}")
    return summary


if __name__ == "__main__":
    main()
