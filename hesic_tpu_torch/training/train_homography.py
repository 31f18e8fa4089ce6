"""Train the unsupervised deep homography network on stereo pairs, as
hesic_tpu/training/train_homography.py: one Adam, the photometric L1 loss
of the full left view warped onto the right patch (``homo_full1``,
``homo_img2``, ``corners`` of ``StereoImageFolder`` at 256x256 crops).
Writes ``homo_latest.pkl`` every epoch and ``homo_best.pkl`` at the best
mean loss, in the port's persistence format (module_class, config,
torch-layout params, epoch, loss), which ``train.make_homography_fn``
reads.

Usage: python -m hesic_tpu_torch.training.train_homography --dataset /data
    [--device cuda]

Epoch e shuffles with seed + e and crops with ``RandomState(seed + e)``;
dropout draws from a generator seeded seed + 1.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..datasets import StereoImageFolder, batch_iterator
from ..geometry.net import HomographyNet, photometric_loss
from ..utils.persist import params_of, write_pickle
from .train import to_device


def save_homography_net(net: HomographyNet, path: str, **extra) -> None:
    write_pickle(path, {"module_class": type(net).__name__,
                        "config": net.config(), "layout": "torch",
                        "params": params_of(net), **extra})


def main(argv=None) -> HomographyNet:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    net = HomographyNet(patch_size=128, device=args.device, seed=args.seed)
    ds = StereoImageFolder(args.dataset, "train", patch_size=(256, 256))
    opt = torch.optim.Adam(net.parameters(), lr=args.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=args.device).manual_seed(args.seed + 1)

    best = float("inf")
    for epoch in range(args.epochs):
        ds.rng = np.random.RandomState(args.seed + epoch)
        losses = []
        for batch in batch_iterator(ds, args.batch_size, shuffle=True,
                                    seed=args.seed + epoch):
            b = to_device(batch, args.device)
            opt.zero_grad(set_to_none=True)
            delta = net(b["homo_img1"], b["homo_img2"], training=True,
                        generator=gen)
            # the FULL left view is warped: content may enter the patch
            # from outside it
            loss = photometric_loss(delta, b["homo_full1"], b["homo_img2"],
                                    b["corners"])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if not losses:
            raise ValueError(f"{len(ds)} training pairs make no batch of "
                             f"{args.batch_size}")
        mean_loss = float(torch.stack(losses).mean())
        print(f"epoch {epoch}: photometric loss {mean_loss:.5f}")
        save_homography_net(net, os.path.join(args.checkpoint_dir,
                                              "homo_latest.pkl"),
                            epoch=epoch, loss=mean_loss)
        if mean_loss < best:
            best = mean_loss
            save_homography_net(net, os.path.join(args.checkpoint_dir,
                                                  "homo_best.pkl"),
                                epoch=epoch, loss=mean_loss)
    return net


if __name__ == "__main__":
    main()
