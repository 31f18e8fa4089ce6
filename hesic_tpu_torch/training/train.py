"""The training CLI for every model of the zoo, as
hesic_tpu/training/train.py:

  python -m hesic_tpu_torch.training.train --model hesic --dataset /data \
      --epochs 100 --lmbda 1e-2 [--homography-net homo.pkl] [--stage2] \
      [--bf16] [--device cuda]

One Adam over the main and aux groups (train_state.py); for the models
that take a homography, H comes from the frozen homography net, without
gradient, rescaled per axis from its 256 space to the patch; ``--stage2``
trains a Together model's enhancement ``m2`` alone (m1 stays out of
autograd and bit-unchanged); best-loss checkpointing with auto-resume
from ``checkpoint_best_loss.pkl``; ``model_latest.pkl`` in the codec
format after every epoch.  The log lines are the JAX package's.

Runs are reproducible from ``--seed``: epoch e shuffles with seed + e (as
the JAX package), and also crops with ``RandomState(seed + e)`` and draws
the training noise from a generator seeded seed + e, so a resumed epoch
sees what an uninterrupted one would; validation crops and noise are
seeded with ``--seed`` at every epoch.  (The JAX package crops from an
unseeded state and carries one noise key through the run.)
"""

from __future__ import annotations

import argparse
import inspect
import os
import time

import numpy as np
import torch

from ..datasets import ImageFolder, StereoImageFolder, batch_iterator
from ..geometry.homography import upscale_homography
from ..geometry.net import HomographyNet
from ..utils.persist import load_params, read_pickle
from ..zoo import create_model, is_stereo, model_architectures, \
    uses_homography
from . import losses
from .train_state import (load_checkpoint, make_optimizer, make_train_step,
                          save_checkpoint)

# the NHWC image keys of the datasets' items, moved to NCHW
_IMAGES = ("x", "x1", "x2", "homo_img1", "homo_img2", "homo_full1")


def to_device(batch: dict, device) -> dict:
    """A numpy batch on `device`: images (B, H, W, C) -> (B, C, H, W)
    float32, the rest as they are; lists (file names) dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k in _IMAGES:
            t = t.permute(0, 3, 1, 2)
        out[k] = t.contiguous().to(device)
    return out


def load_homography_net(path: str, device="cuda") -> HomographyNet:
    """A homography net from a file of the port (``config``, torch layout)
    or of the JAX package's trainer (a flax tree at the defaults)."""
    payload = read_pickle(path)
    net = HomographyNet(device=device, **(payload.get("config") or {}))
    load_params(net, payload)
    return net.requires_grad_(False)


def make_homography_fn(homo_checkpoint, patch_size, device="cuda"):
    """batch -> (B, 3, 3) homographies on `device`: the identity without
    a checkpoint, else the frozen net's H (its corners re-anchored at
    their own top-left, as it is trained), rescaled from 256 space to
    `patch_size` per axis, with no gradient."""
    if homo_checkpoint is None:
        return lambda batch: torch.eye(3, device=device).expand(
            batch["x1"].shape[0], 3, 3).contiguous()
    net = load_homography_net(homo_checkpoint, device)
    sh, sw = patch_size[0] / 256.0, patch_size[1] / 256.0

    @torch.no_grad()
    def fn(batch):
        corners = batch["corners"] - batch["corners"][:, 0:1, :]
        h = net.get_h(batch["homo_img1"], batch["homo_img2"], corners)
        return upscale_homography(h, sh, sw)

    return fn


def _freeze_codec(model) -> torch.nn.Module:
    """Stage 2: take m1 (the codec) out of autograd; returns m2, the
    module stage 2 trains."""
    model.m1.requires_grad_(False)
    return model.m2


def make_loss_fn(model_name: str, lmbda: float, stage2: bool = False):
    """loss_fn(model, batch, generator) -> (RD loss + aux loss, {"bpp",
    "mse", "aux"}): ``losses.make_loss_fn``'s branch for the model (single
    image, stereo, stereo with H), with the aux metric.  With `stage2`,
    m1 is out of autograd, so only m2 gets gradients."""
    rd_fn = losses.make_loss_fn(lmbda)
    stereo = is_stereo(model_name)

    def loss_fn(model, batch, generator):
        if model.single_image == stereo:
            raise ValueError(f"{model_name} is "
                             f"{'' if stereo else 'not '}stereo, the model "
                             f"{type(model).__name__} is the other kind")
        if stage2:
            _freeze_codec(model)
        loss, metrics = rd_fn(model, batch, generator)
        with torch.no_grad():
            aux = model.aux_loss()
        return loss, dict(metrics, aux=aux)

    return loss_fn


def _parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", required=True,
                        choices=sorted(model_architectures))
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--patch-size", type=int, default=256)
    parser.add_argument("--quality", type=int, default=1)
    parser.add_argument("--lmbda", type=float, default=1e-2)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--aux-learning-rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--homography-net", default=None,
                        help="frozen homography net checkpoint")
    parser.add_argument("--stage2", action="store_true",
                        help="freeze codec, train enhancement only")
    parser.add_argument("--checkpoint-dir", default="checkpoints")
    parser.add_argument("--log-file", default="train_log.txt")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--overrides", default=None,
                        help="architecture overrides, e.g. N=64,M=96")
    parser.add_argument("--bf16", action="store_true",
                        help="run the transform convs in bfloat16 "
                             "(parameters and the likelihoods stay "
                             "float32); models with a dtype argument only")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> dict:
    """Train; returns {"codec", "optimizer", "step", "epochs": one dict
    per epoch run (steps, data_s, step_s, val_s, save_s, val_loss)}.
    data_s is the host's time reading, cropping and uploading batches;
    step_s the rest of the training loop (homography net and steps),
    after a device sync."""
    parser = _parser()
    args = parser.parse_args(argv)
    overrides = {}
    if args.overrides:
        for kv in args.overrides.split(","):
            k, v = kv.split("=")
            overrides[k.strip()] = int(v)
    module_cls, _ = model_architectures[args.model]
    if args.bf16:
        if "dtype" not in inspect.signature(module_cls).parameters:
            parser.error(f"--bf16 is not supported by {args.model} "
                         f"(module has no dtype field)")
        overrides["dtype"] = torch.bfloat16
    if args.stage2 and not hasattr(module_cls, "enhance"):
        parser.error(f"--stage2 trains a Together model's m2; {args.model} "
                     f"has none")

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    patch = (args.patch_size, args.patch_size)
    device = args.device
    codec = create_model(args.model, quality=args.quality, seed=args.seed,
                         device=device, **overrides)
    model = codec.model
    opt = make_optimizer(_freeze_codec(model) if args.stage2 else model,
                         args.learning_rate, args.aux_learning_rate)
    best_loss, start_epoch, step_count = float("inf"), 0, 0

    resume = os.path.join(args.checkpoint_dir, "checkpoint_best_loss.pkl")
    if os.path.exists(resume):
        payload = load_checkpoint(resume, model, opt)
        best_loss = payload.get("loss", best_loss)
        start_epoch = payload.get("epoch", 0)
        step_count = payload.get("step", 0)
        print(f"resumed from {resume} (epoch {start_epoch})")

    stereo = is_stereo(args.model)
    homography_fn = (make_homography_fn(args.homography_net, patch, device)
                     if uses_homography(args.model) else None)
    folder = StereoImageFolder if stereo else ImageFolder
    train_ds = folder(args.dataset, "train", patch)
    test_ds = folder(args.dataset, "test", patch)

    step = make_train_step(model, opt, make_loss_fn(args.model, args.lmbda,
                                                    args.stage2))
    eval_loss_fn = make_loss_fn(args.model, args.lmbda, stage2=False)

    def prep(batch):
        batch = to_device(batch, device)
        if homography_fn is not None:
            batch["h"] = homography_fn(batch)
        return batch

    def log(msg):
        print(msg)
        with open(args.log_file, "a") as f:
            f.write(msg + "\n")

    history = []
    for epoch in range(start_epoch, args.epochs):
        t_epoch = time.perf_counter()
        train_ds.rng = np.random.RandomState(args.seed + epoch)
        gen = torch.Generator(device=device).manual_seed(args.seed + epoch)
        batches = batch_iterator(train_ds, args.batch_size, shuffle=True,
                                 seed=args.seed + epoch)
        data_s, steps = 0.0, 0
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            batch = to_device(batch, device)
            data_s += time.perf_counter() - t0
            if homography_fn is not None:
                batch["h"] = homography_fn(batch)
            metrics = step(batch, gen)
            if steps % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log(f"Train epoch {epoch}: [{steps * args.batch_size}/"
                    f"{len(train_ds)}] Loss: {m['loss']:.3f} | "
                    f"MSE: {m['mse']:.5f} | Bpp: {m['bpp']:.2f} | "
                    f"Aux: {m['aux']:.2f}")
            steps += 1
        step_count += steps
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t_val = time.perf_counter()
        train_s = t_val - t_epoch

        # validation: the training forward's noise, as the JAX package
        test_ds.rng = np.random.RandomState(args.seed)
        val_gen = torch.Generator(device=device).manual_seed(args.seed)
        totals, count = None, 0
        with torch.no_grad():
            for batch in batch_iterator(test_ds, 1, shuffle=False,
                                        drop_last=False):
                _, m = eval_loss_fn(model, prep(batch), val_gen)
                m = {k: float(v) for k, v in m.items()}
                totals = m if totals is None else {
                    k: totals[k] + m[k] for k in m}
                count += 1
        avg = {k: v / max(count, 1) for k, v in (totals or {}).items()}
        val_loss = (args.lmbda * 255 ** 2 * avg.get("mse", 0)
                    + avg.get("bpp", 0)) if avg else float("inf")
        mse = max(avg.get("mse", 1.0), 1e-12)
        psnr_db = float(losses.mse2psnr(mse / 2 if stereo else mse))
        log(f"Test epoch {epoch}: loss {val_loss:.4f} | "
            f"PSNR {psnr_db:.3f} dB | bpp "
            f"{avg.get('bpp', 0) / (2 if stereo else 1):.4f}")

        t_save = time.perf_counter()
        save_checkpoint(model, opt,
                        os.path.join(args.checkpoint_dir, "checkpoint.pkl"),
                        step_count, epoch=epoch + 1, loss=val_loss)
        if val_loss < best_loss:
            best_loss = val_loss
            save_checkpoint(model, opt, resume, step_count, epoch=epoch + 1,
                            loss=val_loss)
        # the codec format, for the zoo and the evaluation tools
        codec.save(os.path.join(args.checkpoint_dir, "model_latest.pkl"))
        history.append({"epoch": epoch, "steps": steps, "data_s": data_s,
                        "step_s": train_s - data_s,
                        "val_s": t_save - t_val,
                        "save_s": time.perf_counter() - t_save,
                        "val_loss": val_loss})
    return {"codec": codec, "optimizer": opt, "step": step_count,
            "epochs": history}


if __name__ == "__main__":
    main()
