"""The benchmark's weights: drawn on the device from the configuration's
``weights_seed``, then calibrated by a frozen copy of the program's
calibration recipe, so that the latents and the coder's grids sit near
where a trained model puts them.  The weights are part of the
configuration, as a checkpoint would be: a run's ``--seed`` draws its
traffic, not its model, because weights drawn from it moved a cell's
rate by 3-8% from seed to seed.

Drawing.  Every convolution kernel is kaiming-normal (fan_in, gain
sqrt(2)) from one normal draw for the whole model; biases are zero; GDN,
GroupNorm and the entropy bottlenecks start at their published values,
and the bottlenecks' biases take one uniform U(-0.5, 0.5) draw.

Calibration (the recipe of the program's bench, held as data in the
configuration file's ``calibration``, its pairs' parameters under
``images``): `steps` Adam steps on one batch of `batch` pairs of `size`
x `size`; the rate-distortion loss lambda * 255^2 * (MSE1 + MSE2) +
bits / (B H W) plus the bottlenecks' quantile loss; Adam (0.9, 0.999,
eps 1e-8) at `lr` for the transforms and `aux_lr` for the bottlenecks.
It runs in float32 with TF32 off and PyTorch's deterministic algorithms,
so one configuration gives one set of weights.

Cache.  ``state`` keeps the calibrated weights in
``benchmark/_cache/``, keyed by a hash of the configuration's model
entries and of the files that make them, so only a checkout's first run
of a configuration calibrates.  That run calibrates in a child process
(``python3 benchmark/weights.py <configuration JSON> <device>``): the
deterministic algorithms need cuBLAS's workspace setting before its
first handle, and the child keeps it out of the process that runs the
program.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import pairs  # noqa: E402
from benchmark.reference.layers import (EntropyBottleneck,  # noqa: E402
                                        f32_backends, kaiming_modules)

CACHE = os.path.join(ROOT, "benchmark", "_cache")
MODEL_KEYS = ("name", "widths", "weights_seed", "calibration")

STREAM_WEIGHTS, STREAM_CALIBRATION = 1, 2


def draw(model: torch.nn.Module, seed: int) -> None:
    """Draw `model`'s weights in place from `seed`."""
    dev = next(model.parameters()).device
    gen = pairs.generator(seed, STREAM_WEIGHTS, dev)
    mods = kaiming_modules(model)
    z = torch.randn(sum(m.weight.numel() for m in mods), generator=gen,
                    device=dev)
    off = 0
    with torch.no_grad():
        for m in mods:
            n = m.weight.numel()
            m.weight.copy_(z[off:off + n].view_as(m.weight)
                           * math.sqrt(2.0 / m.fan_in))
            off += n
        biases = [getattr(eb, f"bias_{i}") for eb in model.modules()
                  if isinstance(eb, EntropyBottleneck) for i in range(5)]
        u = torch.rand(sum(b.numel() for b in biases), generator=gen,
                       device=dev) - 0.5
        off = 0
        for b in biases:
            b.copy_(u[off:off + b.numel()].view_as(b))
            off += b.numel()


def _is_aux(name: str) -> bool:
    return name.split(".")[0].startswith("entropy_bottleneck")


def calibrate(ref, model, recipe: dict, seed: int) -> list:
    """`recipe["steps"]` train steps of `model` (the reference module
    `ref`'s) on pairs made from `recipe["images"]` -> the steps' losses
    (a host list, read once at the end)."""
    dev = next(model.parameters()).device
    gen = pairs.generator(seed, STREAM_CALIBRATION, dev)
    hw, b = recipe["size"], recipe["batch"]
    x1, x2, h = pairs.make_pairs(b, hw, recipe["images"], gen, dev)
    named = list(model.named_parameters())
    opt = torch.optim.Adam(
        [{"params": [p for n, p in named if not _is_aux(n)],
          "lr": recipe["lr"]},
         {"params": [p for n, p in named if _is_aux(n)],
          "lr": recipe["aux_lr"]}], betas=(0.9, 0.999), eps=1e-8)
    ebs = [m for m in model.modules() if isinstance(m, EntropyBottleneck)]

    def noise(t):
        return torch.rand(t.shape, generator=gen, device=dev) - 0.5

    losses = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with torch.enable_grad(), f32_backends():
            for _ in range(recipe["steps"]):
                opt.zero_grad(set_to_none=True)
                x1_hat, x2_hat, liks = ref.train_forward(model, x1, x2, h,
                                                         noise)
                bpp = sum(torch.log(lk).sum() for lk in liks) \
                    / (-math.log(2) * b * hw * hw)
                mse = ((x1_hat - x1) ** 2).mean() + ((x2_hat - x2) ** 2).mean()
                loss = (recipe["lmbda"] * 255 ** 2 * mse + bpp
                        + sum(eb.loss() for eb in ebs))
                loss.backward()
                opt.step()
                losses.append(loss.detach())
    finally:
        torch.use_deterministic_algorithms(was)
    for p in model.parameters():
        p.requires_grad_(False)
    return torch.stack(losses).tolist()


def cache_path(cfg: dict) -> str:
    """Where the configuration's calibrated weights are kept: the hash
    covers its model entries and the files that draw and calibrate."""
    h = hashlib.sha256(json.dumps({k: cfg[k] for k in MODEL_KEYS},
                                  sort_keys=True).encode())
    for rel in (f"reference/{cfg['name']}.py", "reference/layers.py",
                "weights.py", "pairs.py"):
        with open(os.path.join(ROOT, "benchmark", rel), "rb") as f:
            h.update(f.read())
    return os.path.join(CACHE, f"{cfg['name']}-{h.hexdigest()[:16]}.pt")


def make(cfg: dict, device) -> dict:
    """Draw and calibrate the configuration's weights in this process ->
    host tensors by name."""
    from benchmark import run
    ref = run.load_file(f"benchmark/reference/{cfg['name']}.py")
    model = ref.build(cfg, torch.device(device))
    draw(model, cfg["weights_seed"])
    losses = calibrate(ref, model, cfg["calibration"], cfg["weights_seed"])
    print(f"calibration losses {losses[0]:.4f} -> {losses[-1]:.4f}",
          file=sys.stderr, flush=True)
    return {k: v.detach().to("cpu") for k, v in model.state_dict().items()}


def state(cfg: dict, device) -> dict:
    """The configuration's weights, host tensors by name: from the cache,
    or calibrated on `device` by a child process that fills it."""
    path = cache_path(cfg)
    if not os.path.exists(path):
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        json.dumps(cfg), str(device)], check=True, env=env,
                       cwd=ROOT)
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv) -> int:
    cfg, device = json.loads(argv[0]), argv[1]
    path = cache_path(cfg)
    os.makedirs(CACHE, exist_ok=True)
    part = path + ".part"
    torch.save(make(cfg, device), part)
    os.replace(part, path)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
