"""bench.py's training recipe: its smooth stereo pairs, a training batch
of them on a device, its optimizer and train step (RD loss at lambda
1e-2 plus the aux loss, Adam 1e-4 / 1e-3) with a seeded noise generator,
and its calibration runs (``calibrate`` for the stereo models,
``calibrate_single`` for mbt2018).  A calibration runs under the codecs'
determinism policy (``models.base.deterministic_backends``: deterministic
cuDNN, no benchmarking, no TF32), which it sets before its first step,
so its weights do not depend on which algorithms a process happened to
pick, or on whether a codec had been built before it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import deterministic_backends
from .losses import make_loss_fn
from .train_state import make_optimizer, make_train_step


def smooth_pairs(rng, batch: int, hw: int):
    """`batch` stereo pairs (B, hw, hw, 3) float32: a low-pass random field
    and a shifted copy as the second eye (the JAX bench's _smooth_pair)."""
    x1, x2 = [], []
    for _ in range(batch):
        base = (0.5 + 0.25 * rng.randn(hw // 16 + 2, hw // 16 + 2, 3)
                ).astype(np.float32)
        base = np.clip(base, 0, 1)
        base = np.repeat(np.repeat(base, 2, 0), 2, 1)
        idx = np.linspace(0, base.shape[0] - 1.001, hw)
        xi = idx.astype(np.int32)
        fi = (idx - xi).astype(np.float32)
        rows = (base[xi] * (1 - fi)[:, None, None]
                + base[xi + 1] * fi[:, None, None])
        up = (rows[:, xi] * (1 - fi)[None, :, None]
              + rows[:, xi + 1] * fi[None, :, None])
        x1.append(up)
        x2.append(np.roll(up, 3, axis=1) * 0.98 + 0.01)
    return (np.stack(x1).astype(np.float32),
            np.stack(x2).astype(np.float32))


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)


def train_batch(rng, batch: int, hw: int, device: str) -> dict:
    """A training batch of `batch` smooth pairs on `device`: {"x1", "x2"
    (batch, 3, hw, hw) float32, "h" identity homographies (batch, 3, 3)}."""
    x1, x2 = smooth_pairs(rng, batch, hw)
    return {"x1": _nchw(x1, device), "x2": _nchw(x2, device),
            "h": torch.eye(3, device=device).expand(batch, 3, 3).contiguous()}


def trainer(model):
    """``bench.py``'s training setup for `model` (any model of the port's
    training loss: HESIC, DSIC, HESIC+, mbt2018): its Adam
    (lr 1e-4, aux 1e-3), its train step on the RD loss at lambda 1e-2 plus
    the aux loss, and a noise generator on the model's device seeded 7.
    Returns (optimizer, step, generator)."""
    opt = make_optimizer(model, 1e-4, 1e-3)
    step = make_train_step(model, opt, make_loss_fn(1e-2))
    device = next(model.parameters()).device
    return opt, step, torch.Generator(device=device).manual_seed(7)


def calibrate(model, rng, steps: int = 60, hw: int = 256, batch: int = 4):
    """``bench.py``'s ``_calibrate``: `steps` train steps of `model` on one
    batch of `batch` smooth hw x hw pairs drawn from `rng` (identity H),
    so the codec's entropy code is sane before it is timed; HESIC, DSIC
    and HESIC+ alike.  Returns the steps' (losses, training bpps) as
    floats."""
    device = next(model.parameters()).device
    return _run(model, train_batch(rng, batch, hw, device), steps)


def calibrate_single(model, rng, steps: int = 60, hw: int = 256,
                     batch: int = 4):
    """``bench.py``'s ``_calibrate_single``: `steps` train steps of a
    single-image `model` (mbt2018) on the first eyes of `batch` smooth hw
    x hw pairs drawn from `rng` (the same draws as ``calibrate``'s).
    Returns the steps' (losses, training bpps) as floats."""
    device = next(model.parameters()).device
    x, _ = smooth_pairs(rng, batch, hw)
    return _run(model, {"x": _nchw(x, device)}, steps)


def _run(model, data: dict, steps: int):
    deterministic_backends()
    _, step, gen = trainer(model)
    metrics = [step(data, gen) for _ in range(steps)]
    return ([float(m["loss"]) for m in metrics],
            [float(m["bpp"]) for m in metrics])
