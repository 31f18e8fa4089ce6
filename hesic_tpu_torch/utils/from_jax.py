"""Carry a hesic_tpu (flax) parameter tree into the port's state_dict.

The inverse of hesic_tpu/utils/convert_torch.py's layout rules, applied to
a nested dict of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``; this module imports nothing of JAX):

  Conv, MaskedConv2d  HWIO (kh, kw, in, out) -> (out, in, kh, kw)
                      (1x1 kernels included)
  Deconv              HWIO, spatially flipped -> ConvTranspose2d
                      (in, out, kh, kw)
  Conv3D              DHWIO (kd, kh, kw, in, out) -> (out, in, kd, kh, kw)
  Dense               (in, out) -> nn.Linear (out, in)
  GroupNorm           scale -> weight, bias unchanged
  BatchNorm           scale -> BatchNorm2d weight, bias unchanged; the
                      ``batch_stats`` collection's mean/var ->
                      running_mean/running_var
  GDN     beta (C,), gamma (C, C)  -> unchanged
  EntropyBottleneck matrix_i/bias_i/factor_i/quantiles -> unchanged

The port's modules carry the flax module names (Conv_0, Deconv_3, h_s1_4,
context_prediction2, ...), so every path component maps as is.  Whether a
``kernel`` is a conv's or a deconv's is decided by the type of the port's
module at that path, never by its name: flax names list layers by their
index (``h_s1_0`` is a deconv, ``h_s1_4`` a conv).  A ``kernel`` or a
``scale`` (or batch statistic) whose port module is of no known type
raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..layers import Conv, Deconv, MaskedConv2d
from ..models.dsic import Conv3D, GroupNorm


def _kernel(module, path: str, v: np.ndarray) -> np.ndarray:
    if isinstance(module, Deconv):
        return np.flip(v.transpose(2, 3, 0, 1), (2, 3))
    if isinstance(module, (Conv, MaskedConv2d)):
        return v.transpose(3, 2, 0, 1)
    if isinstance(module, Conv3D):
        return v.transpose(4, 3, 0, 1, 2)
    if isinstance(module, nn.Linear):
        return v.T
    raise ValueError(f"flax kernel at {path!r} has no conv module of the "
                     f"port there (found {type(module).__name__})")


_STATS = {"mean": "running_mean", "var": "running_var"}


def _norm_key(module, path: str, key: str, stats: bool) -> str:
    want = nn.BatchNorm2d if stats else (GroupNorm, nn.BatchNorm2d)
    if not isinstance(module, want):
        raise ValueError(f"flax {key} at {path!r} has no "
                         f"{'' if stats else 'GroupNorm or '}BatchNorm of "
                         f"the port there (found {type(module).__name__})")
    return _STATS[key] if stats else "weight"


def hesic_from_jax(params_np: dict, model: torch.nn.Module) -> dict:
    """flax param tree (numpy leaves) -> state_dict (CPU tensors) for
    `model`, whose module types decide each kernel's layout.  A tree of
    collections ({"params": ..., "batch_stats": ...}) carries both."""
    modules = dict(model.named_modules())
    out = {}

    def walk(tree, path, stats):
        for key, val in tree.items():
            p = path + (key,)
            if hasattr(val, "items"):
                walk(val, p, stats)
                continue
            parent = ".".join(p[:-1])
            v = np.asarray(val, np.float32)
            if stats:
                key = _norm_key(modules.get(parent), parent, key, True)
            elif key == "kernel":
                key, v = "weight", _kernel(modules.get(parent), parent, v)
            elif key == "scale":
                key = _norm_key(modules.get(parent), parent, key, False)
            out[".".join(p[:-1] + (key,))] = torch.from_numpy(
                np.array(v, np.float32))

    if "params" in params_np:
        walk(params_np.get("batch_stats") or {}, (), True)
        params_np = params_np["params"]
    walk(params_np, (), False)
    return out
