"""Carry a hesic_tpu (flax) parameter tree into the port's state_dict.

The inverse of hesic_tpu/utils/convert_torch.py's layout rules, applied to
a nested dict of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``; this module imports nothing of JAX):

  Conv, MaskedConv2d  HWIO (kh, kw, in, out) -> (out, in, kh, kw)
                      (1x1 kernels included)
  Deconv              HWIO, spatially flipped -> ConvTranspose2d
                      (in, out, kh, kw)
  Conv3D              DHWIO (kd, kh, kw, in, out) -> (out, in, kd, kh, kw)
  GroupNorm           scale -> weight, bias unchanged
  GDN     beta (C,), gamma (C, C)  -> unchanged
  EntropyBottleneck matrix_i/bias_i/factor_i/quantiles -> unchanged

The port's modules carry the flax module names (Conv_0, Deconv_3, h_s1_4,
context_prediction2, ...), so every path component maps as is.  Whether a
``kernel`` is a conv's or a deconv's is decided by the type of the port's
module at that path, never by its name: flax names list layers by their
index (``h_s1_0`` is a deconv, ``h_s1_4`` a conv).  A ``kernel`` or a
``scale`` whose port module is of no known type raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layers import Conv, Deconv, MaskedConv2d
from ..models.dsic import Conv3D, GroupNorm


def _kernel(module, path: str, v: np.ndarray) -> np.ndarray:
    if isinstance(module, Deconv):
        return np.flip(v.transpose(2, 3, 0, 1), (2, 3))
    if isinstance(module, (Conv, MaskedConv2d)):
        return v.transpose(3, 2, 0, 1)
    if isinstance(module, Conv3D):
        return v.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"flax kernel at {path!r} has no conv module of the "
                     f"port there (found {type(module).__name__})")


def hesic_from_jax(params_np: dict, model: torch.nn.Module) -> dict:
    """flax param tree (numpy leaves) -> state_dict (CPU tensors) for
    `model`, whose module types decide each kernel's layout."""
    modules = dict(model.named_modules())
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            p = path + (key,)
            if hasattr(val, "items"):
                walk(val, p)
                continue
            parent = ".".join(p[:-1])
            v = np.asarray(val, np.float32)
            if key == "kernel":
                key, v = "weight", _kernel(modules.get(parent), parent, v)
            elif key == "scale":
                if not isinstance(modules.get(parent), GroupNorm):
                    raise ValueError(
                        f"flax scale at {parent!r} has no GroupNorm of the "
                        f"port there (found "
                        f"{type(modules.get(parent)).__name__})")
                key = "weight"
            out[".".join(p[:-1] + (key,))] = torch.from_numpy(
                np.array(v, np.float32))

    if "params" in params_np:
        params_np = params_np["params"]
    walk(params_np, ())
    return out
