"""Carry a hesic_tpu (flax) parameter tree into the port's state_dict.

The inverse of hesic_tpu/utils/convert_torch.py's layout rules, applied to
a nested dict of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``; this module imports nothing of JAX):

  conv    HWIO (kh, kw, in, out)   -> (out, in, kh, kw)
  deconv  HWIO, spatially flipped  -> ConvTranspose2d (in, out, kh, kw)
  GDN     beta (C,), gamma (C, C)  -> unchanged
  EntropyBottleneck matrix_i/bias_i/factor_i/quantiles -> unchanged

The port's modules carry the flax module names (Conv_0, Deconv_3, ...),
so every other path component maps as is.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(path, value):
    parent, name = path[-2] if len(path) > 1 else "", path[-1]
    v = np.asarray(value, np.float32)
    if name == "kernel" and parent.startswith("Conv_"):
        return "weight", v.transpose(3, 2, 0, 1)
    if name == "kernel" and parent.startswith("Deconv_"):
        return "weight", np.flip(v.transpose(2, 3, 0, 1), (2, 3))
    return name, v


def hesic_from_jax(params_np: dict) -> dict:
    """flax param tree (numpy leaves) -> port state_dict (CPU tensors)."""
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            p = path + (key,)
            if hasattr(val, "items"):
                walk(val, p)
            else:
                name, arr = _leaf(p, val)
                out[".".join(p[:-1] + (name,))] = torch.from_numpy(
                    np.array(arr, np.float32))

    if "params" in params_np:
        params_np = params_np["params"]
    walk(params_np, ())
    return out
