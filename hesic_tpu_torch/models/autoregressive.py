"""The autoregressive weights of the wavefront codec, pulled from a model.

Counterpart of hesic_tpu/models/autoregressive.py (``ArWeights``,
``extract_ar_weights``) in the JAX package's layouts: the context kernel
HWIO (5, 5, M, 2M) with the causality mask applied, and the 1x1
entropy-parameter kernels as (Cin, Cout) matrices.  All float32 (the
wavefront computes its parameters in float32 whatever the transforms'
compute type).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .hesic_plus import stack_names


class ArWeights(NamedTuple):
    """Context + entropy-parameter weights."""

    ctx_kernel: torch.Tensor  # (5, 5, M, 2M), causality mask applied
    ctx_bias: torch.Tensor    # (2M,)
    ep_kernels: tuple         # three (Cin, Cout) 1x1 kernels
    ep_biases: tuple


def extract_ar_weights(model: torch.nn.Module,
                       ctx_name: str = "context_prediction",
                       ep_prefix: str = "entropy_parameters") -> ArWeights:
    """The autoregressive weights of `model`'s ``ctx_name`` masked conv
    and its three ``{ep_prefix}_{0,2,4}`` 1x1 convs."""
    ctx = getattr(model, ctx_name)
    eps = [getattr(model, n) for n in stack_names(ep_prefix)]
    return ArWeights(
        ctx_kernel=ctx.masked_weight().detach().float().permute(
            2, 3, 1, 0).contiguous(),
        ctx_bias=ctx.bias.detach().float().contiguous(),
        ep_kernels=tuple(e.weight.detach().float()[:, :, 0, 0].t()
                         .contiguous() for e in eps),
        ep_biases=tuple(e.bias.detach().float().contiguous() for e in eps),
    )
