"""Lower bound with the gradient gate of the JAX package
(hesic_tpu/ops/bound_ops.py): ``max(x, bound)`` whose gradient passes
through iff the input is above the bound or the gradient pushes the output
upward."""

from __future__ import annotations

import torch


class LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return LowerBound.apply(x, bound)
