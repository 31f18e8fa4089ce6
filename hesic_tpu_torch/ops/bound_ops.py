"""Bounds with the gradient gates of the JAX package
(hesic_tpu/ops/bound_ops.py): ``lower_bound`` is ``max(x, bound)`` whose
gradient passes through iff the input is at or above the bound or the
gradient pushes the output upward; ``upper_bound`` is ``min(x, bound)``
with the mirrored gate (at or below the bound, or the gradient pushes
the output downward).  ``lower_bound(x, bound, reduce)`` decides its gate
by the sign of ``reduce(cotangent)`` (a parameter's bound under a data
split: the global batch's cotangent) and passes the rank's own."""

from __future__ import annotations

import torch


class LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float, reduce=None):
        ctx.save_for_backward(x)
        ctx.bound, ctx.reduce = bound, reduce
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        decide = g if ctx.reduce is None else ctx.reduce(g)
        pass_through = (x >= ctx.bound) | (decide < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None, None


def lower_bound(x: torch.Tensor, bound: float, reduce=None) -> torch.Tensor:
    return LowerBound.apply(x, bound, reduce)


class UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return UpperBound.apply(x, bound)
