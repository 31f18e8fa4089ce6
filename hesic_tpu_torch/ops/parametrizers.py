"""Non-negative reparameterization (sqrt-space with pedestal), as
hesic_tpu/ops/parametrizers.py.  Under a data split its bound's gate
decides by the global batch's cotangent (ops.data_split)."""

from __future__ import annotations

import torch

from .bound_ops import lower_bound
from .ops import split_reduce

_REPARAM_OFFSET = 2 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2


def nonneg_init(x: torch.Tensor) -> torch.Tensor:
    """Map an initial non-negative value into sqrt-space."""
    return torch.sqrt(torch.clamp_min(x + _PEDESTAL, _PEDESTAL))


def nonneg_apply(x: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Map a sqrt-space parameter back to a >= minimum value."""
    bound = (minimum + _PEDESTAL) ** 0.5
    out = lower_bound(x, bound, split_reduce())
    return out * out - _PEDESTAL
