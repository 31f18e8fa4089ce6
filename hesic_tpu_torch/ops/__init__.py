"""Bound operators and non-negative reparameterization."""

from .bound_ops import lower_bound
from .parametrizers import nonneg_apply, nonneg_init

__all__ = ["lower_bound", "nonneg_apply", "nonneg_init"]
