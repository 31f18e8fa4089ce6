"""Bound operators, non-negative reparameterization and quantization."""

from .bound_ops import lower_bound, upper_bound
from .ops import (quantize, quantize_dequantize, quantize_noise,
                  quantize_symbols, ste_round)
from .parametrizers import nonneg_apply, nonneg_init

__all__ = ["lower_bound", "nonneg_apply", "nonneg_init", "quantize",
           "quantize_dequantize", "quantize_noise", "quantize_symbols",
           "ste_round", "upper_bound"]
