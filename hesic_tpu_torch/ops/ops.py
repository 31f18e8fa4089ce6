"""Quantization ops, as hesic_tpu/ops/ops.py.

``quantize(x, "noise", generator=g)`` is the one place the port draws
training noise: U(-0.5, 0.5) from an explicit ``torch.Generator`` (on the
tensor's device), added in the input's dtype.
"""

from __future__ import annotations

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with straight-through (identity) gradients."""
    return torch.round(x) - x.detach() + x


def quantize_noise(x: torch.Tensor, generator=None) -> torch.Tensor:
    """Additive U(-0.5, 0.5) noise, the training-time quantization
    surrogate."""
    noise = torch.empty_like(x).uniform_(-0.5, 0.5, generator=generator)
    return x + noise


def quantize_dequantize(x: torch.Tensor, means=None) -> torch.Tensor:
    """Hard rounding (optionally about `means`); the output stays float."""
    if means is not None:
        return torch.round(x - means) + means
    return torch.round(x)


def quantize_symbols(x: torch.Tensor, means=None) -> torch.Tensor:
    """Hard rounding to int32 symbols (optionally about `means`)."""
    if means is not None:
        x = x - means
    return torch.round(x).to(torch.int32)


def quantize(x: torch.Tensor, mode: str, *, means=None, generator=None):
    """Dispatch across the three quantization modes."""
    if mode == "noise":
        if generator is None:
            raise ValueError("noise mode requires a torch.Generator")
        return quantize_noise(x, generator)
    if mode == "dequantize":
        return quantize_dequantize(x, means)
    if mode == "symbols":
        return quantize_symbols(x, means)
    raise ValueError(f'Invalid quantization mode: "{mode}"')
