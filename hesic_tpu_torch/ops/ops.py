"""Quantization ops, as hesic_tpu/ops/ops.py.

``quantize(x, "noise", generator=g)`` is the one place the port draws
training noise: U(-0.5, 0.5) from an explicit ``torch.Generator`` (on the
tensor's device), added in the input's dtype.

Under a data-parallel step (``data_split``), each rank holds a slice of
the global batch and must compute what one process computes on that
slice.  Two things in the port are not additive over the batch, and
read the split:

  * the noise: ``quantize_noise`` draws the global batch's noise (the
    one process draws on contiguous inputs, so in their logical order)
    and keeps the rank's part.  Every rank draws the same amount, so the
    ranks' generators stay in step with one another and with the one
    process's.  The port draws in two layouts: NCHW (batch axis 0; every
    call site but one) and the EntropyBottleneck's (C, 1, N) with N in
    (h, w, b) order, where the batch is the innermost axis and the
    rank's part is every position's [d*b, (d+1)*b) entries;
  * the gradient gate of a bound applied to a parameter (``nonneg_apply``
    of GDN's beta and gamma): it passes or stops the gradient by the sign
    of the cotangent, so it must see the global batch's cotangent, not
    the rank's (``split_reduce``: the mean over the data group, which
    the parallel step supplies).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_split = threading.local()


@contextlib.contextmanager
def data_split(rank: int, world: int, batch: int, reduce=None):
    """Within the block, this rank holds items [rank * batch, (rank + 1) *
    batch) of a global batch of `world` x `batch`: training noise is
    drawn for the global batch, and the parameter gates built in the
    block decide by ``reduce(cotangent)``, the cotangent's mean over the
    ranks (None: by the rank's own)."""
    prev = getattr(_split, "value", None)
    _split.value = (rank, world, batch, reduce)
    try:
        yield
    finally:
        _split.value = prev


def split_reduce():
    """The active data split's cotangent mean, or None."""
    value = getattr(_split, "value", None)
    return None if value is None else value[3]


def _empty_global(x: torch.Tensor, axis: int, world: int) -> torch.Tensor:
    """An empty contiguous tensor of x's shape with `axis` grown
    `world`-fold: the one process's ``empty_like`` of its contiguous
    input.  Another layout would draw in another order, so it raises."""
    if not x.is_contiguous():
        raise ValueError("noise under a data split needs a contiguous input")
    shape = list(x.shape)
    shape[axis] *= world
    return x.new_empty(shape)


def _split_noise(x: torch.Tensor, generator) -> torch.Tensor:
    """This rank's part of the global batch's U(-0.5, 0.5) draw."""
    rank, world, b, _ = _split.value
    if x.dim() == 4:                  # NCHW
        if x.shape[0] != b:
            raise ValueError(f"noise for a batch of {x.shape[0]} under a "
                             f"split of {b} a rank")
        full = _empty_global(x, 0, world).uniform_(-0.5, 0.5,
                                                   generator=generator)
        return full.narrow(0, rank * b, b)
    if x.dim() == 3 and x.shape[2] % b == 0:   # (C, 1, h*w*b)
        c, one, n = x.shape
        full = _empty_global(x, 2, world).uniform_(-0.5, 0.5,
                                                   generator=generator)
        part = full.view(c, one, n // b, world * b).narrow(3, rank * b, b)
        return part.reshape(c, one, n)
    raise ValueError(f"no batch layout for noise of shape {tuple(x.shape)}")


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with straight-through (identity) gradients."""
    return torch.round(x) - x.detach() + x


def quantize_noise(x: torch.Tensor, generator=None) -> torch.Tensor:
    """Additive U(-0.5, 0.5) noise, the training-time quantization
    surrogate (this rank's part of the global batch's under
    ``data_split``)."""
    if getattr(_split, "value", None) is not None:
        return x + _split_noise(x, generator)
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
