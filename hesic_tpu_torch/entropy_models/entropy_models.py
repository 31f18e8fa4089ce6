"""EntropyBottleneck: the fully-factorized learned prior (Balle et al.
2018, appendix 6.1), as hesic_tpu/entropy_models/entropy_models.py.

This slice carries what the codec's ``update()`` needs: the parameters,
``_logits_cumulative``, ``medians`` and ``pmf_data`` (the PMF table the
z CDFs are quantized from).  The training forward waits for the training
slice.  Numerics stay float32; softplus is ``logaddexp(x, 0)``, the JAX
package's formulation.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, tail_mass: float = 1e-9,
                 init_scale: float = 10.0,
                 filters: Tuple[int, ...] = (3, 3, 3, 3), generator=None):
        super().__init__()
        self.channels, self.tail_mass = channels, tail_mass
        self.filters = tuple(filters)
        dims = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        c = channels
        for i in range(len(self.filters) + 1):
            init_v = math.log(math.expm1(1 / scale / dims[i + 1]))
            setattr(self, f"matrix_{i}", nn.Parameter(
                torch.full((c, dims[i + 1], dims[i]), init_v)))
            bias = torch.empty(c, dims[i + 1], 1)
            bias.uniform_(-0.5, 0.5, generator=generator)
            setattr(self, f"bias_{i}", nn.Parameter(bias))
            if i < len(self.filters):
                setattr(self, f"factor_{i}", nn.Parameter(
                    torch.zeros(c, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [[-init_scale, 0.0, init_scale]]).repeat(c, 1, 1))

    def medians(self) -> torch.Tensor:
        """(C,) per-channel medians (the z symbol offsets)."""
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, x: torch.Tensor) -> torch.Tensor:
        """x: (C, 1, N) -> logits of the cumulative at x, same shape."""
        logits = x.float()
        for i in range(len(self.filters) + 1):
            m = getattr(self, f"matrix_{i}")
            sp = torch.logaddexp(m, torch.zeros_like(m))
            logits = torch.matmul(sp, logits) + getattr(self, f"bias_{i}")
            if i < len(self.filters):
                f = getattr(self, f"factor_{i}")
                logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    @torch.no_grad()
    def pmf_data(self):
        """(pmf (C, L), tail_mass (C,), pmf_length (C,), offset (C,)) for
        the CDF tables, as the JAX package's ``pmf_data``."""
        q = self.quantiles
        medians = q[:, 0, 1]
        minima = torch.clamp_min(torch.ceil(medians - q[:, 0, 0]),
                                 0).to(torch.int32)
        maxima = torch.clamp_min(torch.ceil(q[:, 0, 2] - medians),
                                 0).to(torch.int32)
        pmf_start = medians - minima
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())
        samples = torch.arange(max_length, dtype=torch.float32,
                               device=q.device)
        samples = samples[None, :] + pmf_start[:, None, None]
        lower = self._logits_cumulative(samples - 0.5)
        upper = self._logits_cumulative(samples + 0.5)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper)
                        - torch.sigmoid(sign * lower))[:, 0, :]
        tail_mass = (torch.sigmoid(lower[:, 0, 0])
                     + torch.sigmoid(-upper[:, 0, -1]))
        return pmf, tail_mass, pmf_length, -minima
