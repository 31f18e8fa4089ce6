"""Entropy models, NCHW, as hesic_tpu/entropy_models/entropy_models.py.

``EntropyBottleneck`` is the fully-factorized learned prior (Balle et al.
2018, appendix 6.1): its forward (noise in training, rounding about the
medians in eval), the auxiliary ``loss`` that pulls the quantiles to the
tail-mass targets, and ``pmf_data`` (the PMF table the codec's z CDFs are
quantized from).  ``GaussianMixtureConditional`` is HESIC's K-component
mixture over the y latents.  Likelihoods are float32 (erfc near the
1e-9 bound underflows in bf16); softplus is ``logaddexp(x, 0)``, the JAX
package's formulation.  ``GaussianConditional`` is the single Gaussian
over the y latents of the autoregressive families (mbt2018, HESIC+).
The bottleneck's and the mixture's forwards run in a ``likelihoods``
span (utils/tracing.py) while a profiler records.

``gmm_pmf`` evaluates the mixture's PMF on a symbol grid, the
reference-layout codecs' per-pixel CDF rows; ``gmm_pmf_edges`` the same
PMF from S+1 shared CDF edges instead of 2S evaluations.  The Gaussian
conditional's host side: the scale table
(``get_scale_table``, float64 numpy), the scale-table indexes of a
scale tensor (``build_indexes``) and the per-scale PMFs the y CDF tables
are quantized from (``gaussian_pmf_data``, evaluated on the CPU in
float32 so the tables do not depend on the card).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops import lower_bound, quantize
from ..utils.tracing import span

LIKELIHOOD_BOUND = 1e-9    # every likelihood's floor, through lower_bound
SCALE_BOUND = 0.11         # the Gaussians' smallest scale

# the scale table of the host Gaussian coder (Balle's tensorflow
# compression examples): 64 scales, log-spaced over [0.11, 256]
SCALES_MIN = 0.11
SCALES_MAX = 256
SCALES_LEVELS = 64


def get_scale_table(minimum=SCALES_MIN, maximum=SCALES_MAX,
                    levels=SCALES_LEVELS) -> np.ndarray:
    """(levels,) float64 scales, log-spaced over [minimum, maximum]."""
    return np.exp(np.linspace(math.log(minimum), math.log(maximum), levels))


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """0.5 * erfc(-x / sqrt(2)): the standard normal CDF, in float32."""
    return 0.5 * torch.erfc(-(2 ** -0.5) * x.float())


def standardized_quantile(quantile: float) -> float:
    """Inverse standard normal CDF of a scalar, in float64 on the host:
    Acklam's rational approximation, then three Newton steps on
    0.5 * erfc(-x / sqrt(2)) - q."""
    q = float(quantile)
    if not 0.0 < q < 1.0:
        raise ValueError("quantile must be in (0, 1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    p_low = 0.02425
    if q < p_low:
        u = np.sqrt(-2 * np.log(q))
        x = (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
             + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    elif q > 1 - p_low:
        u = np.sqrt(-2 * np.log(1 - q))
        x = -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u
              + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    else:
        u = q - 0.5
        t = u * u
        x = (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4]) * t
             + a[5]) * u / (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t
                             + b[4]) * t + 1)
    for _ in range(3):
        phi = 0.5 * math.erfc(-x / math.sqrt(2))
        pdf = math.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)
        x -= (phi - q) / pdf
    return float(x)


def build_indexes(scales: torch.Tensor, scale_table,
                  scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """Each scale's bucket in the scale table: the number of entries of
    ``scale_table[:-1]`` (float32) below the scale bounded at
    `scale_bound`.  int32, the shape of `scales`, on its device."""
    table = torch.as_tensor(np.asarray(scale_table, np.float32),
                            device=scales.device)
    bounded = torch.clamp_min(scales.float(), scale_bound)
    return (bounded[..., None] > table[:-1]).sum(-1).to(torch.int32)


def gmm_pmf(samples, scales, means, weights, K: int,
            scale_bound: float = SCALE_BOUND) -> torch.Tensor:
    """The Gaussian mixture's PMF on a symbol grid, in float32 on the
    parameters' device, as the JAX package's ``gmm_pmf``.

    samples: (S,) grid values; scales, means, weights: (..., M*K)
    channels-last parameter maps (component k's channel m at k*M + m;
    weights may broadcast, e.g. (1, 1, 1, M*K)) -> (..., M, S): the sum
    over k of w * (Phi((0.5 - |s - mu|) / sigma) - Phi((-0.5 - |s - mu|)
    / sigma)), sigma bounded below at `scale_bound`, the components
    summed in order k = 0, 1, ..."""
    m = scales.shape[-1] // K
    s = torch.as_tensor(samples, dtype=torch.float32, device=scales.device)

    def slab(t):                                   # (..., M, K, 1)
        t = t.float()
        return t.reshape(*t.shape[:-1], K, m).transpose(-1, -2)[..., None]

    mu, w = slab(means), slab(weights)
    sc = torch.clamp_min(slab(scales), scale_bound)
    values = torch.abs(s - mu)                     # (..., M, K, S)
    terms = (standardized_cumulative((0.5 - values) / sc)
             - standardized_cumulative((-0.5 - values) / sc)) * w
    pmf = terms[..., 0, :]
    for k in range(1, K):
        pmf = pmf + terms[..., k, :]
    return pmf


def gmm_pmf_edges(samples, scales, means, weights, K: int,
                  scale_bound: float = SCALE_BOUND) -> torch.Tensor:
    """``gmm_pmf`` by CDF edge differences, as the JAX package's
    ``gmm_pmf_edges``: consecutive bins share an edge, so the S+1 edges
    s - 0.5 (and the last + 0.5) take S+1 cumulative evaluations where
    gmm_pmf takes 2S.  The same PMF up to float32 rounding."""
    m = scales.shape[-1] // K
    s = torch.as_tensor(samples, dtype=torch.float32, device=scales.device)
    edges = torch.cat([s - 0.5, s[-1:] + 0.5])    # (S+1,)

    def slab(t):                                   # (..., M, K, 1)
        t = t.float()
        return t.reshape(*t.shape[:-1], K, m).transpose(-1, -2)[..., None]

    mu, w = slab(means), slab(weights)
    sc = torch.clamp_min(slab(scales), scale_bound)
    cdf = standardized_cumulative((edges - mu) / sc)   # (..., M, K, S+1)
    terms = (cdf[..., 1:] - cdf[..., :-1]) * w
    pmf = terms[..., 0, :]
    for k in range(1, K):
        pmf = pmf + terms[..., k, :]
    return pmf


def gaussian_pmf_data(scale_table, tail_mass: float = 1e-9):
    """Per-scale PMFs over each scale's centred support [-c, c], c =
    ceil(scale * -quantile(tail_mass / 2)), for the y CDF tables: numpy
    (pmf (L, max_len) float32, tail (L,) float32, pmf_length (L,) int32,
    offset (L,) int32).  The PMFs are float32 CPU math (torch.erfc)."""
    scale_table = np.asarray(scale_table, np.float64)
    multiplier = -standardized_quantile(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())
    samples = torch.from_numpy(np.abs(
        np.arange(max_length, dtype=np.int32) - pmf_center[:, None]
    ).astype(np.float32))
    scales = torch.from_numpy(scale_table[:, None].astype(np.float32))
    upper = standardized_cumulative((0.5 - samples) / scales)
    lower = standardized_cumulative((-0.5 - samples) / scales)
    pmf = (upper - lower).numpy()
    tail = (2 * lower[:, 0]).numpy()
    return pmf, tail, pmf_length, -pmf_center


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

    @property
    def target(self) -> torch.Tensor:
        """The logits of tail_mass/2, 1/2 and 1 - tail_mass/2: (3,) float32
        on the quantiles' device, what ``loss`` pushes them to."""
        t = math.log(2 / self.tail_mass - 1)
        return torch.tensor([-t, 0.0, t], dtype=torch.float32,
                            device=self.quantiles.device)

    def medians(self) -> torch.Tensor:
        """(C,) per-channel medians (the z symbol offsets)."""
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, x: torch.Tensor,
                           stop_gradient: bool) -> torch.Tensor:
        """x: (C, 1, N) -> logits of the cumulative at x, same shape.
        With `stop_gradient` the density's parameters are detached."""

        def param(name):
            p = getattr(self, name)
            return p.detach() if stop_gradient else p

        logits = x.float()
        for i in range(len(self.filters) + 1):
            m = param(f"matrix_{i}")
            sp = torch.logaddexp(m, torch.zeros_like(m))
            logits = torch.matmul(sp, logits) + param(f"bias_{i}")
            if i < len(self.filters):
                f = param(f"factor_{i}")
                logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    def _likelihood(self, x: torch.Tensor) -> torch.Tensor:
        lower = self._logits_cumulative(x - 0.5, stop_gradient=False)
        upper = self._logits_cumulative(x + 0.5, stop_gradient=False)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))

    def loss(self) -> torch.Tensor:
        """Auxiliary loss pushing the quantiles to the tail-mass targets;
        its gradient reaches the quantiles only."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        return torch.sum(torch.abs(logits - self.target))

    def forward(self, x: torch.Tensor, training: bool = False,
                generator=None):
        """x: (B, C, H, W) -> (x_hat, likelihoods), both (B, C, H, W).
        Training adds U(-0.5, 0.5) noise drawn from `generator`; eval
        rounds about the medians.  The values are laid out (C, 1, N) with
        N in (h, w, b) order, as the JAX package lays them out, and are
        contiguous, so the noise is drawn in that order whatever h and w
        (at 1x1 the reshape alone would give a batch-major view)."""
        b, c, h, w = x.shape
        with span("likelihoods"):
            values = x.permute(1, 2, 3, 0).reshape(c, 1, -1).contiguous()
            if training:
                values = quantize(values, "noise", generator=generator)
            else:
                values = quantize(values, "dequantize",
                                  means=self.quantiles[:, :, 1:2])
            likelihood = lower_bound(self._likelihood(values),
                                     LIKELIHOOD_BOUND)

        def nchw(t):
            return t.reshape(c, h, w, b).permute(3, 0, 1, 2)

        return nchw(values), nchw(likelihood)

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
        lower = self._logits_cumulative(samples - 0.5, stop_gradient=True)
        upper = self._logits_cumulative(samples + 0.5, stop_gradient=True)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper)
                        - torch.sigmoid(sign * lower))[:, 0, :]
        tail_mass = (torch.sigmoid(lower[:, 0, 0])
                     + torch.sigmoid(-upper[:, 0, -1]))
        return pmf, tail_mass, pmf_length, -minima


class GaussianConditional(nn.Module):
    """Scale- (and mean-) conditioned Gaussian, the y entropy model of the
    autoregressive families.  Parameter-free.  Scales are bounded below at
    SCALE_BOUND and likelihoods at LIKELIHOOD_BOUND through
    ``lower_bound``; the likelihood is float32 whatever the inputs'
    dtype.  Training adds noise without the means; eval rounds about
    them.  The scale table and the host coder's tables are not here:
    ``CompressionModel.update`` builds them (``get_scale_table``,
    ``gaussian_pmf_data``), and the wavefront codec codes its own
    Gaussian intervals."""

    def _likelihood(self, inputs, scales, means=None):
        values = inputs - means if means is not None else inputs
        scales = lower_bound(scales.float(), SCALE_BOUND)
        values = torch.abs(values.float())
        upper = standardized_cumulative((0.5 - values) / scales)
        lower = standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def forward(self, inputs, scales, means=None, training: bool = False,
                generator=None):
        """inputs (B, M, h, w) -> (outputs, likelihoods), both that shape."""
        if training:
            outputs = quantize(inputs, "noise", generator=generator)
        else:
            outputs = quantize(inputs, "dequantize", means=means)
        return outputs, lower_bound(
            self._likelihood(outputs, scales, means), LIKELIHOOD_BOUND)


class GaussianMixtureConditional(nn.Module):
    """K-component Gaussian-mixture conditional, HESIC's y entropy model.

    Scales, means and weights carry M*K channels, K slabs of M (channel
    k*M + m); weights may be spatially pooled (B, M*K, 1, 1).  Scales are
    bounded below at SCALE_BOUND through ``lower_bound``; likelihoods are
    float32.  Quantization ignores the means (the reference's quirk, kept
    by the JAX package)."""

    def __init__(self, K: int = 5):
        super().__init__()
        self.K = K

    def _likelihood(self, inputs, scales, means, weights):
        m = inputs.shape[1]

        def slab(t):
            return t.float().reshape(t.shape[0], self.K, m, *t.shape[2:])

        x = inputs.float()[:, None]
        sc = lower_bound(slab(scales), SCALE_BOUND)
        values = torch.abs(x - slab(means))
        upper = standardized_cumulative((0.5 - values) / sc)
        lower = standardized_cumulative((-0.5 - values) / sc)
        return torch.sum((upper - lower) * slab(weights), dim=1)

    def forward(self, inputs, scales, means, weights, training: bool = False,
                generator=None):
        """inputs (B, M, h, w) -> (outputs, likelihoods), both that shape."""
        with span("likelihoods"):
            if training:
                outputs = quantize(inputs, "noise", generator=generator)
            else:
                outputs = quantize(inputs, "dequantize")
            return outputs, lower_bound(
                self._likelihood(outputs, scales, means, weights),
                LIKELIHOOD_BOUND)
