"""The CompressAI prior models, NCHW: bmshj2018-factorized
(``FactorizedPrior``), bmshj2018-hyperprior (``ScaleHyperprior``),
mbt2018-mean (``MeanScaleHyperprior``) and mbt2018
(``JointAutoregressiveHierarchicalPriors``).

Counterpart of hesic_tpu/models/priors.py.  Single-image models: the
factorized prior codes y through an EntropyBottleneck; the hyperpriors
code z through one and y through a Gaussian whose scale (and, for
mbt2018-mean, mean) comes from the hyper-synthesis ``h_s``; mbt2018 also
mixes in a masked 5x5 context conv over the already-decoded latents
through a 1x1 entropy-parameter stack.  The training forward runs the
context conv over the whole latent at once; mbt2018's sequential codecs
are the wavefront device codec (models/ar_device.py
``JointAutoregressiveDeviceCodec``) and the host AR codec
(models/codec.py ``JointAutoregressiveCodec``), the hyperpriors' codecs
are in models/codec.py too.

flax names the layers of a list attribute by their index in the list,
activations counted (``g_a_1`` is a GDN, ``h_a_2`` the second conv); the
port registers them under the same names, so state_dict keys map one to
one onto the JAX parameter tree (utils/from_jax.py).  Everything is
float32, as in the JAX models.  Two quirks of the JAX models (and of
CompressAI) are kept: ``ScaleHyperprior.hyper_analysis`` takes |y| and
its ``h_s`` ends in a ReLU; ``MeanScaleHyperprior``'s takes y as it is,
and its ``h_s`` ends without an activation and splits (scales, means) on
the channel axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy_models import EntropyBottleneck, GaussianConditional
from ..layers import GDN, Conv, Deconv, MaskedConv2d
from ..ops import quantize

# a flax list's activation slots: relu, and leaky_relu with flax's slope
RELU, LEAKY = "relu", "leaky"
_ACTIVATIONS = {RELU: F.relu, LEAKY: lambda x: F.leaky_relu(x, 0.01)}


class _ListStacks(nn.Module):
    """A single-image model whose transforms are flax list stacks: layers
    registered as ``{prefix}_{i}``, activation slots counted in i but
    holding no module.  Parameters are drawn on the CPU from the
    constructor's generator (layer by layer, in declaration order), then
    moved to the device with gradients off (``training.make_optimizer``
    turns them on for what it trains)."""

    entropy_bottlenecks = ("entropy_bottleneck",)
    gaussian_conditionals: tuple = ()
    single_image = True
    uses_homography = False

    def _register(self, stacks: dict) -> None:
        self.acts = {}
        for prefix, layers in stacks.items():
            self.acts[prefix] = []
            for i, layer in enumerate(layers):
                if isinstance(layer, str):
                    self.acts[prefix].append(_ACTIVATIONS[layer])
                else:
                    self.acts[prefix].append(None)
                    self.add_module(f"{prefix}_{i}", layer)

    def _finish(self, device) -> None:
        self.to(device)
        self.requires_grad_(False)

    def _stack(self, prefix: str, x):
        """Apply a flax list stack in order."""
        for i, act in enumerate(self.acts[prefix]):
            x = act(x) if act is not None else getattr(
                self, f"{prefix}_{i}")(x)
        return x

    def analysis(self, x):
        return self._stack("g_a", x)

    def synthesis(self, y_hat):
        return self._stack("g_s", y_hat)

    def hyper_analysis(self, y):
        return self._stack("h_a", y)

    def hyper_synthesis(self, z_hat):
        return self._stack("h_s", z_hat)

    def eb_medians(self) -> dict:
        """{"entropy_bottleneck": its (C,) medians}, the JAX modules'
        method."""
        return {"entropy_bottleneck": self.entropy_bottleneck.medians()}

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.loss()


def _g_stacks(n: int, m: int, g) -> dict:
    """The analysis and synthesis transforms every prior shares."""
    return {"g_a": [Conv(3, n, generator=g), GDN(n),
                    Conv(n, n, generator=g), GDN(n),
                    Conv(n, n, generator=g), GDN(n),
                    Conv(n, m, generator=g)],
            "g_s": [Deconv(m, n, generator=g), GDN(n, inverse=True),
                    Deconv(n, n, generator=g), GDN(n, inverse=True),
                    Deconv(n, n, generator=g), GDN(n, inverse=True),
                    Deconv(n, 3, generator=g)]}


def _mean_scale_hyper(n: int, m: int, g) -> dict:
    """mbt2018's (and mbt2018-mean's) hyper transforms: h_s ends in 2M
    channels, (scales, means)."""
    return {"h_a": [Conv(m, n, kernel_size=3, stride=1, generator=g), LEAKY,
                    Conv(n, n, generator=g), LEAKY, Conv(n, n, generator=g)],
            "h_s": [Deconv(n, m, generator=g), LEAKY,
                    Deconv(m, m * 3 // 2, generator=g), LEAKY,
                    Conv(m * 3 // 2, m * 2, kernel_size=3, stride=1,
                         generator=g)]}


class FactorizedPrior(_ListStacks):
    """bmshj2018-factorized, N=128, M=192 by default: y through an
    EntropyBottleneck of M channels."""

    def __init__(self, N: int = 128, M: int = 192, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.N, self.M = N, M
        g = torch.Generator().manual_seed(seed)
        self._register(_g_stacks(N, M, g))
        self.entropy_bottleneck = EntropyBottleneck(M, generator=g)
        self._finish(device)

    def forward(self, x, training: bool = False, generator=None):
        """x (B, 3, H, W) float32 -> {"x_hat", "likelihoods": {"y"}}.
        Training draws the bottleneck's noise from `generator`; eval
        rounds about the medians."""
        y = self.analysis(x)
        y_hat, y_lik = self.entropy_bottleneck(y, training, generator)
        return {"x_hat": self.synthesis(y_hat), "likelihoods": {"y": y_lik}}


class ScaleHyperprior(_ListStacks):
    """bmshj2018-hyperprior, N=128, M=192 by default: z through an
    EntropyBottleneck of N channels, y through a zero-mean Gaussian whose
    scale is ``h_s(z_hat)``."""

    gaussian_conditionals = ("gaussian_conditional",)

    def __init__(self, N: int = 128, M: int = 192, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.N, self.M = N, M
        g = torch.Generator().manual_seed(seed)
        self._register({**_g_stacks(N, M, g), **self._hyper(N, M, g)})
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional = GaussianConditional()
        self._finish(device)

    @staticmethod
    def _hyper(n: int, m: int, g) -> dict:
        return {"h_a": [Conv(m, n, kernel_size=3, stride=1, generator=g),
                        RELU, Conv(n, n, generator=g), RELU,
                        Conv(n, n, generator=g)],
                "h_s": [Deconv(n, n, generator=g), RELU,
                        Deconv(n, n, generator=g), RELU,
                        Conv(n, m, kernel_size=3, stride=1, generator=g),
                        RELU]}

    def hyper_analysis(self, y):
        return self._stack("h_a", torch.abs(y))

    def gaussian_params(self, z_hat):
        """-> (scales, means or None) of y's Gaussian, from z_hat."""
        return self.hyper_synthesis(z_hat), None

    def forward(self, x, training: bool = False, generator=None):
        """x (B, 3, H, W) float32 -> {"x_hat", "likelihoods": {"y", "z"}}.
        Training draws the noise of z in the bottleneck, then of y in the
        Gaussian conditional, from `generator` (the JAX package's order);
        eval rounds (y about the means)."""
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        z_hat, z_lik = self.entropy_bottleneck(z, training, generator)
        scales, means = self.gaussian_params(z_hat)
        y_hat, y_lik = self.gaussian_conditional(y, scales, means, training,
                                                 generator)
        return {"x_hat": self.synthesis(y_hat),
                "likelihoods": {"y": y_lik, "z": z_lik}}


class MeanScaleHyperprior(ScaleHyperprior):
    """mbt2018-mean, N=128, M=192 by default: ScaleHyperprior with
    leaky-ReLU hyper transforms over y itself (no |y|), whose h_s gives
    the Gaussian's scale and mean."""

    @staticmethod
    def _hyper(n: int, m: int, g) -> dict:
        return _mean_scale_hyper(n, m, g)

    def hyper_analysis(self, y):
        return self._stack("h_a", y)

    def gaussian_params(self, z_hat):
        scales, means = self.hyper_synthesis(z_hat).chunk(2, dim=1)
        return scales, means


class JointAutoregressiveHierarchicalPriors(_ListStacks):
    """mbt2018, N=192, M=192 by default."""

    gaussian_conditionals = ("gaussian_conditional",)

    def __init__(self, N: int = 192, M: int = 192, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.N, self.M = N, M
        g = torch.Generator().manual_seed(seed)
        stacks = {**_g_stacks(N, M, g), **_mean_scale_hyper(N, M, g)}
        stacks["entropy_parameters"] = [
            Conv(4 * M, M * 10 // 3, kernel_size=1, stride=1, generator=g),
            LEAKY,
            Conv(M * 10 // 3, M * 8 // 3, kernel_size=1, stride=1,
                 generator=g), LEAKY,
            Conv(M * 8 // 3, M * 2, kernel_size=1, stride=1, generator=g)]
        self._register(stacks)
        self.context_prediction = MaskedConv2d(M, 2 * M, kernel_size=5,
                                               mask_type="A", generator=g)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional = GaussianConditional()
        self._finish(device)

    # ---- codec-facing sub-programs beyond the shared ones ----

    def entropy_params(self, params_and_ctx):
        return self._stack("entropy_parameters", params_and_ctx)

    def context(self, y_hat):
        return self.context_prediction(y_hat)

    def forward(self, x, training: bool = False, generator=None):
        """x (B, 3, H, W) float32 -> {"x_hat", "likelihoods": {"y", "z"}},
        NCHW float32.

        Training draws the noise of three quantizations from `generator`,
        in the JAX package's order: z in the bottleneck, then y_hat, then
        the Gaussian conditional's own draw on y.  Eval rounds instead (y
        about the means in the conditional)."""
        y = self.analysis(x)
        z = self.hyper_analysis(y)
        z_hat, z_lik = self.entropy_bottleneck(z, training, generator)
        params = self.hyper_synthesis(z_hat)
        y_hat = quantize(y, "noise" if training else "dequantize",
                         generator=generator)
        ctx = self.context_prediction(y_hat)
        scales, means = self.entropy_params(
            torch.cat([params, ctx], dim=1)).chunk(2, dim=1)
        _, y_lik = self.gaussian_conditional(y, scales, means, training,
                                             generator)
        return {"x_hat": self.synthesis(y_hat),
                "likelihoods": {"y": y_lik, "z": z_lik}}
