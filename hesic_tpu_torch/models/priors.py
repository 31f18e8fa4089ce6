"""mbt2018: the joint autoregressive and hierarchical priors model, NCHW.

Counterpart of hesic_tpu/models/priors.py
(``JointAutoregressiveHierarchicalPriors``, Minnen et al. 2018): a
single-image model whose y latents are coded with a Gaussian whose scale
and mean come from the hyperprior (``h_s``) and a masked 5x5 context conv
over the already-decoded latents, mixed by a 1x1 entropy-parameter
stack.  The training forward runs the context conv over the whole latent
at once; the sequential codecs are the wavefront device codec
(models/ar_device.py ``JointAutoregressiveDeviceCodec``) and the host AR
codec (models/codec.py ``JointAutoregressiveCodec``).

flax names the layers of a list attribute by their index in the list,
activations counted (``g_a_1`` is a GDN, ``h_a_2`` the second conv); the
port registers them under the same names, so state_dict keys map one to
one onto the JAX parameter tree (utils/from_jax.py).  Everything is
float32, as in the JAX model.

Not carried over yet: the other priors of the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy_models import EntropyBottleneck, GaussianConditional
from ..layers import GDN, Conv, Deconv, MaskedConv2d
from ..ops import quantize

# a flax list's activation slot: leaky_relu with flax's slope 0.01
LEAKY = None


class JointAutoregressiveHierarchicalPriors(nn.Module):
    """mbt2018, N=192, M=192 by default.

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)``, moved to ``device`` and built with gradients off
    (``training.make_optimizer`` turns them on for what it trains)."""

    entropy_bottlenecks = ("entropy_bottleneck",)
    gaussian_conditionals = ("gaussian_conditional",)
    single_image = True
    uses_homography = False

    def __init__(self, N: int = 192, M: int = 192, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.N, self.M = N, M
        g = torch.Generator().manual_seed(seed)
        stacks = {
            "g_a": [Conv(3, N, generator=g), GDN(N),
                    Conv(N, N, generator=g), GDN(N),
                    Conv(N, N, generator=g), GDN(N),
                    Conv(N, M, generator=g)],
            "g_s": [Deconv(M, N, generator=g), GDN(N, inverse=True),
                    Deconv(N, N, generator=g), GDN(N, inverse=True),
                    Deconv(N, N, generator=g), GDN(N, inverse=True),
                    Deconv(N, 3, generator=g)],
            "h_a": [Conv(M, N, kernel_size=3, stride=1, generator=g), LEAKY,
                    Conv(N, N, generator=g), LEAKY, Conv(N, N, generator=g)],
            "h_s": [Deconv(N, M, generator=g), LEAKY,
                    Deconv(M, M * 3 // 2, generator=g), LEAKY,
                    Conv(M * 3 // 2, M * 2, kernel_size=3, stride=1,
                         generator=g)],
            "entropy_parameters": [
                Conv(4 * M, M * 10 // 3, kernel_size=1, stride=1,
                     generator=g), LEAKY,
                Conv(M * 10 // 3, M * 8 // 3, kernel_size=1, stride=1,
                     generator=g), LEAKY,
                Conv(M * 8 // 3, M * 2, kernel_size=1, stride=1,
                     generator=g)],
        }
        self.depth = {}
        for prefix, layers in stacks.items():
            self.depth[prefix] = len(layers)
            for i, layer in enumerate(layers):
                if layer is not LEAKY:
                    self.add_module(f"{prefix}_{i}", layer)
        self.context_prediction = MaskedConv2d(M, 2 * M, kernel_size=5,
                                               mask_type="A", generator=g)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional = GaussianConditional()
        self.to(device)
        self.requires_grad_(False)

    def _stack(self, prefix: str, x):
        """Apply a flax list stack, its activation slots as leaky_relu."""
        for i in range(self.depth[prefix]):
            layer = getattr(self, f"{prefix}_{i}", LEAKY)
            x = F.leaky_relu(x, 0.01) if layer is LEAKY else layer(x)
        return x

    # ---- codec-facing sub-programs ----

    def analysis(self, x):
        return self._stack("g_a", x)

    def synthesis(self, y_hat):
        return self._stack("g_s", y_hat)

    def hyper_analysis(self, y):
        return self._stack("h_a", y)

    def hyper_synthesis(self, z_hat):
        return self._stack("h_s", z_hat)

    def entropy_params(self, params_and_ctx):
        return self._stack("entropy_parameters", params_and_ctx)

    def context(self, y_hat):
        return self.context_prediction(y_hat)

    def aux_loss(self) -> torch.Tensor:
        return self.entropy_bottleneck.loss()

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
