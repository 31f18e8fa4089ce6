"""HESIC+: stereo compression with per-eye joint autoregressive priors,
NCHW.

Counterpart of hesic_tpu/models/hesic_plus.py (``HESICPlus``): the
codec-facing sub-programs, the training forward, ``left_prior`` and
``aux_loss``.  Each eye has mbt2018-style machinery:
a hyper-analysis ``h_a``, a hyper-synthesis ``h_s`` (the ``pre`` input of
the entropy parameters), a masked 5x5 context conv and a 1x1
entropy-parameter stack.  The right eye's stack takes 5M channels:
cat(params2 (2M), ctx2 (2M), re-encoded decoded-left latent (M)).

flax registers the layers of a list attribute on the model itself, named
by their index in the list, activations counted: ``h_a1_0``, ``h_s1_4``,
``entropy_parameters2_2``.  The port registers them under the same names,
so state_dict keys map one to one onto the JAX parameter tree
(utils/from_jax.py).  ``dtype`` (None = float32) is the compute type of
every conv, as in models/hesic.py; the hyper and entropy-parameter
outputs are cast to float32, and the Gaussian conditionals' likelihood
math is float32.  Activations are ``leaky_relu`` with slope 0.01, flax's
default.

The host codec, ``HESICPlusCodec``, is in models/hesic_plus_codec.py,
the reference-layout codec, ``HESICPlusRefCodec``, in
models/hesic_plus_refcodec.py.  ``HESICPlusTogether`` is HESIC+ with
HESIC's stage-2 enhancement (models/hesic.py ``IndependentEnhancement``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy_models import EntropyBottleneck, GaussianConditional
from ..geometry import warp_perspective_train
from ..layers import Conv, Deconv, MaskedConv2d
from ..ops import quantize
from .hesic import (IndependentEnhancement, StereoDecoder, StereoDecoder2,
                    StereoEncoder, StereoEncoder2, Together)


def stack_names(prefix: str, n: int = 3) -> list:
    """flax names of an n-layer list with activations between layers."""
    return [f"{prefix}_{2 * i}" for i in range(n)]


class HESICPlus(nn.Module):
    """The HESIC+ model, N=128, M=192 by default.

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and then moved to ``device``."""

    entropy_bottlenecks = ("entropy_bottleneck1", "entropy_bottleneck2")
    gaussian_conditionals = ("gaussian_conditional1", "gaussian_conditional2")
    single_image = False
    uses_homography = True

    def __init__(self, N: int = 128, M: int = 192, dtype=None,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.N, self.M, self.dtype = N, M, dtype
        g = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, generator=g)
        self.encoder1 = StereoEncoder(N, M, **kw)
        self.encoder2 = StereoEncoder2(N, M, **kw)
        self.decoder1 = StereoDecoder(N, M, **kw)
        self.decoder2 = StereoDecoder2(N, M, **kw)
        for eye in (1, 2):
            cin = 4 * M if eye == 1 else 5 * M
            stacks = {
                f"h_a{eye}": [Conv(M, N, kernel_size=3, stride=1, **kw),
                              Conv(N, N, **kw), Conv(N, N, **kw)],
                f"h_s{eye}": [Deconv(N, M, **kw),
                              Deconv(M, M * 3 // 2, **kw),
                              Conv(M * 3 // 2, M * 2, kernel_size=3,
                                   stride=1, **kw)],
                f"entropy_parameters{eye}": [
                    Conv(cin, M * 10 // 3, kernel_size=1, stride=1, **kw),
                    Conv(M * 10 // 3, M * 8 // 3, kernel_size=1, stride=1,
                         **kw),
                    Conv(M * 8 // 3, M * 2, kernel_size=1, stride=1, **kw)],
            }
            for prefix, layers in stacks.items():
                for name, layer in zip(stack_names(prefix), layers):
                    self.add_module(name, layer)
            self.add_module(f"context_prediction{eye}", MaskedConv2d(
                M, 2 * M, kernel_size=5, mask_type="A", **kw))
        self.entropy_bottleneck1 = EntropyBottleneck(N, generator=g)
        self.entropy_bottleneck2 = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional1 = GaussianConditional()
        self.gaussian_conditional2 = GaussianConditional()
        self.to(device)
        self.requires_grad_(False)

    def _stack(self, prefix: str, x):
        """Apply a flax list stack: layer, leaky_relu, layer, ... ->
        float32."""
        for i, name in enumerate(stack_names(prefix)):
            if i:
                x = F.leaky_relu(x, 0.01)
            x = getattr(self, name)(x)
        return x.float()

    # ---- codec-facing sub-programs ----

    def analysis1(self, x1):
        return self.encoder1(x1)

    def analysis2(self, x1_warp, x2):
        return self.encoder2(x1_warp, x2)

    def synthesis1(self, y1_hat):
        return self.decoder1(y1_hat)

    def synthesis2(self, y2_hat, x1_hat_warp):
        return self.decoder2(y2_hat, x1_hat_warp)

    def hyper_analysis1(self, y1):
        return self._stack("h_a1", y1)

    def hyper_analysis2(self, y2):
        return self._stack("h_a2", y2)

    def hyper_synthesis1(self, z1_hat):
        return self._stack("h_s1", z1_hat)

    def hyper_synthesis2(self, z2_hat):
        return self._stack("h_s2", z2_hat)

    def entropy_params1(self, x):
        return self._stack("entropy_parameters1", x)

    def entropy_params2(self, x):
        return self._stack("entropy_parameters2", x)

    def aux_loss(self) -> torch.Tensor:
        return (self.entropy_bottleneck1.loss()
                + self.entropy_bottleneck2.loss())

    def left_prior(self, x1_hat, h):
        """The decoder-reproducible cross-eye prior: the decoded left view
        warped by `h`, re-encoded and rounded (eval quantization)."""
        warped = warp_perspective_train(x1_hat, h, self.dtype)
        return quantize(self.encoder1(warped), "dequantize")

    def _eye(self, eye: int, y, params, extra, training, generator):
        """One eye's y_hat and its likelihoods: y_hat, then the context
        conv and the entropy parameters over cat(params, ctx, *extra),
        then the Gaussian conditional's own draw."""
        y_hat = quantize(y, "noise" if training else "dequantize",
                         generator=generator)
        ctx = getattr(self, f"context_prediction{eye}")(y_hat).float()
        scales, means = getattr(self, f"entropy_params{eye}")(
            torch.cat([params, ctx, *extra], dim=1)).chunk(2, dim=1)
        _, lik = getattr(self, f"gaussian_conditional{eye}")(
            y, scales, means, training, generator)
        return y_hat, lik

    def forward(self, x1, x2, h, training: bool = False, generator=None):
        """x1, x2 (B, 3, H, W) float32 views, h (B, 3, 3) homographies ->
        {"x1_hat", "x2_hat", "y1_hat", "y2_hat", "likelihoods": {"y1",
        "y2", "z1", "z2"}}, NCHW float32.

        Training draws the noise of seven quantizations from `generator`,
        in the JAX package's order: z1, y1_hat, the first Gaussian
        conditional's draw, z2, the re-encoded warped left
        reconstruction, y2_hat, the second conditional's draw.  Eval
        rounds instead.  The warps run in the model's dtype."""
        mode = "noise" if training else "dequantize"
        y1 = self.encoder1(x1)
        z1_hat, z1_lik = self.entropy_bottleneck1(
            self.hyper_analysis1(y1), training, generator)
        y1_hat, y1_lik = self._eye(1, y1, self.hyper_synthesis1(z1_hat), (),
                                   training, generator)
        x1_hat = self.decoder1(y1_hat)

        x1_warp = warp_perspective_train(x1, h, self.dtype)
        y2 = self.encoder2(x1_warp, x2)
        z2_hat, z2_lik = self.entropy_bottleneck2(
            self.hyper_analysis2(y2), training, generator)
        # the warped left reconstruction feeds the right eye's prior
        # (re-encoded) and its decoder
        x1_hat_warp = warp_perspective_train(x1_hat, h, self.dtype)
        y1_hat_warpf2 = quantize(self.encoder1(x1_hat_warp), mode,
                                 generator=generator)
        y2_hat, y2_lik = self._eye(2, y2, self.hyper_synthesis2(z2_hat),
                                   (y1_hat_warpf2,), training, generator)
        x2_hat = self.decoder2(y2_hat, x1_hat_warp)
        return {"x1_hat": x1_hat, "x2_hat": x2_hat, "y1_hat": y1_hat,
                "y2_hat": y2_hat,
                "likelihoods": {"y1": y1_lik, "y2": y2_lik, "z1": z1_lik,
                                "z2": z2_lik}}


class HESICPlusTogether(Together):
    """HESIC+ and the cross-view enhancement, N=128, M=192 by default;
    ``dtype`` is HESIC+'s (the enhancement runs in its input's dtype).
    ``m1`` takes an existing HESIC+ to enhance instead of a new one."""

    def __init__(self, N: int = 128, M: int = 192, dtype=None,
                 device="cuda", seed: int = 0, m1=None):
        super().__init__()
        m1 = m1 if m1 is not None else HESICPlus(N, M, dtype, device, seed)
        self._attach(m1, IndependentEnhancement(
            torch.Generator().manual_seed(seed)))
