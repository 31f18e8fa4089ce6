"""Cheng2020 anchor and attention models, NCHW.

Counterpart of hesic_tpu/models/waseda.py: residual-block transforms, 3x3
hyper transforms with sub-pixel upsampling, on mbt2018's joint
autoregressive machinery (models/priors.py
``JointAutoregressiveHierarchicalPriors``), whose forward, sub-programs
and codecs they share.  The latent y has N channels; ``M`` is taken and
ignored, as in the JAX models.  The context conv is MaskedConv2d(N, 2N)
and the entropy-parameter stack runs 4N -> N*10//3 -> N*8//3 -> 2N: at
N=128 the hidden widths are 426 and 341, which kernel 5's weight packing
pads to 432 and 352 (models/wavefront.py ``pack_weights``).

The stacks carry flax's list names (``g_a_0``, ``h_s_2``,
``entropy_parameters_4``) and the blocks flax's child names
(layers/layers.py), so state_dict keys map one to one onto the JAX
parameter tree (utils/from_jax.py).

Random weights differ from the JAX models' draw: every conv is drawn as
``torch.nn.Conv2d``'s default (uniform within 1/sqrt(fan_in), bias too).
Under the JAX package's kaiming-normal draw the three IGDNs of g_s blow
the reconstruction up (beyond 1e10 at N=192), which no calibration of a
few steps repairs and which leaves the level scan's inputs
ill-conditioned (ROADMAP C, divergences).
"""

from __future__ import annotations

import math

import torch

from ..entropy_models import EntropyBottleneck, GaussianConditional
from ..layers import (AttentionBlock, Conv, MaskedConv2d, ResidualBlock,
                      ResidualBlockUpsample, ResidualBlockWithStride,
                      SubpelConv3x3, conv3x3)
from .priors import LEAKY, JointAutoregressiveHierarchicalPriors


def _hyper(n: int, g) -> dict:
    """Cheng2020's hyper transforms (both variants)."""
    return {"h_a": [conv3x3(n, n, generator=g), LEAKY,
                    conv3x3(n, n, generator=g), LEAKY,
                    conv3x3(n, n, 2, g), LEAKY,
                    conv3x3(n, n, generator=g), LEAKY,
                    conv3x3(n, n, 2, g)],
            "h_s": [conv3x3(n, n, generator=g), LEAKY,
                    SubpelConv3x3(n, n, 2, g), LEAKY,
                    conv3x3(n, n * 3 // 2, generator=g), LEAKY,
                    SubpelConv3x3(n * 3 // 2, n * 3 // 2, 2, g), LEAKY,
                    conv3x3(n * 3 // 2, n * 2, generator=g)]}


def _entropy_parameters(n: int, g) -> list:
    return [Conv(4 * n, n * 10 // 3, kernel_size=1, stride=1, generator=g),
            LEAKY,
            Conv(n * 10 // 3, n * 8 // 3, kernel_size=1, stride=1,
                 generator=g), LEAKY,
            Conv(n * 8 // 3, n * 2, kernel_size=1, stride=1, generator=g)]


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """cheng2020-anchor, N=192 by default."""

    def __init__(self, N: int = 192, M: int = 192, device="cuda",
                 seed: int = 0):
        super(JointAutoregressiveHierarchicalPriors, self).__init__()
        self.N, self.M = N, M
        g = torch.Generator().manual_seed(seed)
        stacks = {**self._transforms(N, g), **_hyper(N, g),
                  "entropy_parameters": _entropy_parameters(N, g)}
        self._register(stacks)
        self.context_prediction = MaskedConv2d(N, 2 * N, kernel_size=5,
                                               mask_type="A", generator=g)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional = GaussianConditional()
        self._conv_default_init(g)
        self._finish(device)

    def _conv_default_init(self, g) -> None:
        """Redraw every conv as torch.nn.Conv2d's default does (weight and
        bias uniform within 1/sqrt(fan_in))."""
        for mod in self.modules():
            if isinstance(mod, (Conv, MaskedConv2d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                with torch.no_grad():
                    mod.weight.uniform_(-bound, bound, generator=g)
                    mod.bias.uniform_(-bound, bound, generator=g)

    @staticmethod
    def _transforms(n: int, g) -> dict:
        return {"g_a": [ResidualBlockWithStride(3, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockWithStride(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockWithStride(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        conv3x3(n, n, 2, g)],
                "g_s": [ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        SubpelConv3x3(n, 3, 2, g)]}


class Cheng2020Attention(Cheng2020Anchor):
    """cheng2020-attn: the anchor with attention blocks in g_a and g_s."""

    @staticmethod
    def _transforms(n: int, g) -> dict:
        return {"g_a": [ResidualBlockWithStride(3, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockWithStride(n, n, 2, g),
                        AttentionBlock(n, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockWithStride(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        conv3x3(n, n, 2, g),
                        AttentionBlock(n, g)],
                "g_s": [AttentionBlock(n, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        AttentionBlock(n, g),
                        ResidualBlock(n, n, g),
                        ResidualBlockUpsample(n, n, 2, g),
                        ResidualBlock(n, n, g),
                        SubpelConv3x3(n, 3, 2, g)]}
