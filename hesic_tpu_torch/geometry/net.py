"""The unsupervised deep homography network, NCHW: the counterpart of
hesic_tpu/geometry/net.py.

A VGG-style regressor of the four corner offsets from a stacked grayscale
patch pair, trained with a photometric L1 loss through the full-image
warp (``homography.warp_perspective``).  The submodules carry flax's
names (``_VGGBlock_{0..3}.Conv_{0,1}``, ``BatchNorm_{0,1}`` with
``batch_norm``, ``Dense_0``, ``Dense_1``), so ``hesic_from_jax`` carries a
JAX tree across.  The features are flattened in NHWC order before
``Dense_0``, as the JAX net flattens them, so its kernel carries across
as a plain transpose.  Dropout draws its mask from an explicit
``torch.Generator``.  Initialisation: the port's kaiming-normal convs,
lecun-normal dense kernels with zero biases (flax's default).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv
from .homography import get_perspective_transform, warp_perspective


def _lecun_(weight: torch.Tensor, fan_in: int, generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class _VGGBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, pool: bool = True,
                 batch_norm: bool = False, generator=None):
        super().__init__()
        self.pool, self.batch_norm = pool, batch_norm
        for i, c in enumerate((in_ch, features)):
            setattr(self, f"Conv_{i}",
                    Conv(c, features, 3, stride=1, generator=generator))
            if batch_norm:
                # flax's BatchNorm: momentum 0.99, epsilon 1e-5
                setattr(self, f"BatchNorm_{i}",
                        nn.BatchNorm2d(features, eps=1e-5, momentum=0.01))

    def forward(self, x):
        for i in range(2):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            if self.batch_norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
        return F.max_pool2d(x, 2) if self.pool else x


def _dropout(x, training: bool, generator, rate: float = 0.5):
    if not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class HomographyNet(nn.Module):
    """Predicts 4 corner offsets (B, 4, 2) from grayscale patches a, b
    (B, 1, P, P).  Parameters are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and moved to ``device``."""

    def __init__(self, patch_size: int = 128, batch_norm: bool = False,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.patch_size, self.batch_norm = patch_size, batch_norm
        g = torch.Generator().manual_seed(seed)
        for i, (cin, c, pool) in enumerate(((2, 64, True), (64, 64, True),
                                            (64, 128, True),
                                            (128, 128, False))):
            setattr(self, f"_VGGBlock_{i}",
                    _VGGBlock(cin, c, pool, batch_norm, g))
        flat = 128 * (patch_size // 8) ** 2
        self.Dense_0 = nn.Linear(flat, 1024)
        self.Dense_1 = nn.Linear(1024, 8)
        for dense in (self.Dense_0, self.Dense_1):
            _lecun_(dense.weight, dense.in_features, g)
            nn.init.zeros_(dense.bias)
        self.to(device)

    def config(self) -> dict:
        return {"patch_size": self.patch_size, "batch_norm": self.batch_norm}

    def forward(self, a, b, training: bool = False, generator=None):
        """Batch norms use their batch statistics when `training`, else
        their running ones, whatever ``self.training`` says (the JAX
        net's ``use_running_average = not training``)."""
        self.train(training)
        x = torch.cat([a, b], dim=1)
        for i in range(4):
            x = getattr(self, f"_VGGBlock_{i}")(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = _dropout(x, training, generator)
        x = F.relu(self.Dense_0(x))
        x = _dropout(x, training, generator)
        return self.Dense_1(x).reshape(-1, 4, 2)

    def get_h(self, a, b, corners, training: bool = False, generator=None):
        """The inverse of the homography mapping `corners` (B, 4, 2) to
        corners + the predicted offsets."""
        delta = self(a, b, training, generator)
        h = get_perspective_transform(corners, corners + delta)
        return torch.linalg.inv(h)


def photometric_loss(delta, img_a, patch_b, corners):
    """L1(warp(img_a, h^-1), patch_b), h from the corner offsets `delta`
    with the corners re-anchored at their own top-left corner.  img_a (B,
    C, H, W) (the full image), patch_b (B, C, P, P), corners and delta
    (B, 4, 2)."""
    corners_hat = corners + delta
    corners = corners - corners[:, 0:1, :]
    h = get_perspective_transform(corners, corners_hat)
    patch_b_hat = warp_perspective(img_a, torch.linalg.inv(h),
                                   (patch_b.shape[2], patch_b.shape[3]))
    return torch.mean(torch.abs(patch_b_hat - patch_b))
