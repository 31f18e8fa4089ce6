"""The synthetic homography dataset for pretraining the homography net,
as hesic_tpu/datasets/synthetic.py: the 256 grayscale left view, a random
128 patch with its corners, and either (synthetic mode) the view warped by
a random corner perturbation ``delta_gt`` in [-rho, rho], or (pair mode)
the right view with ``delta_gt`` zero.  The draws (patch x, patch y, then
delta) come from a ``np.random.RandomState`` in the JAX package's order;
the warp is the port's full bilinear warp on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.homography import get_perspective_transform, \
    warp_perspective
from .stereo import (HOMO_PATCH_SIZE, HOMO_PIC_SIZE, HOMO_RHO,
                     StereoImageFolder, _corners, _homography_full,
                     _load_image, _patch_corner)


class SyntheticHomographyDataset:
    """Items {img_a, img_b (256, 256, 1), patch_a, patch_b (128, 128, 1),
    corners (4, 2), delta_gt (4, 2)}, float32."""

    def __init__(self, root: str, split: str = "train", rho: int = HOMO_RHO,
                 synthetic: bool = True, rng=None):
        self.base = StereoImageFolder(root, split)
        self.rho = rho
        self.synthetic = synthetic
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index: int) -> dict:
        img_a = _homography_full(_load_image(self.base.left_list[index]))
        x, y = _patch_corner(self.rng, self.rho)
        corners = _corners(x, y)
        if self.synthetic:
            delta = self.rng.randint(-self.rho, self.rho + 1,
                                     size=(4, 2)).astype(np.float32)
            h = get_perspective_transform(
                torch.from_numpy(corners[None]),
                torch.from_numpy((corners + delta)[None]))
            src = torch.from_numpy(img_a).permute(2, 0, 1)[None]
            img_b = warp_perspective(src, torch.linalg.inv(h),
                                     (HOMO_PIC_SIZE, HOMO_PIC_SIZE))
            img_b = img_b[0].permute(1, 2, 0).numpy()
        else:
            img_b = _homography_full(_load_image(
                self.base.right_list[index]))
            delta = np.zeros((4, 2), np.float32)
        patch = (slice(y, y + HOMO_PATCH_SIZE), slice(x, x + HOMO_PATCH_SIZE))
        return {"img_a": img_a, "img_b": img_b, "patch_a": img_a[patch],
                "patch_b": img_b[patch], "corners": corners,
                "delta_gt": delta}
