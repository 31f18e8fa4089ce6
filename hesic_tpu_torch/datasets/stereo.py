"""Datasets: stereo pair folders and single-image folders, NHWC numpy, as
hesic_tpu/datasets/stereo.py.

``StereoImageFolder`` reads root/{split}/{left,right}/<name>.png pairs
(identical names), crops both eyes at one random window, and adds the
homography net's inputs: the left crop resized to 256, grayscale and
normalised in full (``homo_full1``), and a 128 patch of each eye at a
random corner (``homo_img1``/``homo_img2``) with the patch's corners.
``ImageFolder`` reads root/{split}/*.png single images.  The random draws
come from a ``np.random.RandomState`` in the JAX package's order (crop
row, crop column, patch x, patch y), so one seeded state gives the JAX
package's crops and corners.  Images are read and resized by
``image_io`` (no PIL): PNG only.  Items stay numpy; a trainer moves them
to its device.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional

import numpy as np

from .image_io import read_png, resize_bilinear

# scalar grayscale normalisation constants: the means of the per-channel
# ImageNet statistics
MEAN = float(np.mean([0.485, 0.456, 0.406]))
STD = float(np.mean([0.229, 0.224, 0.225]))

HOMO_PIC_SIZE = 256
HOMO_PATCH_SIZE = 128
HOMO_RHO = 45


def _load_image(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32) / 255.0


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    small = resize_bilinear((img * 255).astype(np.uint8), (size, size))
    return small.astype(np.float32) / 255.0


def _homography_full(img: np.ndarray) -> np.ndarray:
    """The full 256 grayscale normalised image (the photometric loss warps
    the whole image, not the patch)."""
    gray = _resize(img, HOMO_PIC_SIZE).mean(axis=-1, keepdims=True)
    return (gray - MEAN) / STD


def _patch_corner(rng, rho: int) -> tuple:
    lo, hi = rho, HOMO_PIC_SIZE - rho - HOMO_PATCH_SIZE
    if hi < lo:
        return 0, 0
    x = rng.randint(lo, hi + 1)
    return x, rng.randint(lo, hi + 1)


def _corners(x: int, y: int) -> np.ndarray:
    p = HOMO_PATCH_SIZE
    return np.array([[x, y], [x + p, y], [x + p, y + p], [x, y + p]],
                    np.float32)


def _crop_window(rng, shape, patch) -> tuple:
    """One random window per axis; a patch at least the image's extent
    keeps the full extent on that axis."""
    h, w = shape[:2]
    ph, pw = min(patch[0], h), min(patch[1], w)
    sh = 0 if ph >= h else rng.randint(0, h - ph)
    sw = 0 if pw >= w else rng.randint(0, w - pw)
    return slice(sh, sh + ph), slice(sw, sw + pw)


class StereoImageFolder:
    """root/{split}/{left,right}/<name>.png stereo pairs.

    An item is a dict: x1, x2 (H, W, 3) float32 paired random crops;
    homo_img1/2 (128, 128, 1) normalised grayscale patches; homo_full1
    (256, 256, 1) the whole normalised left view; corners (4, 2) float32
    patch corners in 256-space; name (with need_file_name); with
    classical_h, h (3, 3) float32 the crops' classical estimate
    (geometry/features.py, run on `h_device`), the identity where it
    fails, as the reference degraded its tuple on a SURF failure."""

    def __init__(self, root: str, split: str = "train",
                 patch_size=(256, 256), need_file_name: bool = False,
                 classical_h: bool = False,
                 rng: Optional[np.random.RandomState] = None,
                 h_device="cuda"):
        splitdir = os.path.join(root, split)
        if not os.path.isdir(splitdir):
            raise RuntimeError(f'Invalid directory "{root}"')
        self.left_list = sorted(
            glob.glob(os.path.join(splitdir, "left", "*")))
        self.right_list = sorted(
            glob.glob(os.path.join(splitdir, "right", "*")))
        if isinstance(patch_size, int):
            patch_size = (patch_size, patch_size)
        self.patch_size = tuple(patch_size)
        self.need_file_name = need_file_name
        self.classical_h, self.h_device = classical_h, h_device
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.left_list)

    def __getitem__(self, index: int) -> dict:
        lpath, rpath = self.left_list[index], self.right_list[index]
        if os.path.basename(lpath) != os.path.basename(rpath):
            raise ValueError(f"unpaired stereo images: {lpath} vs {rpath}")
        img1, img2 = _load_image(lpath), _load_image(rpath)
        win = _crop_window(self.rng, img1.shape, self.patch_size)
        img1, img2 = img1[win], img2[win]
        x, y = _patch_corner(self.rng, HOMO_RHO)
        patch = (slice(y, y + HOMO_PATCH_SIZE), slice(x, x + HOMO_PATCH_SIZE))
        full1 = _homography_full(img1)
        item = {"x1": img1, "x2": img2, "homo_img1": full1[patch],
                "homo_img2": _homography_full(img2)[patch],
                "homo_full1": full1, "corners": _corners(x, y)}
        if self.classical_h:
            from ..geometry.features import get_h_classical
            h = get_h_classical(img1, img2, device=self.h_device)
            item["h"] = np.eye(3, dtype=np.float32) if h is None else h
        if self.need_file_name:
            item["name"] = os.path.basename(lpath)
        return item


class ImageFolder:
    """root/{split}/*.png single images: items {"x": (H, W, 3) float32},
    randomly cropped to `patch_size` when given."""

    def __init__(self, root: str, split: str = "train", patch_size=None,
                 rng: Optional[np.random.RandomState] = None):
        splitdir = os.path.join(root, split)
        if not os.path.isdir(splitdir):
            raise RuntimeError(f'Invalid directory "{root}"')
        self.samples = sorted(
            p for p in glob.glob(os.path.join(splitdir, "*"))
            if os.path.isfile(p))
        if isinstance(patch_size, int):
            patch_size = (patch_size, patch_size)
        self.patch_size = patch_size
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        img = _load_image(self.samples[index])
        if self.patch_size is not None:
            img = img[_crop_window(self.rng, img.shape, self.patch_size)]
        return {"x": img}


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True) -> Iterator[dict]:
    """One epoch of dict batches, each key stacked on a leading axis
    (strings gathered in a list); the order is shuffled by
    ``np.random.RandomState(seed)``."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for lo in range(0, len(order), batch_size):
        idx = order[lo: lo + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        items = [dataset[int(i)] for i in idx]
        yield {k: [it[k] for it in items] if isinstance(items[0][k], str)
               else np.stack([it[k] for it in items]) for k in items[0]}
