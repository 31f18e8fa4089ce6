"""Image-folder datasets and their batches (numpy, NHWC)."""

from .stereo import (HOMO_PATCH_SIZE, HOMO_PIC_SIZE, HOMO_RHO, ImageFolder,
                     StereoImageFolder, batch_iterator)
from .synthetic import SyntheticHomographyDataset

__all__ = [
    "HOMO_PATCH_SIZE",
    "HOMO_PIC_SIZE",
    "HOMO_RHO",
    "ImageFolder",
    "StereoImageFolder",
    "SyntheticHomographyDataset",
    "batch_iterator",
]
