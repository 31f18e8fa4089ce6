"""Training: rate-distortion losses, the main/aux Adam step and its
checkpoints.  The CLIs are ``training.train`` and
``training.train_homography``."""

from .losses import (bits, make_loss_fn, mse2psnr, msssim_db,
                     rate_distortion_loss, stereo_rate_distortion_loss)
from .train_state import (is_aux_path, load_checkpoint, make_optimizer,
                          make_train_step, param_labels, save_checkpoint)

__all__ = [
    "bits",
    "is_aux_path",
    "load_checkpoint",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
    "mse2psnr",
    "msssim_db",
    "param_labels",
    "rate_distortion_loss",
    "save_checkpoint",
    "stereo_rate_distortion_loss",
]
