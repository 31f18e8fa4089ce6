"""Training: rate-distortion losses and the main/aux Adam step."""

from .losses import (bits, make_loss_fn, mse2psnr, msssim_db,
                     rate_distortion_loss, stereo_rate_distortion_loss)
from .train_state import (is_aux_path, make_optimizer, make_train_step,
                          param_labels)

__all__ = [
    "bits",
    "is_aux_path",
    "make_loss_fn",
    "make_optimizer",
    "make_train_step",
    "mse2psnr",
    "msssim_db",
    "param_labels",
    "rate_distortion_loss",
    "stereo_rate_distortion_loss",
]
