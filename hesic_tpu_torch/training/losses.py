"""Rate-distortion losses, as hesic_tpu/training/losses.py, on NCHW
tensors and in float32 whatever the model's dtype.

The stereo loss keeps the reference's normalisation: MSE summed over both
eyes, and bpp over all four likelihood streams divided by B*H*W, not
2*B*H*W (eval-time reporting divides by 2).
"""

from __future__ import annotations

import math

import torch

_LOG2 = math.log(2)


def bits(likelihoods: torch.Tensor) -> torch.Tensor:
    """Total information content of a likelihood tensor, in bits."""
    return torch.sum(-torch.log(likelihoods.float())) / _LOG2


def _bpp(output, target: torch.Tensor) -> torch.Tensor:
    b, _, h, w = target.shape
    return sum(bits(lik) for lik in output["likelihoods"].values()) \
        / (b * h * w)


def _mse(x_hat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((x_hat.float() - target.float()) ** 2)


def rate_distortion_loss(output, target, lmbda: float = 1e-2):
    """Single-image RD loss: lambda * 255^2 * MSE + bpp."""
    bpp = _bpp(output, target)
    mse = _mse(output["x_hat"], target)
    return {"loss": lmbda * 255 ** 2 * mse + bpp, "mse_loss": mse,
            "bpp_loss": bpp}


def stereo_rate_distortion_loss(output, target1, target2,
                                lmbda: float = 1e-2):
    """Stereo RD loss, with the reference's normalisation quirks."""
    bpp = _bpp(output, target1)
    mse = (_mse(output["x1_hat"], target1)
           + _mse(output["x2_hat"], target2))
    return {"loss": lmbda * 255 ** 2 * mse + bpp, "mse_loss": mse,
            "bpp_loss": bpp}


def mse2psnr(mse):
    """PSNR for inputs in [0, 1]."""
    return 10 * torch.log10(1.0 / torch.as_tensor(mse))


def msssim_db(ms):
    """-10 log10(1 - MS-SSIM), the dB axis of the paper's plots."""
    return -10 * torch.log10(1.0 - torch.as_tensor(ms))


def make_loss_fn(lmbda: float = 1e-2):
    """The training loss of the JAX package's training CLI and bench.py:
    the RD loss of the training forward plus the bottlenecks' aux loss.
    Returns loss_fn(model, batch, generator) -> (loss, {"bpp", "mse"})
    for ``make_train_step``.  A single-image model (``single_image``:
    mbt2018) takes `batch`'s "x" (B, 3, H, W) and the single-image RD
    loss; a stereo model takes "x1", "x2" (B, 3, H, W) and the stereo RD
    loss, and "h" (B, 3, 3) only if it takes homographies
    (``uses_homography``: HESIC, HESIC+; DSIC's forward takes none, as
    bench.py's ``_calibrate(arch="dsic")``).  Tensors on the model's
    device."""

    def loss_fn(model, batch, generator):
        if model.single_image:
            out = model(batch["x"], training=True, generator=generator)
            rd = rate_distortion_loss(out, batch["x"], lmbda)
        else:
            args = (batch["x1"], batch["x2"]) + (
                (batch["h"],) if model.uses_homography else ())
            out = model(*args, training=True, generator=generator)
            rd = stereo_rate_distortion_loss(out, batch["x1"], batch["x2"],
                                             lmbda)
        return rd["loss"] + model.aux_loss(), {"bpp": rd["bpp_loss"],
                                               "mse": rd["mse_loss"]}

    return loss_fn
