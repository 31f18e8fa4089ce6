"""Utilities: image metrics (exported here, as the JAX package's
``utils`` exports them), persistence (``persist``), weight transfer from
the JAX package's parameter trees (``from_jax``), checkpoint conversion,
logging, profiling and the command-line tools (``eval_model``,
``codec_cli``, ``update_model``, ``eval_homography``, ``bench_codecs``,
``find_close``, ``plot``), each imported by its module path.  Nothing but
the metrics loads with the package: ``models.base`` imports
``utils.persist``, and the tools import the models."""

from .metrics import ms_ssim, np_psnr, psnr, ssim

__all__ = ["ms_ssim", "np_psnr", "psnr", "ssim"]
