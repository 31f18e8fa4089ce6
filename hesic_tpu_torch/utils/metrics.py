"""Image quality metrics: PSNR, SSIM and MS-SSIM.

Counterpart of hesic_tpu/utils/metrics.py.  Inputs are NHWC (B, H, W, C)
arrays or tensors in [0, max_val], as the JAX package's; the filters run
NCHW on the input's device.  MS-SSIM follows Wang et al. 2003: up to 5
scales, a Gaussian window of 11 taps with sigma 1.5, the standard
weights.  For small inputs the scale count shrinks so that every scale
still fits the window, and the weights used are renormalised to sum to
one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _nchw(x) -> torch.Tensor:
    """(B, H, W, C) array or tensor -> (B, C, H, W) float32 tensor."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(torch.float32).permute(0, 3, 1, 2)


def psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the full tensors, float32."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32).to(a.device)
    mse = torch.mean((a - b) ** 2)
    return 10 * torch.log10(max_val ** 2 / mse)


def _gaussian_window(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _filter2d_separable(img: torch.Tensor, window: torch.Tensor):
    """Depthwise separable filter of (B, C, H, W), VALID padding: rows,
    then columns."""
    c = img.shape[1]
    kh = window.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = window.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)


def _ssim_components(x, y, max_val: float = 1.0, win_size: int = 11,
                     sigma: float = 1.5):
    """(mean SSIM, mean contrast-structure) of NCHW x, y."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    w = _gaussian_window(win_size, sigma, x.device)
    mu_x = _filter2d_separable(x, w)
    mu_y = _filter2d_separable(y, w)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = _filter2d_separable(x * x, w) - mu_xx
    sigma_yy = _filter2d_separable(y * y, w) - mu_yy
    sigma_xy = _filter2d_separable(x * y, w) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return torch.mean(ssim_map), torch.mean(cs)


def ssim(x, y, max_val: float = 1.0) -> torch.Tensor:
    x = _nchw(x)
    return _ssim_components(x, _nchw(y).to(x.device), max_val)[0]


def ms_ssim(x, y, max_val: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM (up to 5 scales, the standard weights,
    renormalised over the scales used)."""
    x = _nchw(x)
    y = _nchw(y).to(x.device)
    min_dim = min(x.shape[2], x.shape[3])
    levels = 1
    while levels < len(_MSSSIM_WEIGHTS) and (min_dim >> levels) >= 11:
        levels += 1
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], dtype=torch.float32,
                           device=x.device)
    weights = weights / torch.sum(weights)
    values = []
    for i in range(levels):
        s, cs = _ssim_components(x, y, max_val)
        values.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            x = F.avg_pool2d(x, 2)
            y = F.avg_pool2d(y, 2)
    values = torch.clamp(torch.stack(values), min=1e-6)  # no negatives
    return torch.prod(values ** weights)


def np_psnr(a, b, max_val: float = 1.0) -> float:
    """PSNR in float64 on the host."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(max_val ** 2 / mse)
