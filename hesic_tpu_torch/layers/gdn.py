"""Generalized Divisive Normalization, NCHW (hesic_tpu/layers/gdn.py).

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i, j] * x[j]^2) as a 1x1 channel
mix; ``inverse=True`` multiplies by the sqrt (IGDN).  ``GDN1`` is the
simplified form, y[i] = x[i] / (beta[i] + sum_j gamma[i, j] * |x[j]|),
with no square root.  gamma keeps torch's (out, in) orientation.
Parameters live in sqrt-space (nonneg_apply).

Dispatch.  ``GDN.forward(x, bias=None)`` sends a CUDA bf16 input, computed
in bf16, that records no gradient (the codecs run under ``no_grad``) to
one launch of codecs/csrc/gdn.cu (``gdn_cuda``): the bias, the square,
the channel mix on tensor cores, the rsqrt or sqrt and the product in one
read and one write.  The kernel keeps x's layout, contiguous NCHW or
channels-last (the convs after it then run on the layout they had
without it), and takes the channel counts of the port's bf16 models,
GDN_CHANNELS; another count raises.  Everything else (the CPU, float32, a
forward that records a gradient) runs ``gdn_plain``, the op sequence the
kernel replaces, so weights, gradients and the float32 paths are
unchanged.  Each launch leaves ``count/gdn_launches=1`` on a profiler's
timeline.

The bias fold.  ``bias`` is the preceding conv's bias, added first as
cuDNN's convolution adds it on the card: a bf16 broadcast add after the
bias-free product.  ``conv_gdn(conv, gdn, x)`` runs a Conv or Deconv
without its bias and hands the bias to the GDN wherever the kernel takes
the conv's output, and runs both as they were everywhere else (on the
CPU a convolution adds its bias inside its own sum, so there the fold
would change the numbers).  ``run_layers`` applies a stack of layers with
every conv-then-GDN pair so folded.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import register_flop_formula

from ..codecs import build
from ..ops import nonneg_apply, nonneg_init
from ..utils.tracing import count
from .conv import Conv, Deconv

# the kernel's channel counts: HESIC's right-eye RGB GDN and IGDN (CUDA
# cores), N of HESIC, DSIC and HESIC+ (tensor cores)
GDN_CHANNELS = (3, 128, 192)
_NAME = "gdn"


def _gdn_lib():
    lib = build.load(_NAME)
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_gdn.restype = ci
        lib.hesic_gdn.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        lib._hesic_typed = True
    return lib


def gdn_plain(x, beta, gamma, inverse: bool, dtype=None, bias=None):
    """Plain twin of the GDN kernel, and GDN's forward wherever the kernel
    does not run: ``bias`` (the preceding conv's, or None) added in x's
    dtype, then x * x cast to `dtype` (None = x's), the channel mix as a
    1x1 conv with ``beta`` as its bias, and x times the rsqrt (sqrt for
    ``inverse``) of the norm."""
    if bias is not None:
        x = x + bias[:, None, None]
    d = dtype or x.dtype
    norm = F.conv2d((x * x).to(d), gamma[:, :, None, None], beta)
    if inverse:
        return x * torch.sqrt(norm)
    return x * torch.rsqrt(norm)


def _dense(x) -> bool:
    """x is contiguous NCHW or channels-last: the kernel's layouts."""
    return (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last))


def _check_gdn_args(x, beta, gamma, bias):
    """Raise unless the kernel takes these arguments (device aside):
    4-D bf16 x of C channels, C one of GDN_CHANNELS, contiguous NCHW or
    channels-last; contiguous bf16 beta and bias (C,) and gamma (C, C)."""
    if x.dim() != 4:
        raise ValueError(f"gdn takes 4-D x (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if c not in GDN_CHANNELS:
        raise ValueError(f"gdn's kernel takes {GDN_CHANNELS} channels, "
                         f"got {c}")
    if not _dense(x):
        raise ValueError("gdn: x must be contiguous, NCHW or channels-last")
    for name, t, shape in (("x", x, None), ("beta", beta, (c,)),
                           ("gamma", gamma, (c, c)), ("bias", bias, (c,))):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise ValueError(f"gdn's kernel takes bf16 {name}, got "
                             f"{t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"gdn: {name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t is not x and not t.is_contiguous():
            raise ValueError(f"gdn: {name} must be contiguous")


def _gdn_launch(x, beta, gamma, bias, inverse):
    b, c, hh, w = x.shape
    out = torch.empty_like(x)       # in x's layout
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _gdn_lib().hesic_gdn(
        x.data_ptr(), None if bias is None else bias.data_ptr(),
        beta.data_ptr(), gamma.data_ptr(), out.data_ptr(), b, c, hh * w,
        int(not x.is_contiguous()), int(inverse), stream)
    build.check_status(rc, _NAME, "B*H*W below 2^33, gamma 4-byte aligned")
    build.count_launch(_NAME)
    count("gdn_launches", 1)
    return out


# The kernel as the operator hesic_tpu_torch::gdn, defined through the
# dispatcher's own registration (torch.library.custom_op's first call
# imports several hundred modules, seconds of a codec's set-up), so that
# PyTorch's FLOP counter sees it and counts it by _gdn_flops.
_OPS = torch.library.Library("hesic_tpu_torch", "FRAGMENT")
_OPS.define("gdn(Tensor x, Tensor beta, Tensor gamma, Tensor? bias, "
            "bool inverse) -> Tensor")
_OPS.impl("gdn", _gdn_launch, "CUDA")


@register_flop_formula(torch.ops.hesic_tpu_torch.gdn)
def _gdn_flops(x_shape, *args, **kwargs) -> int:
    """The channel mix, 2 a multiply-add: what FlopCounterMode counts for
    the twin's 1x1 convolution, so a codec's ``device_flops`` is the same
    on the card and on the CPU."""
    b, c, hh, w = x_shape
    return 2 * b * c * c * hh * w


def gdn_cuda(x, beta, gamma, inverse: bool, bias=None):
    """GDN's kernel (codecs/csrc/gdn.cu) on the card: x (B, C, H, W)
    contiguous NCHW or channels-last, beta (C,), gamma (C, C) and bias
    (C,) or None contiguous, all bf16 CUDA tensors; the result in x's
    layout.  The same function as ``gdn_plain`` in bf16, the channel
    mix's f32 sum in its own fixed order.  Forward only.  It runs as the
    operator hesic_tpu_torch::gdn, whose FLOPs PyTorch's counter takes
    from ``_gdn_flops``."""
    _check_gdn_args(x, beta, gamma, bias)
    for name, t in (("x", x), ("beta", beta), ("gamma", gamma),
                    ("bias", bias)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"gdn: {name} must be a CUDA tensor, got "
                             f"{t.device}")
    return torch.ops.hesic_tpu_torch.gdn(x, beta, gamma, bias, bool(inverse))


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1,
                 dtype=None):
        super().__init__()
        self.inverse, self.beta_min, self.dtype = inverse, beta_min, dtype
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels)))
        self.gamma = nn.Parameter(nonneg_init(gamma_init
                                              * torch.eye(channels)))

    def takes_kernel(self, on_cuda: bool, x_dtype, *inputs) -> bool:
        """Whether ``forward`` sends an input of `x_dtype`, on the card
        when `on_cuda`, derived from the tensors `inputs`, to the kernel:
        bf16 in and computed in bf16, and no gradient recorded."""
        records_grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (self.beta, self.gamma, *inputs))
        return (on_cuda and x_dtype == torch.bfloat16
                and (self.dtype or x_dtype) == torch.bfloat16
                and not records_grad)

    def forward(self, x, bias=None):
        d = self.dtype or x.dtype
        beta = nonneg_apply(self.beta, self.beta_min).to(d)
        gamma = nonneg_apply(self.gamma).to(d)
        if self.takes_kernel(x.is_cuda, x.dtype, x, bias):
            return gdn_cuda(x if _dense(x) else x.contiguous(), beta, gamma,
                            self.inverse, bias)
        return gdn_plain(x, beta, gamma, self.inverse, d, bias)


class GDN1(GDN):
    """Simplified GDN: |x| in place of x^2 and no square root;
    ``inverse=True`` multiplies by the norm instead of dividing.  No cell
    runs it, and it has no kernel: its forward is these ops everywhere."""

    def takes_kernel(self, on_cuda: bool, x_dtype, *inputs) -> bool:
        return False

    def forward(self, x):
        d = self.dtype or x.dtype
        beta = nonneg_apply(self.beta, self.beta_min).to(d)
        gamma = nonneg_apply(self.gamma).to(d)
        norm = F.conv2d(torch.abs(x).to(d), gamma[:, :, None, None], beta)
        if not self.inverse:
            norm = 1.0 / norm
        return x * norm


def conv_gdn(conv, gdn, x):
    """``gdn(conv(x))`` for a Conv or Deconv followed by a GDN: where the
    GDN's kernel takes the conv's output, the conv runs without its bias
    and the kernel adds it; elsewhere both run as they are."""
    d = conv.dtype or x.dtype
    if gdn.takes_kernel(x.is_cuda, d, x, conv.weight, conv.bias):
        return gdn(conv(x, with_bias=False), bias=conv.bias.to(d))
    return gdn(conv(x))


def run_layers(layers, x):
    """Apply `layers` in order, each Conv or Deconv followed by a GDN as
    one ``conv_gdn``."""
    layers = list(layers)
    i = 0
    while i < len(layers):
        layer = layers[i]
        if (i + 1 < len(layers) and isinstance(layer, (Conv, Deconv))
                and isinstance(layers[i + 1], GDN)):
            x = conv_gdn(layer, layers[i + 1], x)
            i += 2
        else:
            x = layer(x)
            i += 1
    return x
