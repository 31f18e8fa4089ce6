"""DSIC: deep stereo image compression with disparity cost volumes, NCHW.

Counterpart of hesic_tpu/models/dsic.py (``DSIC`` and its parts).  The
right eye is coded by warping left-eye encoder and decoder features with
learned disparity distributions: softmax cost volumes over C horizontal
shifts, each built from a 2-D branch on the two eyes' features and a 3-D
branch on a global context derived from the decoded left latent.

Submodules carry the JAX package's parameter names (``encoder1.Conv_0``,
``cost_volume1.Conv3D_0``, ``global_context.GroupNorm_2``, ...) so
weights map one to one (utils/from_jax.py).  ``dtype`` (None = float32)
is the transforms' compute type.

Layouts.  A 3-D context volume is ``(B, F0, C, h, w)``: channels F0 =
F // 3, depth = the C disparities (the JAX package's NDHWC ``(B, C, h, w,
F0)``).  Under bf16 the cost volumes' 3-D branch runs disparity-folded,
as the JAX package selects it on that dtype: ``(B, C*F0, H, W)`` with
channel ``c*F0 + f``, where ``Conv3D`` is one 2-D convolution with the
block-banded expansion of its 3-D kernel.  The branch's output goes back
to the reference channel order ``f*C + c`` before it meets the 2-D
branch.

``dense_warp`` is a shift-accumulate over the C disparities.  On the
CPU it is its plain twin, ``dense_warp_plain``: one in-place ``addcmul_``
per shift.  On the card it is one launch of codecs/csrc/dense_warp.cu,
bit-equal to the twin on bf16 (the running value rounded after every
shift), inside a ``torch.autograd.Function`` whose backward is the
twin's gradient formula in plain PyTorch.  It replaces no TPU kernel (the
JAX package leaves it to XLA to fuse).

Tracing (utils/tracing.py, entered only while a profiler records): each
``Conv3D`` and ``GroupNorm`` forward runs in a ``dsic/3-D branch`` or
``dsic/GroupNorm`` span, each ``dense_warp`` in ``dsic/dense_warp`` and
each ``upsample_bilinear_ac`` in ``dsic/upsampling``.  Each launch of
the dense warp's kernel leaves ``count/dense_warp_launches=1`` in its
span.

Stage 2 (``DSICPlus``): DSIC and a per-eye enhancement without warp or
cross-view input (``IndependentEnhancementNoWarp``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch import nn

from ..codecs import build
from ..entropy_models import EntropyBottleneck, GaussianMixtureConditional
from ..layers import GDN, Conv, Deconv, conv_gdn
from ..layers.conv import _kaiming_
from ..utils.tracing import count, span
from .hesic import (Enhancement, GmmHyperY1, GmmHyperY2, HyperEncoder,
                    Together)


class Conv3D(nn.Module):
    """5-D convolution over (B, I, D, H, W), zero padding k//2 in every axis
    (depth = disparity); ``weight`` is (O, I, kd, kh, kw).  A rank-4 input
    (B, D*I, H, W) in the disparity-major folded layout runs as one 2-D
    convolution with the band-expanded weight (``band_weight``): the band
    adds exact zeros, so the two layouts agree up to summation order."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 dtype=None, generator=None):
        super().__init__()
        k = kernel_size
        self.padding, self.dtype = k // 2, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, k))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        _kaiming_(self.weight, in_ch * k ** 3, generator)

    def band_weight(self, depth: int) -> torch.Tensor:
        """(depth*O, depth*I, kh, kw): output row m takes input row n
        through the kernel's depth tap t = n - m + k//2 (rows outside the
        band are zero, the depth axis' zero padding).  Each entry is one
        weight or an exact zero: a sum of products with 0/1 selectors."""
        o, i, k = self.weight.shape[:3]
        dev = self.weight.device
        t = torch.arange(k, device=dev)[:, None, None]
        m = torch.arange(depth, device=dev)[None, :, None]
        n = torch.arange(depth, device=dev)[None, None, :]
        sel = (n == m + t - self.padding).to(self.weight.dtype)
        taps = self.weight.permute(2, 0, 1, 3, 4)      # (t, O, I, kh, kw)
        band = (sel[:, :, None, :, None, None, None]
                * taps[:, None, :, None]).sum(0)       # (m, O, n, I, kh, kw)
        return band.reshape(depth * o, depth * i, k, k)

    def forward(self, x):
        with span("dsic/3-D branch"):
            d = self.dtype or x.dtype
            if x.dim() == 5:
                out = F.conv3d(x.to(d), self.weight.to(d),
                               padding=self.padding)
                return out + self.bias.to(d)[None, :, None, None, None]
            depth = x.shape[1] // self.weight.shape[1]
            out = F.conv2d(x.to(d), self.band_weight(depth).to(d),
                           padding=self.padding)
            return out + self.bias.repeat(depth).to(d)[None, :, None, None]


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm`` (``num_groups`` groups of contiguous
    channels on axis 1) and the JAX package's ``GroupNorm`` of the folded
    layout: an input of D times ``channels`` channels tiles ``weight`` and
    ``bias`` D times.  Statistics in at least float32 over each group's
    elements,
    variance as mean(x^2) - mean^2 (floored at 0), then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, cast to ``dtype``
    (None = the input's) at the end."""

    def __init__(self, channels: int, num_groups: int = 1,
                 eps: float = 1e-5, dtype=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        with span("dsic/GroupNorm"):
            b, c = x.shape[:2]
            g = self.num_groups
            folds = c // self.weight.shape[0]
            x32 = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
                b, g, c // g, -1)
            mean = x32.mean(dim=(2, 3), keepdim=True)
            var = torch.clamp_min((x32 * x32).mean(dim=(2, 3), keepdim=True)
                                  - mean * mean, 0.0)
            scale = self.weight.repeat(folds).reshape(1, g, c // g, 1)
            bias = self.bias.repeat(folds).reshape(1, g, c // g, 1)
            y = (x32 - mean) * (torch.rsqrt(var + self.eps) * scale) + bias
            return y.reshape(x.shape).to(self.dtype or x.dtype)


def _interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """1-D align_corners=True linear interpolation matrix (n_out, n_in),
    float32, built on `device` from comparisons (no host copy)."""
    if n_in == 1:
        return torch.ones(n_out, 1, device=device)
    pos = (torch.arange(n_out, dtype=torch.float32, device=device)
           * (n_in - 1) / (n_out - 1))
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_in - 2)
    fr = pos - lo.float()
    cols = torch.arange(n_in, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return (torch.where(cols == lo[:, None], (1.0 - fr)[:, None], zero)
            + torch.where(cols == lo[:, None] + 1, fr[:, None], zero))


def upsample_bilinear_ac(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(..., h, w) -> (..., h*scale, w*scale), align_corners=True bilinear
    (torch's UpsamplingBilinear2d), as the JAX package computes it: the
    interpolation matrices cast to the input's dtype, rows then columns,
    two products.  Serves the folded (B, C*F0, h, w) layout and the 5-D
    (B, F0, C, h, w) one alike."""
    with span("dsic/upsampling"):
        hy, wy = x.shape[-2:]
        mh = _interp_matrix(hy, hy * scale, x.device).to(x.dtype)
        mw = _interp_matrix(wy, wy * scale, x.device).to(x.dtype)
        return torch.matmul(torch.matmul(mh, x), mw.t())


def dense_warp_plain(h1: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Plain twin of the dense warp's kernel: h1 (B, N, H, W) features,
    cost (B, C, H, W) weights over C rightward shifts; out[..., w] =
    sum_d cost[:, d, :, w] * h1[..., w + d], zero beyond the right edge,
    one in-place ``addcmul_`` per shift in ascending d, so the running
    value is rounded to h1's dtype after every shift."""
    c, w = cost.shape[1], h1.shape[-1]
    h1p = F.pad(h1, (0, c - 1))
    out = torch.zeros_like(h1)
    for d in range(c):
        out.addcmul_(cost[:, d:d + 1], h1p[..., d:d + w])
    return out


DENSE_WARP_MAX_C = 32           # disparities the kernel takes
_DW_NAME = "dense_warp"


def _dense_warp_lib():
    lib = build.load(_DW_NAME)
    if not getattr(lib, "_hesic_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hesic_dense_warp.restype = ci
        lib.hesic_dense_warp.argtypes = [vp] * 3 + [ci] * 6 + [vp]
        lib._hesic_typed = True
    return lib


def dense_warp_cuda(h1: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The dense warp's kernel (codecs/csrc/dense_warp.cu) on the card:
    h1 (B, N, H, W) and cost (B, C, H, W), contiguous CUDA tensors of one
    dtype, bf16 or float32, 1 <= C <= DENSE_WARP_MAX_C; same contract as
    dense_warp_plain, bit-equal to it on bf16.  Forward only."""
    if h1.dim() != 4 or cost.dim() != 4:
        raise ValueError(f"dense_warp takes 4-D h1 and cost, got "
                         f"{tuple(h1.shape)} and {tuple(cost.shape)}")
    if h1.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dense_warp's kernel takes bf16 or float32, got "
                         f"{h1.dtype}")
    b, n, hh, w = h1.shape
    c = cost.shape[1]
    if not 1 <= c <= DENSE_WARP_MAX_C:
        raise ValueError(f"dense_warp's kernel takes 1 to "
                         f"{DENSE_WARP_MAX_C} disparities, got {c}")
    if tuple(cost.shape) != (b, c, hh, w):
        raise ValueError(f"cost must have shape {(b, c, hh, w)}, got "
                         f"{tuple(cost.shape)}")
    build.check_cuda_tensor(h1, "h1", h1.dtype)
    build.check_cuda_tensor(cost, "cost", h1.dtype)
    out = torch.empty_like(h1)
    stream = torch.cuda.current_stream(h1.device).cuda_stream
    rc = _dense_warp_lib().hesic_dense_warp(
        h1.data_ptr(), cost.data_ptr(), out.data_ptr(), b, n, c, hh, w,
        int(h1.dtype == torch.bfloat16), stream)
    build.check_status(rc, _DW_NAME, "B and H at most 65535")
    build.count_launch(_DW_NAME)
    count("dense_warp_launches", 1)
    return out


class DenseWarp(torch.autograd.Function):
    """The dense warp with a gradient to its costs only (the features are
    detached): forward the kernel on the card and the twin on the CPU;
    backward in plain PyTorch, as autograd takes it through the twin's
    loop: cost channel d gets (grad_out * h1 shifted left by d,
    zero-padded).sum(1)."""

    @staticmethod
    def forward(ctx, h1, cost):
        ctx.save_for_backward(h1)
        ctx.disparities = cost.shape[1]
        return (dense_warp_cuda if h1.is_cuda else dense_warp_plain)(h1, cost)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[1]:
            return None, None
        (h1,) = ctx.saved_tensors
        c, w = ctx.disparities, h1.shape[-1]
        h1p = F.pad(h1, (0, c - 1))
        return None, torch.stack([(grad_out * h1p[..., d:d + w]).sum(1)
                                  for d in range(c)], dim=1)


def dense_warp(h1: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Disparity-weighted horizontal shift-accumulate: h1 (B, N, H, W)
    features (detached: no gradient reaches them), cost (B, C, H, W)
    weights over C rightward shifts; out[..., w] = sum_d cost[:, d, :, w]
    * h1[..., w + d], zero beyond the right edge, summed d = 0..C-1 in the
    features' dtype.  The kernel (``DenseWarp``) for CUDA tensors, the
    plain twin on the CPU."""
    with span("dsic/dense_warp"):
        h1 = h1.detach()
        if h1.is_cuda:
            return DenseWarp.apply(h1, cost)
        return dense_warp_plain(h1, cost)


class Encoder1WithTaps(nn.Module):
    """Left-eye analysis returning (y1 float32, g1, g2, g3): the latent and
    the three GDN activations the right-eye encoder warps."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.Conv_0, self.GDN_0 = Conv(3, n, **kw), GDN(n, dtype=dtype)
        self.Conv_1, self.GDN_1 = Conv(n, n, **kw), GDN(n, dtype=dtype)
        self.Conv_2, self.GDN_2 = Conv(n, n, **kw), GDN(n, dtype=dtype)
        self.Conv_3 = Conv(n, m, **kw)

    def forward(self, x):
        g1 = conv_gdn(self.Conv_0, self.GDN_0, x)
        g2 = conv_gdn(self.Conv_1, self.GDN_1, g1)
        g3 = conv_gdn(self.Conv_2, self.GDN_2, g2)
        return self.Conv_3(g3).float(), g1, g2, g3


class Decoder1WithTaps(nn.Module):
    """Left-eye synthesis returning (x1_hat float32, g4, g5, g6): the
    reconstruction and the three IGDN activations the right-eye decoder
    warps."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.Deconv_0 = Deconv(m, n, **kw)
        self.GDN_0 = GDN(n, inverse=True, dtype=dtype)
        self.Deconv_1 = Deconv(n, n, **kw)
        self.GDN_1 = GDN(n, inverse=True, dtype=dtype)
        self.Deconv_2 = Deconv(n, n, **kw)
        self.GDN_2 = GDN(n, inverse=True, dtype=dtype)
        self.Deconv_3 = Deconv(n, 3, **kw)

    def forward(self, y_hat):
        g4 = conv_gdn(self.Deconv_0, self.GDN_0, y_hat)
        g5 = conv_gdn(self.Deconv_1, self.GDN_1, g4)
        g6 = conv_gdn(self.Deconv_2, self.GDN_2, g5)
        return self.Deconv_3(g6).float(), g4, g5, g6


class GlobalContext(nn.Module):
    """Four 5x5 stride-1 convs at F*C channels (GroupNorm of F groups and
    ReLU between them) on y1_hat; returns three context volumes (B, F0, C,
    h, w) from the reference's (3, F0, C) channel split."""

    def __init__(self, m=192, f=21, c=32, dtype=None, generator=None):
        super().__init__()
        self.F, self.C = f, c
        fc = f * c
        kw = dict(stride=1, dtype=dtype, generator=generator)
        self.Conv_0 = Conv(m, fc, **kw)
        self.GroupNorm_0 = GroupNorm(fc, f, dtype=dtype)
        self.Conv_1 = Conv(fc, fc, **kw)
        self.GroupNorm_1 = GroupNorm(fc, f, dtype=dtype)
        self.Conv_2 = Conv(fc, fc, **kw)
        self.GroupNorm_2 = GroupNorm(fc, f, dtype=dtype)
        self.Conv_3 = Conv(fc, fc, **kw)

    def forward(self, y1_hat):
        x = F.relu(self.GroupNorm_0(self.Conv_0(y1_hat)))
        x = F.relu(self.GroupNorm_1(self.Conv_1(x)))
        x = F.relu(self.GroupNorm_2(self.Conv_2(x)))
        x = self.Conv_3(x)
        b, _, h, w = x.shape
        x = x.reshape(b, 3, self.F // 3, self.C, h, w)
        return x[:, 0], x[:, 1], x[:, 2]


class CostVolume(nn.Module):
    """Disparity cost volume (B, C, H, W), softmaxed over the C disparity
    channels, from left/right features h1, h2 (B, N, H, W) and a context
    volume d (B, F0, C, H/scale, W/scale).  Under bf16 the 3-D branch runs
    disparity-folded (the JAX package's choice for that dtype)."""

    def __init__(self, n=128, scale=2, f=21, c=32, dtype=None,
                 generator=None):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        self.fold = dtype == torch.bfloat16
        f0 = f // 3
        kw = dict(stride=1, dtype=dtype, generator=generator)
        self.Conv_0 = Conv(2 * n, n, **kw)
        self.GroupNorm_0 = GroupNorm(n, 4, dtype=dtype)
        self.Conv_1 = Conv(n, n, **kw)
        self.GroupNorm_1 = GroupNorm(n, 4, dtype=dtype)
        self.Conv3D_0 = Conv3D(f0, f0, dtype=dtype, generator=generator)
        self.GroupNorm_2 = GroupNorm(f0, 1, dtype=dtype)
        self.Conv3D_1 = Conv3D(f0, f0, dtype=dtype, generator=generator)
        self.GroupNorm_3 = GroupNorm(f0, 1, dtype=dtype)
        self.Conv_2 = Conv(n + f0 * c, n, **kw)
        self.GroupNorm_4 = GroupNorm(n, 4, dtype=dtype)
        self.Conv_3 = Conv(n, n, **kw)
        self.GroupNorm_5 = GroupNorm(n, 4, dtype=dtype)
        self.Conv_4 = Conv(n, c, **kw)

    def branch3d(self, d):
        """The 3-D branch on context volume d (B, F0, C, h, w): upsample,
        (Conv3D, GroupNorm, ReLU) twice -> (B, F0*C, H, W), channel
        f*C + c."""
        b, f0, c, hy, wy = d.shape
        hh, ww = hy * self.scale, wy * self.scale
        if self.fold:
            x = d.transpose(1, 2).reshape(b, c * f0, hy, wy)
        else:
            x = d
        x = upsample_bilinear_ac(x, self.scale)
        x = F.relu(self.GroupNorm_2(self.Conv3D_0(x)))
        x = F.relu(self.GroupNorm_3(self.Conv3D_1(x)))
        if self.fold:   # disparity-major c*F0 + f -> f*C + c
            x = x.reshape(b, c, f0, hh, ww).transpose(1, 2)
        return x.reshape(b, f0 * c, hh, ww)

    def forward(self, h1, h2, d):
        dt = self.dtype
        h = torch.cat([h1.to(dt or h1.dtype), h2.to(dt or h2.dtype)], dim=1)
        h = F.relu(self.GroupNorm_0(self.Conv_0(h)))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        x = torch.cat([h, self.branch3d(d).to(h.dtype)], dim=1)
        x = F.relu(self.GroupNorm_4(self.Conv_2(x)))
        x = F.relu(self.GroupNorm_5(self.Conv_3(x)))
        return torch.softmax(self.Conv_4(x), dim=1)


class DSIC(nn.Module):
    """The DSIC model, N=128, M=192, F=21, C=32, K=5 by default.

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)``, moved to ``device`` and built with gradients off, as HESIC's
    (``training.make_optimizer`` turns them on for what it trains).
    DSIC takes no homography."""

    entropy_bottlenecks = ("entropy_bottleneck1", "entropy_bottleneck2")
    single_image = False
    uses_homography = False

    def __init__(self, N: int = 128, M: int = 192, F: int = 21, C: int = 32,
                 K: int = 5, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        self.N, self.M, self.F, self.C, self.K = N, M, F, C, K
        self.dtype = dtype
        g = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, generator=g)
        n, m = N, M
        self.encoder1 = Encoder1WithTaps(n, m, **kw)
        self.decoder1 = Decoder1WithTaps(n, m, **kw)
        self.pic2_g_a_conv1 = Conv(3, n, **kw)
        self.pic2_g_a_gdn1 = GDN(n, dtype=dtype)
        self.pic2_g_a_conv2 = Conv(2 * n, n, **kw)
        self.pic2_g_a_gdn2 = GDN(n, dtype=dtype)
        self.pic2_g_a_conv3 = Conv(2 * n, n, **kw)
        self.pic2_g_a_gdn3 = GDN(n, dtype=dtype)
        self.pic2_g_a_conv4 = Conv(2 * n, m, **kw)
        self.pic2_g_s_conv1 = Deconv(m, n, **kw)
        self.pic2_g_s_gdn1 = GDN(n, inverse=True, dtype=dtype)
        self.pic2_g_s_conv2 = Deconv(2 * n, n, **kw)
        self.pic2_g_s_gdn2 = GDN(n, inverse=True, dtype=dtype)
        self.pic2_g_s_conv3 = Deconv(2 * n, n, **kw)
        self.pic2_g_s_gdn3 = GDN(n, inverse=True, dtype=dtype)
        self.pic2_g_s_conv4 = Deconv(2 * n, 3, **kw)
        self.global_context = GlobalContext(m, F, C, **kw)
        for i, scale in enumerate((8, 4, 2, 2, 4, 8), start=1):
            setattr(self, f"cost_volume{i}",
                    CostVolume(n, scale, F, C, **kw))
        self.h_a1 = HyperEncoder(n, m, **kw)
        self.h_a2 = HyperEncoder(n, m, **kw)
        self.h_s1 = GmmHyperY1(n, m, K, **kw)
        self.h_s2 = GmmHyperY2(n, m, K, **kw)
        self.entropy_bottleneck1 = EntropyBottleneck(n, generator=g)
        self.entropy_bottleneck2 = EntropyBottleneck(n, generator=g)
        self.gaussian1 = GaussianMixtureConditional(K)
        self.gaussian2 = GaussianMixtureConditional(K)
        self.to(device)
        self.requires_grad_(False)

    def aux_loss(self) -> torch.Tensor:
        return (self.entropy_bottleneck1.loss()
                + self.entropy_bottleneck2.loss())

    # ---- codec-facing sub-programs ----

    def analysis1(self, x1):
        """-> (y1, g1_1, g1_2, g1_3)."""
        return self.encoder1(x1)

    def synthesis1(self, y1_hat):
        """-> (x1_hat, g1_4, g1_5, g1_6)."""
        return self.decoder1(y1_hat)

    def hyper_analysis1(self, y1):
        return self.h_a1(y1)

    def hyper_analysis2(self, y2):
        return self.h_a2(y2)

    def gmm1(self, z1_hat):
        return self.h_s1(z1_hat)

    def gmm2(self, z2_hat, y1_hat):
        return self.h_s2(z2_hat, y1_hat)

    def contexts(self, y1_hat):
        return self.global_context(y1_hat)

    def analysis2(self, x2, g1_1, g1_2, g1_3, contexts):
        """Right-eye encoder with cost-volume warps of the left encoder's
        taps -> y2 float32."""
        a1 = conv_gdn(self.pic2_g_a_conv1, self.pic2_g_a_gdn1, x2)
        warp1 = dense_warp(g1_1, self.cost_volume1(g1_1, a1, contexts[0]))
        a2 = conv_gdn(self.pic2_g_a_conv2, self.pic2_g_a_gdn2,
                      torch.cat([warp1, a1], dim=1))
        warp2 = dense_warp(g1_2, self.cost_volume2(g1_2, a2, contexts[1]))
        a3 = conv_gdn(self.pic2_g_a_conv3, self.pic2_g_a_gdn3,
                      torch.cat([warp2, a2], dim=1))
        warp3 = dense_warp(g1_3, self.cost_volume3(g1_3, a3, contexts[2]))
        return self.pic2_g_a_conv4(torch.cat([warp3, a3], dim=1)).float()

    def synthesis2(self, y2_hat, g1_4, g1_5, g1_6, contexts):
        """Right-eye decoder with cost-volume warps of the left decoder's
        taps -> x2_hat float32."""
        s1 = conv_gdn(self.pic2_g_s_conv1, self.pic2_g_s_gdn1, y2_hat)
        warp4 = dense_warp(g1_4, self.cost_volume4(g1_4, s1, contexts[2]))
        s2 = conv_gdn(self.pic2_g_s_conv2, self.pic2_g_s_gdn2,
                      torch.cat([warp4, s1], dim=1))
        warp5 = dense_warp(g1_5, self.cost_volume5(g1_5, s2, contexts[1]))
        s3 = conv_gdn(self.pic2_g_s_conv3, self.pic2_g_s_gdn3,
                      torch.cat([warp5, s2], dim=1))
        warp6 = dense_warp(g1_6, self.cost_volume6(g1_6, s3, contexts[0]))
        return self.pic2_g_s_conv4(torch.cat([warp6, s3], dim=1)).float()

    def forward(self, x1, x2, training: bool = False, generator=None):
        """x1, x2 (B, 3, H, W) float32 views -> {"x1_hat", "x2_hat",
        "y1_hat", "y2_hat", "likelihoods": {"y1", "y2", "z1", "z2"}},
        NCHW float32.  Training draws the noise of the four quantizations
        from `generator`, in the JAX package's order z1, y1, z2, y2; eval
        rounds.  The right eye's prior is the un-warped left latent."""
        y1, g1_1, g1_2, g1_3 = self.encoder1(x1)
        z1_hat, z1_lik = self.entropy_bottleneck1(self.h_a1(y1), training,
                                                  generator)
        sigma1, means1, weights1 = self.h_s1(z1_hat)
        y1_hat, y1_lik = self.gaussian1(y1, sigma1, means1, weights1,
                                        training, generator)
        x1_hat, g1_4, g1_5, g1_6 = self.decoder1(y1_hat)
        contexts = self.global_context(y1_hat)
        y2 = self.analysis2(x2, g1_1, g1_2, g1_3, contexts)
        z2_hat, z2_lik = self.entropy_bottleneck2(self.h_a2(y2), training,
                                                  generator)
        sigma2, means2, weights2 = self.h_s2(z2_hat, y1_hat)
        y2_hat, y2_lik = self.gaussian2(y2, sigma2, means2, weights2,
                                        training, generator)
        x2_hat = self.synthesis2(y2_hat, g1_4, g1_5, g1_6, contexts)
        return {"x1_hat": x1_hat, "x2_hat": x2_hat, "y1_hat": y1_hat,
                "y2_hat": y2_hat,
                "likelihoods": {"y1": y1_lik, "y2": y2_lik, "z1": z1_lik,
                                "z2": z2_lik}}


class EnhancementSelf(Enhancement):
    """Single-view enhancement (DSIC+'s): models/hesic.py ``Enhancement``
    without the cross-view input, its first conv 3 -> 32, forward on one
    reconstruction."""

    def __init__(self, generator=None):
        super().__init__(False, generator)


class IndependentEnhancementNoWarp(nn.Module):
    """DSIC+'s stage 2: each eye enhanced on its own (EnhancementSelf)."""

    def __init__(self, generator=None):
        super().__init__()
        self.EnhancementSelf_0 = EnhancementSelf(generator)
        self.EnhancementSelf_1 = EnhancementSelf(generator)

    def forward(self, x1_hat, x2_hat):
        return {"x1_hat": self.EnhancementSelf_0(x1_hat),
                "x2_hat": self.EnhancementSelf_1(x2_hat)}


class DSICPlus(Together):
    """DSIC and its stage-2 enhancement, N=128, M=192, F=21, C=32, K=5 by
    default.  ``m1`` takes an existing DSIC to enhance instead of a new
    one."""

    def __init__(self, N: int = 128, M: int = 192, F: int = 21, C: int = 32,
                 K: int = 5, dtype=None, device="cuda", seed: int = 0,
                 m1=None):
        super().__init__()
        m1 = m1 if m1 is not None else DSIC(N, M, F, C, K, dtype, device,
                                            seed)
        self._attach(m1, IndependentEnhancementNoWarp(
            torch.Generator().manual_seed(seed)))
        self.F, self.C, self.K = m1.F, m1.C, m1.K
