"""Plain float32 reference of DSIC (Liu, Wang and Urtasun, "DSIC: Deep
Stereo Image Compression", ICCV 2019; the authors' code
``ywz/DSIC/mynet6.py``), N=128, M=192, F=21, C=32, K=5.

The right view is coded by warping the left encoder's and decoder's
features with learned disparity distributions: softmax cost volumes over
C rightward shifts, each from a 2-D branch on both eyes' features and a
3-D branch (``conv3d``) on a global context of the rounded left latent.
Both eyes' latents take GMM hyperpriors; the right head conditions on the
left latent.  Parameter names are the program's.  As the program: the
GMM weights are pooled over space, the 3-D context volumes are
upsampled with align_corners=True bilinear interpolation, and the y
latents are rounded without their means.

Functions the harness calls: as ``hesic-n128-m192.py``; ``analysis``
takes the left latent the right encoder's contexts are built from.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (GDN, Cast, Conv, Deconv,
                                        EntropyBottleneck, GmmHyperY1,
                                        GmmHyperY2, HyperEncoder,
                                        gmm_likelihood, matmul, z_hat,
                                        z_symbols)


class Conv3D(Cast):
    """conv3d over (B, I, D, H, W), zero padding k // 2 in every axis."""

    def __init__(self, cin, cout, k=5, device=None):
        super().__init__()
        self.padding = k // 2
        self.fan_in = cin * k ** 3
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.conv3d(self.c(x), self.c(self.weight), self.bias,
                        padding=self.padding)


class GroupNorm(nn.Module):
    """Groups of contiguous channels; variance as E[x^2] - E[x]^2
    (floored at 0), eps 1e-5."""

    def __init__(self, channels, groups, device=None):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        b, c = x.shape[:2]
        g = self.groups
        v = x.reshape(b, g, c // g, -1)
        mean = v.mean(dim=(2, 3), keepdim=True)
        var = torch.clamp_min((v * v).mean(dim=(2, 3), keepdim=True)
                              - mean * mean, 0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = ((v - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) align_corners=True linear interpolation."""
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


class Upsample(Cast):
    def forward(self, x, scale):
        hy, wy = x.shape[-2:]
        mh = interp_matrix(hy, hy * scale, x.device)
        mw = interp_matrix(wy, wy * scale, x.device)
        return matmul(self, matmul(self, mh, x), mw.t())


def dense_warp(h1, cost):
    """out[..., w] = sum_d cost[:, d, :, w] * h1[..., w + d], zero beyond
    the right edge; no gradient reaches h1."""
    h1 = h1.detach()
    c, w = cost.shape[1], h1.shape[-1]
    h1p = F.pad(h1, (0, c - 1))
    out = torch.zeros_like(h1)
    for d in range(c):
        out = out + cost[:, d:d + 1] * h1p[..., d:d + w]
    return out


class EncoderTaps(nn.Module):
    def __init__(self, n, m, device):
        super().__init__()
        kw = dict(device=device)
        self.Conv_0, self.GDN_0 = Conv(3, n, **kw), GDN(n, **kw)
        self.Conv_1, self.GDN_1 = Conv(n, n, **kw), GDN(n, **kw)
        self.Conv_2, self.GDN_2 = Conv(n, n, **kw), GDN(n, **kw)
        self.Conv_3 = Conv(n, m, **kw)

    def forward(self, x):
        g1 = self.GDN_0(self.Conv_0(x))
        g2 = self.GDN_1(self.Conv_1(g1))
        g3 = self.GDN_2(self.Conv_2(g2))
        return self.Conv_3(g3), g1, g2, g3


class DecoderTaps(nn.Module):
    def __init__(self, n, m, device):
        super().__init__()
        kw = dict(device=device)
        self.Deconv_0, self.GDN_0 = Deconv(m, n, **kw), GDN(n, True, **kw)
        self.Deconv_1, self.GDN_1 = Deconv(n, n, **kw), GDN(n, True, **kw)
        self.Deconv_2, self.GDN_2 = Deconv(n, n, **kw), GDN(n, True, **kw)
        self.Deconv_3 = Deconv(n, 3, **kw)

    def forward(self, y):
        g4 = self.GDN_0(self.Deconv_0(y))
        g5 = self.GDN_1(self.Deconv_1(g4))
        g6 = self.GDN_2(self.Deconv_2(g5))
        return self.Deconv_3(g6), g4, g5, g6


class GlobalContext(nn.Module):
    def __init__(self, m, f, c, device):
        super().__init__()
        self.F, self.C = f, c
        fc, kw = f * c, dict(stride=1, device=device)
        self.Conv_0 = Conv(m, fc, **kw)
        self.GroupNorm_0 = GroupNorm(fc, f, device)
        self.Conv_1 = Conv(fc, fc, **kw)
        self.GroupNorm_1 = GroupNorm(fc, f, device)
        self.Conv_2 = Conv(fc, fc, **kw)
        self.GroupNorm_2 = GroupNorm(fc, f, device)
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
    def __init__(self, n, scale, f, c, device):
        super().__init__()
        self.scale = scale
        f0, kw = f // 3, dict(stride=1, device=device)
        self.Conv_0 = Conv(2 * n, n, **kw)
        self.GroupNorm_0 = GroupNorm(n, 4, device)
        self.Conv_1 = Conv(n, n, **kw)
        self.GroupNorm_1 = GroupNorm(n, 4, device)
        self.Conv3D_0 = Conv3D(f0, f0, device=device)
        self.GroupNorm_2 = GroupNorm(f0, 1, device)
        self.Conv3D_1 = Conv3D(f0, f0, device=device)
        self.GroupNorm_3 = GroupNorm(f0, 1, device)
        self.Conv_2 = Conv(n + f0 * c, n, **kw)
        self.GroupNorm_4 = GroupNorm(n, 4, device)
        self.Conv_3 = Conv(n, n, **kw)
        self.GroupNorm_5 = GroupNorm(n, 4, device)
        self.Conv_4 = Conv(n, c, **kw)
        self.up = Upsample()

    def forward(self, h1, h2, d):
        h = torch.cat([h1, h2], dim=1)
        h = F.relu(self.GroupNorm_0(self.Conv_0(h)))
        h = F.relu(self.GroupNorm_1(self.Conv_1(h)))
        b, f0, c, hy, wy = d.shape
        x = self.up(d, self.scale)
        x = F.relu(self.GroupNorm_2(self.Conv3D_0(x)))
        x = F.relu(self.GroupNorm_3(self.Conv3D_1(x)))
        x = x.reshape(b, f0 * c, hy * self.scale, wy * self.scale)
        x = torch.cat([h, x], dim=1)
        x = F.relu(self.GroupNorm_4(self.Conv_2(x)))
        x = F.relu(self.GroupNorm_5(self.Conv_3(x)))
        return torch.softmax(self.Conv_4(x), dim=1)


class DSIC(nn.Module):
    def __init__(self, n, m, f, c, k, device=None):
        super().__init__()
        self.K = k
        kw = dict(device=device)
        self.encoder1 = EncoderTaps(n, m, device)
        self.decoder1 = DecoderTaps(n, m, device)
        self.pic2_g_a_conv1 = Conv(3, n, **kw)
        self.pic2_g_a_gdn1 = GDN(n, **kw)
        self.pic2_g_a_conv2 = Conv(2 * n, n, **kw)
        self.pic2_g_a_gdn2 = GDN(n, **kw)
        self.pic2_g_a_conv3 = Conv(2 * n, n, **kw)
        self.pic2_g_a_gdn3 = GDN(n, **kw)
        self.pic2_g_a_conv4 = Conv(2 * n, m, **kw)
        self.pic2_g_s_conv1 = Deconv(m, n, **kw)
        self.pic2_g_s_gdn1 = GDN(n, True, **kw)
        self.pic2_g_s_conv2 = Deconv(2 * n, n, **kw)
        self.pic2_g_s_gdn2 = GDN(n, True, **kw)
        self.pic2_g_s_conv3 = Deconv(2 * n, n, **kw)
        self.pic2_g_s_gdn3 = GDN(n, True, **kw)
        self.pic2_g_s_conv4 = Deconv(2 * n, 3, **kw)
        self.global_context = GlobalContext(m, f, c, device)
        for i, scale in enumerate((8, 4, 2, 2, 4, 8), start=1):
            setattr(self, f"cost_volume{i}", CostVolume(n, scale, f, c,
                                                        device))
        self.h_a1, self.h_a2 = (HyperEncoder(n, m, device)
                                for _ in range(2))
        self.h_s1 = GmmHyperY1(n, m, k, device)
        self.h_s2 = GmmHyperY2(n, m, k, device)
        self.entropy_bottleneck1 = EntropyBottleneck(n, device)
        self.entropy_bottleneck2 = EntropyBottleneck(n, device)

    def analysis2(self, x2, g1, g2, g3, ctx):
        a1 = self.pic2_g_a_gdn1(self.pic2_g_a_conv1(x2))
        w1 = dense_warp(g1, self.cost_volume1(g1, a1, ctx[0]))
        a2 = self.pic2_g_a_gdn2(self.pic2_g_a_conv2(torch.cat([w1, a1], 1)))
        w2 = dense_warp(g2, self.cost_volume2(g2, a2, ctx[1]))
        a3 = self.pic2_g_a_gdn3(self.pic2_g_a_conv3(torch.cat([w2, a2], 1)))
        w3 = dense_warp(g3, self.cost_volume3(g3, a3, ctx[2]))
        return self.pic2_g_a_conv4(torch.cat([w3, a3], 1))

    def synthesis2(self, y2, g4, g5, g6, ctx):
        s1 = self.pic2_g_s_gdn1(self.pic2_g_s_conv1(y2))
        w4 = dense_warp(g4, self.cost_volume4(g4, s1, ctx[2]))
        s2 = self.pic2_g_s_gdn2(self.pic2_g_s_conv2(torch.cat([w4, s1], 1)))
        w5 = dense_warp(g5, self.cost_volume5(g5, s2, ctx[1]))
        s3 = self.pic2_g_s_gdn3(self.pic2_g_s_conv3(torch.cat([w5, s2], 1)))
        w6 = dense_warp(g6, self.cost_volume6(g6, s3, ctx[0]))
        return self.pic2_g_s_conv4(torch.cat([w6, s3], 1))


def build(cfg: dict, device) -> DSIC:
    w = cfg["widths"]
    return DSIC(w["N"], w["M"], w["F"], w["C"], w["K"], device)


def analysis(model, x1, x2, h, y1_hat=None):
    """-> (y1, y2); the right encoder's contexts come from `y1_hat` (the
    program's decoded left latent when judging it), else from round(y1).
    DSIC takes no homography."""
    y1, g1, g2, g3 = model.encoder1(x1)
    ctx = model.global_context(torch.round(y1) if y1_hat is None
                               else y1_hat)
    return y1, model.analysis2(x2, g1, g2, g3, ctx)


def synthesis(model, y1_hat, y2_hat, h):
    x1_hat, g4, g5, g6 = model.decoder1(y1_hat)
    ctx = model.global_context(y1_hat)
    return x1_hat, model.synthesis2(y2_hat, g4, g5, g6, ctx)


def hyper(model, y1, y2):
    """(z1, z2): both eyes' hyper-latent symbols of the latents y1, y2,
    as the encoder codes them."""
    return (z_symbols(model.entropy_bottleneck1, y1, model.h_a1),
            z_symbols(model.entropy_bottleneck2, y2, model.h_a2))


def conditioning(model, z1, z2, h, y1_hat):
    """Both eyes' GMM heads (sigma, means, weights), as the decoder of a
    pair computes them from the hyper-latent symbols z1, z2: the left
    head on z1; the right head on z2 and the decoded left latent
    `y1_hat`."""
    return (model.h_s1(z_hat(model.entropy_bottleneck1, z1)),
            model.h_s2(z_hat(model.entropy_bottleneck2, z2), y1_hat))


def round_trip(model, x1, x2, h):
    """The programs of one encode and decode, as the codec runs them: the
    encoder's transforms and contexts, both GMM heads on each side, and
    the decoder's left synthesis, contexts and right synthesis."""
    y1, y2 = analysis(model, x1, x2, h)
    y1_hat, y2_hat = torch.round(y1), torch.round(y2)
    z1 = torch.round(model.h_a1(y1))
    z2 = torch.round(model.h_a2(y2))
    for _ in range(2):
        model.h_s1(z1)
        model.h_s2(z2, y1_hat)
    return synthesis(model, y1_hat, y2_hat, h)


def train_forward(model, x1, x2, h, noise):
    """The training forward, noise for z1, y1, z2, y2 -> (x1_hat, x2_hat,
    [likelihoods])."""
    y1, g1, g2, g3 = model.encoder1(x1)
    z1 = model.h_a1(y1)
    z1_t, z1_lik = model.entropy_bottleneck1(z1, noise(z1))
    sigma, means, weights = model.h_s1(z1_t)
    y1_t = y1 + noise(y1)
    y1_lik = gmm_likelihood(y1_t, sigma, means, weights, model.K)
    x1_hat, g4, g5, g6 = model.decoder1(y1_t)
    ctx = model.global_context(y1_t)
    y2 = model.analysis2(x2, g1, g2, g3, ctx)
    z2 = model.h_a2(y2)
    z2_t, z2_lik = model.entropy_bottleneck2(z2, noise(z2))
    sigma, means, weights = model.h_s2(z2_t, y1_t)
    y2_t = y2 + noise(y2)
    y2_lik = gmm_likelihood(y2_t, sigma, means, weights, model.K)
    x2_hat = model.synthesis2(y2_t, g4, g5, g6, ctx)
    return x1_hat, x2_hat, [y1_lik, y2_lik, z1_lik, z2_lik]
