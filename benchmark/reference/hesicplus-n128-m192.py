"""Plain float32 reference of HESIC+ (Deng et al., "Deep Homography for
Efficient Stereo Image Compression", CVPR 2021, the paper's best
rate-distortion model; the authors' code ``ywz/mywork/newnet1_joint.py``:
the model at :585-750), N=128, M=192.

HESIC's transforms and warp, and on each eye a joint autoregressive
prior: a hyperprior (``h_a``, ``h_s``), a 5x5 mask-A context model and a
1x1 entropy-parameter stack 4M -> 10M/3 -> 8M/3 -> 2M (the right eye's
takes 5M: cat(hyper, context, the decoded left view warped by H and
re-encoded, rounded)), whose output gives one Gaussian a latent: scales
(at least 0.11), then means.  Parameter names are the program's
(``h_a1_0``, ``context_prediction2``, ``entropy_parameters2_4``, ...), so
one state dict loads into both.

Departures from the authors' code, as the program has them: the warp is
bilinear with zero padding; the hyper-analysis has no abs; activations
are leaky_relu (slope 0.01) between the stacks' layers; the latents are
coded as residuals round(y - mean) around the context model's means, so
the quantised latent is that residual plus the mean.  The context model
is the 12 taps that mask A keeps (the two rows above, the two left
neighbours), computed as two products over those taps only, which is
also what the FLOP count counts.

Functions the harness calls (every tensor NCHW float32):
``build(cfg, device)``, ``analysis(model, x1, x2, h, y1_hat)``,
``synthesis(model, y1_hat, y2_hat, h)``, ``hyper(model, y1, y2)``,
``conditioning(model, z1, z2, h, y1_hat, y2_hat)``, ``train_forward(model,
x1, x2, h, noise)``, ``round_trip(model, x1, x2, h)``; and for the
coder (``benchmark/coders/wavefront.py``) ``eye_params`` and
``level_scan``.  ``analysis`` keeps the chunk's homographies and the
decoded left latents it was given on the model (``model.analysed``),
because the coder's quantisation, which the harness calls next with an
eye's latents alone, reads both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (SCALE_BOUND, Cast, Conv, Deconv,
                                        EntropyBottleneck, Stack, dec_layers,
                                        enc_layers, lower_bound, std_cdf,
                                        warp, z_hat, z_symbols)

LIKELIHOOD_BOUND = 1e-9


class Decoder2(Stack):
    """Right synthesis: the stack with a final IGDN, then a 6 -> 3 fusion
    deconv (stride 1) on cat(it, the warped left reconstruction)."""

    def __init__(self, n, m, device=None):
        super().__init__(dec_layers(m, n, device, final_gdn=True)
                         + [("Deconv_4", Deconv(6, 3, stride=1,
                                                device=device))])

    def forward(self, y, x1_hat_warp):
        *stack, fuse = self.children()
        for layer in stack:
            y = layer(y)
        return fuse(torch.cat([y, x1_hat_warp], dim=1))


class MaskedContext(Cast):
    """The 5x5 mask-A context model, M -> 2M: the kept taps are the two
    rows above (5 columns each) and the two left neighbours, summed as one
    product over the rows above and one over the left neighbours.  The
    weight keeps the full 5x5 layout (the program's); its other taps are
    never read."""

    def __init__(self, m, device=None):
        super().__init__()
        self.fan_in = m * 25
        self.weight = nn.Parameter(torch.zeros(2 * m, m, 5, 5,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(2 * m, device=device))

    def forward(self, y):
        x, w = self.c(y), self.c(self.weight)
        above = F.conv2d(F.pad(x, (2, 2, 2, -1)), w[:, :, :2, :])
        left = F.conv2d(F.pad(x, (2, -1, 0, 0)), w[:, :, 2:3, :2])
        return above + left + self.bias[None, :, None, None]


def _stack(n_in, n_out, widths, kernels, strides, deconv, device):
    return [(i, (Deconv if d else Conv)(a, b, kernel_size=k, stride=s,
                                        device=device))
            for i, (a, b, k, s, d) in enumerate(zip(
                [n_in] + widths, widths + [n_out], kernels, strides,
                deconv))]


class HESICPlus(nn.Module):
    def __init__(self, n, m, device=None):
        super().__init__()
        self.M = m
        self.encoder1 = Stack(enc_layers(3, n, m, device))
        self.encoder2 = Stack(enc_layers(6, n, m, device, pre_fuse=True))
        self.decoder1 = Stack(dec_layers(m, n, device))
        self.decoder2 = Decoder2(n, m, device)
        for eye in (1, 2):
            stacks = {
                f"h_a{eye}": _stack(m, n, [n, n], (3, 5, 5), (1, 2, 2),
                                    (0, 0, 0), device),
                f"h_s{eye}": _stack(n, 2 * m, [m, m * 3 // 2], (5, 5, 3),
                                    (2, 2, 1), (1, 1, 0), device),
                f"entropy_parameters{eye}": _stack(
                    (4 if eye == 1 else 5) * m, 2 * m,
                    [m * 10 // 3, m * 8 // 3], (1, 1, 1), (1, 1, 1),
                    (0, 0, 0), device)}
            for prefix, layers in stacks.items():
                for i, layer in layers:
                    self.add_module(f"{prefix}_{2 * i}", layer)
            self.add_module(f"context_prediction{eye}",
                            MaskedContext(m, device))
            self.add_module(f"entropy_bottleneck{eye}",
                            EntropyBottleneck(n, device))
        self.analysed = None


def stack(model, prefix: str, x):
    """A program stack: layer, leaky_relu(0.01), layer, leaky_relu, layer."""
    for i in range(3):
        if i:
            x = F.leaky_relu(x, 0.01)
        x = getattr(model, f"{prefix}_{2 * i}")(x)
    return x


def build(cfg: dict, device) -> HESICPlus:
    w = cfg["widths"]
    return HESICPlus(w["N"], w["M"], device)


def analysis(model, x1, x2, h, y1_hat=None):
    """-> (y1, y2): both eyes' latents before quantisation.  Keeps (h,
    y1_hat), the decoded left latents when given, as ``model.analysed``
    for the coder's quantisation of these latents."""
    model.analysed = (h, y1_hat)
    y1 = model.encoder1(x1)
    y2 = model.encoder2(torch.cat([warp(x1, h), x2], dim=1))
    return y1, y2


def synthesis(model, y1_hat, y2_hat, h):
    """The reconstructions (x1_hat, x2_hat) of given latents."""
    x1_hat = model.decoder1(y1_hat)
    return x1_hat, model.decoder2(y2_hat, warp(x1_hat, h))


def hyper_eye(model, eye: int, y):
    """One eye's hyper-latent symbols of its latents `y`, as the encoder
    codes them."""
    return z_symbols(getattr(model, f"entropy_bottleneck{eye}"), y,
                     lambda t: stack(model, f"h_a{eye}", t))


def hyper(model, y1, y2):
    """(z1, z2): both eyes' hyper-latent symbols."""
    return hyper_eye(model, 1, y1), hyper_eye(model, 2, y2)


def left_prior(model, y1_hat, h):
    """The right eye's extra input: the decoded left view (the synthesis
    of `y1_hat`) warped by H, re-encoded and rounded."""
    return torch.round(model.encoder1(warp(model.decoder1(y1_hat), h)))


def hyper_params(model, eye: int, z):
    """The hyper-synthesis of the eye's symbols `z`: the entropy
    parameters' first 2M inputs."""
    return stack(model, f"h_s{eye}",
                 z_hat(getattr(model, f"entropy_bottleneck{eye}"), z))


def eye_params(model, eye: int, pre, y_hat, post=None):
    """(scales, means) of an eye from its hyper-synthesis `pre`, the
    latents `y_hat` the context model reads (causally) and, for the right
    eye, the left prior `post`; scales before their 0.11 floor."""
    ctx = getattr(model, f"context_prediction{eye}")(y_hat)
    g = stack(model, f"entropy_parameters{eye}",
              torch.cat([pre, ctx] + ([post] if post is not None else []),
                        dim=1))
    return g[:, :model.M], g[:, model.M:]


def conditioning(model, z1, z2, h, y1_hat, y2_hat):
    """Both eyes' (scales at least 0.11, means), as the decoder of a pair
    computes them from the hyper-latent symbols z1, z2 and the decoded
    latents y1_hat, y2_hat: one masked convolution over each eye's
    latents, which the causal mask makes equal to the raster order."""
    out = []
    for eye, z, y_hat, post in ((1, z1, y1_hat, None),
                                (2, z2, y2_hat,
                                 left_prior(model, y1_hat, h))):
        s, mu = eye_params(model, eye, hyper_params(model, eye, z), y_hat,
                           post)
        out.append((torch.clamp_min(s, SCALE_BOUND), mu))
    return out


def level_scan(model, eye: int, y, z, post=None):
    """The quantisation in the raster order with the model's own means:
    level by level (s = 3i + j, every mask-A tap at a smaller level),
    y_hat = round(y - mean) + mean at the level's pixels, the means from
    the context of the levels before.  -> y_hat."""
    pre = hyper_params(model, eye, z)
    y_hat = torch.zeros_like(y)
    hy, wy = y.shape[2:]
    for s in range(3 * (hy - 1) + wy):
        ii = torch.tensor([i for i in range(hy) if 0 <= s - 3 * i < wy],
                          device=y.device)
        jj = s - 3 * ii
        ctx = getattr(model, f"context_prediction{eye}")(y_hat)

        def at(t):
            return t[:, :, ii, jj][..., None]

        feats = [at(pre), at(ctx)] + ([at(post)] if post is not None
                                      else [])
        g = stack(model, f"entropy_parameters{eye}", torch.cat(feats, 1))
        mu = g[:, model.M:, :, 0]
        y_hat[:, :, ii, jj] = torch.round(y[:, :, ii, jj] - mu) + mu
    return y_hat


def gaussian_likelihood(y, scales, means):
    """The Gaussian's mass of the unit bin around each y: scales bounded
    at 0.11, likelihoods at 1e-9."""
    sc = lower_bound(scales, SCALE_BOUND)
    v = torch.abs(y - means)
    return lower_bound(std_cdf((0.5 - v) / sc) - std_cdf((-0.5 - v) / sc),
                       LIKELIHOOD_BOUND)


def round_trip(model, x1, x2, h):
    """The programs of one encode and decode, as the codec runs them: the
    analyses and hyper-analyses; the chain twice (encoder, then decoder:
    each eye's hyper-synthesis, context model and entropy parameters at
    every latent, the left view's synthesis, warp and re-encode); the
    right synthesis."""
    y1, y2 = analysis(model, x1, x2, h)
    y1_hat, y2_hat = torch.round(y1), torch.round(y2)
    z1, z2 = hyper(model, y1, y2)
    for _ in range(2):                       # encoder, then decoder
        eye_params(model, 1, hyper_params(model, 1, z1), y1_hat)
        x1_hat = model.decoder1(y1_hat)
        post = torch.round(model.encoder1(warp(x1_hat, h)))
        eye_params(model, 2, hyper_params(model, 2, z2), y2_hat, post)
    return x1_hat, model.decoder2(y2_hat, warp(x1_hat, h))


def train_forward(model, x1, x2, h, noise):
    """The training forward: additive U(-0.5, 0.5) noise, ``noise(t)``
    of t's shape, for z1, y1, the re-encoded left prior, z2, y2 ->
    (x1_hat, x2_hat, [the four likelihood tensors])."""
    y1 = model.encoder1(x1)
    z1 = stack(model, "h_a1", y1)
    z1_t, z1_lik = model.entropy_bottleneck1(z1, noise(z1))
    y1_t = y1 + noise(y1)
    s1, m1 = eye_params(model, 1, stack(model, "h_s1", z1_t), y1_t)
    y1_lik = gaussian_likelihood(y1_t, s1, m1)
    x1_hat = model.decoder1(y1_t)
    y2 = model.encoder2(torch.cat([warp(x1, h), x2], dim=1))
    x1_hat_warp = warp(x1_hat, h)
    post = model.encoder1(x1_hat_warp)
    post = post + noise(post)
    z2 = stack(model, "h_a2", y2)
    z2_t, z2_lik = model.entropy_bottleneck2(z2, noise(z2))
    y2_t = y2 + noise(y2)
    s2, m2 = eye_params(model, 2, stack(model, "h_s2", z2_t), y2_t, post)
    y2_lik = gaussian_likelihood(y2_t, s2, m2)
    x2_hat = model.decoder2(y2_t, x1_hat_warp)
    return x1_hat, x2_hat, [y1_lik, y2_lik, z1_lik, z2_lik]
