"""Plain float32 reference of HESIC (Deng et al., "Deep Homography for
Efficient Stereo Image Compression", CVPR 2021; the authors' code
``ywz/mywork/newnet1.py:699``), N=128, M=192, K=5.

The left view is coded by a GMM-conditioned hyperprior; the right view by
an encoder on cat(left view warped by H, right view) and a GMM head
conditioned on the decoded left view, warped by H and re-encoded; its
decoder fuses the warped left reconstruction.  Parameter names are the
program's (``encoder1.Conv_0``, ``h_s2.Conv_8``, ...), so one state dict
loads into both.  Departures from the authors' code, as the program has
them: GMM weights are pooled over space, the warp is bilinear with zero
padding, and the y latents are rounded without their means.

Functions the harness calls (every tensor NCHW float32):
``build(cfg, device)``, ``analysis(model, x1, x2, h)``,
``synthesis(model, y1_hat, y2_hat, h)``, ``hyper(model, y1, y2)``,
``conditioning(model, z1, z2, h, y1_hat)``, ``train_forward(model, x1,
x2, h, noise)``, ``round_trip(model, x1, x2, h)`` (the codec's
programs, for the FLOP count).
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.layers import (Deconv, EntropyBottleneck,
                                        GmmHyperY1, GmmHyperY2, HyperEncoder,
                                        Stack, dec_layers, enc_layers,
                                        gmm_likelihood, warp, z_hat,
                                        z_symbols)


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


class HESIC(nn.Module):
    def __init__(self, n, m, k, device=None):
        super().__init__()
        self.K = k
        self.encoder1 = Stack(enc_layers(3, n, m, device))
        self.encoder2 = Stack(enc_layers(6, n, m, device, pre_fuse=True))
        self.decoder1 = Stack(dec_layers(m, n, device))
        self.decoder2 = Decoder2(n, m, device)
        self.h_a1, self.h_a2 = (HyperEncoder(n, m, device)
                                for _ in range(2))
        self.h_s1 = GmmHyperY1(n, m, k, device)
        self.h_s2 = GmmHyperY2(n, m, k, device)
        self.entropy_bottleneck1 = EntropyBottleneck(n, device)
        self.entropy_bottleneck2 = EntropyBottleneck(n, device)


def build(cfg: dict, device) -> HESIC:
    w = cfg["widths"]
    return HESIC(w["N"], w["M"], w["K"], device)


def analysis(model, x1, x2, h, y1_hat=None):
    """-> (y1, y2): both eyes' latents before rounding (`y1_hat` is not
    used: the right encoder does not read the left latent)."""
    y1 = model.encoder1(x1)
    y2 = model.encoder2(torch.cat([warp(x1, h), x2], dim=1))
    return y1, y2


def synthesis(model, y1_hat, y2_hat, h):
    """The reconstructions (x1_hat, x2_hat) of given integer latents."""
    x1_hat = model.decoder1(y1_hat)
    return x1_hat, model.decoder2(y2_hat, warp(x1_hat, h))


def hyper(model, y1, y2):
    """(z1, z2): both eyes' hyper-latent symbols of the latents y1, y2,
    as the encoder codes them."""
    return (z_symbols(model.entropy_bottleneck1, y1, model.h_a1),
            z_symbols(model.entropy_bottleneck2, y2, model.h_a2))


def conditioning(model, z1, z2, h, y1_hat):
    """Both eyes' GMM heads (sigma, means, weights), as the decoder of a
    pair computes them from the hyper-latent symbols z1, z2: the left
    head on z1; the right head on z2 and the decoded left view (the
    synthesis of `y1_hat`) warped by H and re-encoded."""
    prior = torch.round(model.encoder1(warp(model.decoder1(y1_hat), h)))
    return (model.h_s1(z_hat(model.entropy_bottleneck1, z1)),
            model.h_s2(z_hat(model.entropy_bottleneck2, z2), prior))


def round_trip(model, x1, x2, h):
    """The programs of one encode and decode, as the codec runs them: the
    analyses, the hyper-analyses, both GMM heads with the left view's
    synthesis, warp and re-encode on each side, and the right
    synthesis."""
    y1, y2 = analysis(model, x1, x2, h)
    y1_hat, y2_hat = torch.round(y1), torch.round(y2)
    z1, z2 = (z_hat(eb, z) for eb, z in zip(
        (model.entropy_bottleneck1, model.entropy_bottleneck2),
        hyper(model, y1, y2)))
    for _ in range(2):                       # encoder, then decoder
        model.h_s1(z1)
        x1_hat = model.decoder1(y1_hat)
        prior = torch.round(model.encoder1(warp(x1_hat, h)))
        model.h_s2(z2, prior)
    return x1_hat, model.decoder2(y2_hat, warp(x1_hat, h))


def train_forward(model, x1, x2, h, noise):
    """The training forward: additive U(-0.5, 0.5) noise, ``noise(t)``
    of t's shape, for z1, y1, the re-encoded left prior, z2, y2 ->
    (x1_hat, x2_hat, [the four likelihood tensors])."""
    y1 = model.encoder1(x1)
    z1 = model.h_a1(y1)
    z1_t, z1_lik = model.entropy_bottleneck1(z1, noise(z1))
    sigma, means, weights = model.h_s1(z1_t)
    y1_t = y1 + noise(y1)
    y1_lik = gmm_likelihood(y1_t, sigma, means, weights, model.K)
    x1_hat = model.decoder1(y1_t)
    y2 = model.encoder2(torch.cat([warp(x1, h), x2], dim=1))
    x1_hat_warp = warp(x1_hat, h)
    prior = model.encoder1(x1_hat_warp)
    prior = prior + noise(prior)
    z2 = model.h_a2(y2)
    z2_t, z2_lik = model.entropy_bottleneck2(z2, noise(z2))
    sigma, means, weights = model.h_s2(z2_t, prior)
    y2_t = y2 + noise(y2)
    y2_lik = gmm_likelihood(y2_t, sigma, means, weights, model.K)
    x2_hat = model.decoder2(y2_t, x1_hat_warp)
    return x1_hat, x2_hat, [y1_lik, y2_lik, z1_lik, z2_lik]
