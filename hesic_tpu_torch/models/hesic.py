"""HESIC: homography-based deep stereo image compression, NCHW.

Counterpart of hesic_tpu/models/hesic.py.  The left eye is coded with a
GMM-conditioned hyperprior; the right eye is coded conditioned on the
homography-warped left view, in signal space (encoder/decoder fusion) and
in bitrate space (the right GMM head sees the re-encoded decoded left
latent).

Submodules carry the JAX package's parameter names (``encoder1.Conv_0``,
``h_s1.Deconv_2``, ``entropy_bottleneck1.matrix_0``, ...) so weights map
one to one (utils/from_jax.py).  ``HESIC`` keeps the codec's method
split: ``analysis1/2``, ``synthesis1/2``, ``hyper_analysis1/2``,
``gmm1/2``, ``left_prior``.  ``dtype`` (None = float32) is the
transforms' compute type; the GMM heads' outputs and the encoders'
latents are cast to float32.
GMM weight channels are laid out k*M + m.

``forward`` is the training (and likelihood) forward of the JAX package's
``HESIC.__call__``; ``aux_loss`` is the bottlenecks' quantile loss.
Stage 2 (``HESICTogether``: ``IndependentEnhancement`` over HESIC's
reconstructions) is at the end, with the enhancement nets that HESIC+'s
and DSIC+'s stage 2 share.  The
model is built with gradients off (the codecs run it under ``no_grad``);
``training.make_optimizer`` turns them on for what it trains.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..entropy_models import EntropyBottleneck, GaussianMixtureConditional
from ..geometry import warp_perspective_train
from ..layers import GDN, Conv, Deconv, ResidualBlock, conv3x3, run_layers
from ..ops import quantize


def spatial_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial max -> (B, C, 1, 1)."""
    return torch.amax(x, dim=(2, 3), keepdim=True)


def softmax_over_mixture(w: torch.Tensor, k: int) -> torch.Tensor:
    """Softmax across the K mixture slabs of a (B, K*M, h, w) tensor."""
    b, mk, h, ww = w.shape
    return torch.softmax(w.reshape(b, k, mk // k, h, ww), dim=1).reshape(
        w.shape)


def _half_pixel_matrix(n_in: int, scale: int, device) -> torch.Tensor:
    """1-D half-pixel linear interpolation matrix (n_in * scale, n_in),
    float32, built on `device` from comparisons (no host copy): output i
    samples the input at (i + 0.5) / scale - 0.5, clamped to the edge
    pixels.  At scale 4 every weight (0.125, 0.375, 0.625, 0.875, 1) is
    exact in bf16."""
    pos = torch.clamp((torch.arange(n_in * scale, dtype=torch.float32,
                                    device=device) + 0.5) / scale - 0.5,
                      0.0, n_in - 1)
    lo = torch.floor(pos).to(torch.int64)
    fr = pos - lo.float()
    cols = torch.arange(n_in, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return (torch.where(cols == lo[:, None], (1.0 - fr)[:, None], zero)
            + torch.where(cols == lo[:, None] + 1, fr[:, None], zero))


def upsample4(z: torch.Tensor) -> torch.Tensor:
    """Bilinear x4 upsampling (half-pixel centres, edge-clamped): the
    upsampling case of ``jax.image.resize(..., "bilinear")``, as two
    interpolation-matrix products in the input's dtype, rows then
    columns.  Its backward is two matrix products too, so it is
    deterministic (an interpolation kernel's backward accumulates with
    atomics on the card)."""
    h, w = z.shape[-2:]
    mh = _half_pixel_matrix(h, 4, z.device).to(z.dtype)
    mw = _half_pixel_matrix(w, 4, z.device).to(z.dtype)
    return torch.matmul(torch.matmul(mh, z), mw.t())


class _Stack(nn.Module):
    """Named layers applied in declaration order, each conv and the GDN
    after it through ``run_layers`` (the conv's bias folded into the GDN's
    kernel where it runs)."""

    def __init__(self, layers):
        super().__init__()
        for name, layer in layers:
            self.add_module(name, layer)

    def forward(self, x):
        return run_layers(self.children(), x)


def _enc_layers(in_ch, n, m, d, g, pre_fuse=False):
    layers = []
    chans = [in_ch]
    if pre_fuse:
        layers += [("Conv_0", Conv(in_ch, 3, stride=1, dtype=d,
                                   generator=g)),
                   ("GDN_0", GDN(3, dtype=d))]
        chans = [3]
    off = len(layers) // 2
    outs = [n, n, n, m]
    for i, out in enumerate(outs):
        layers.append((f"Conv_{i + off}", Conv(chans[-1], out, dtype=d,
                                               generator=g)))
        chans.append(out)
        if i < 3:
            layers.append((f"GDN_{i + off}", GDN(out, dtype=d)))
    return layers


def _dec_layers(m, n, d, g, final_gdn=False):
    layers = []
    ins = [m, n, n, n]
    outs = [n, n, n, 3]
    for i, (cin, cout) in enumerate(zip(ins, outs)):
        layers.append((f"Deconv_{i}", Deconv(cin, cout, dtype=d,
                                             generator=g)))
        if i < 3 or final_gdn:
            layers.append((f"GDN_{i}", GDN(cout, inverse=True, dtype=d)))
    return layers


class StereoEncoder(_Stack):
    """4x (conv s2 + GDN) analysis transform."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__(_enc_layers(3, n, m, dtype, generator))

    def forward(self, x):
        return super().forward(x).float()


class StereoDecoder(_Stack):
    """4x (deconv s2 + IGDN) synthesis transform."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__(_dec_layers(m, n, dtype, generator))

    def forward(self, y_hat):
        return super().forward(y_hat).float()


class StereoEncoder2(_Stack):
    """Right-eye encoder: pre-fuses cat(x1_warp, x2), then the stack."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__(_enc_layers(6, n, m, dtype, generator,
                                     pre_fuse=True))

    def forward(self, x1_warp, x2):
        return super().forward(torch.cat([x1_warp, x2], dim=1)).float()


class StereoDecoder2(_Stack):
    """Right-eye decoder: the stack, then post-fusion with the warped left
    reconstruction."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__(_dec_layers(m, n, dtype, generator, final_gdn=True)
                         + [("Deconv_4", Deconv(6, 3, stride=1, dtype=dtype,
                                                generator=generator))])

    def forward(self, y_hat, x1_hat_warp):
        *stack, fuse = self.children()
        x = run_layers(stack, y_hat)
        x = torch.cat([x, x1_hat_warp.to(x.dtype)], dim=1)
        return fuse(x).float()


class HyperEncoder(nn.Module):
    """h_a: abs -> conv s1 -> relu -> conv s2 -> relu -> conv s2."""

    def __init__(self, n=128, m=192, dtype=None, generator=None):
        super().__init__()
        self.Conv_0 = Conv(m, n, stride=1, dtype=dtype, generator=generator)
        self.Conv_1 = Conv(n, n, dtype=dtype, generator=generator)
        self.Conv_2 = Conv(n, n, dtype=dtype, generator=generator)

    def forward(self, y):
        z = F.relu(self.Conv_0(torch.abs(y)))
        z = F.relu(self.Conv_1(z))
        return self.Conv_2(z).float()


class GmmHyperY1(nn.Module):
    """Left-eye GMM hyper-decoder: (sigma, means, weights) from z1_hat;
    weights are spatially pooled, (B, K*M, 1, 1)."""

    def __init__(self, n=128, m=192, k=5, dtype=None, generator=None):
        super().__init__()
        self.K = k
        mk = m * k
        kw = dict(dtype=dtype, generator=generator)
        self.Deconv_0, self.Deconv_1 = Deconv(n, n, **kw), Deconv(n, n, **kw)
        self.Conv_0 = Conv(n, mk, stride=1, **kw)
        self.Deconv_2, self.Deconv_3 = Deconv(n, n, **kw), Deconv(n, n, **kw)
        self.Conv_1 = Conv(n, mk, stride=1, **kw)
        self.Deconv_4, self.Deconv_5 = Deconv(n, n, **kw), Deconv(n, mk, **kw)
        self.Conv_2 = Conv(mk, mk, kernel_size=1, stride=1, **kw)

    def forward(self, z1_hat):
        s = F.relu(self.Deconv_1(F.relu(self.Deconv_0(z1_hat))))
        sigma = F.relu(self.Conv_0(s)).float()
        u = F.leaky_relu(self.Deconv_3(F.leaky_relu(self.Deconv_2(z1_hat))))
        means = self.Conv_1(u).float()
        w = self.Deconv_5(F.leaky_relu(self.Deconv_4(z1_hat)))
        w = self.Conv_2(F.leaky_relu(spatial_max_pool(w)))
        return sigma, means, softmax_over_mixture(w.float(), self.K)


class GmmHyperY2(nn.Module):
    """Right-eye GMM hyper-decoder on cat(upsample4(z2_hat), y1_prior)."""

    def __init__(self, n=128, m=192, k=5, dtype=None, generator=None):
        super().__init__()
        self.K = k
        mk = m * k
        kw = dict(stride=1, dtype=dtype, generator=generator)
        cin = n + m
        self.Conv_0, self.Conv_1 = Conv(cin, n, **kw), Conv(n, n, **kw)
        self.Conv_2 = Conv(n, mk, **kw)
        self.Conv_3, self.Conv_4 = Conv(cin, n, **kw), Conv(n, n, **kw)
        self.Conv_5 = Conv(n, mk, **kw)
        self.Conv_6, self.Conv_7 = Conv(cin, n, **kw), Conv(n, mk, **kw)
        self.Conv_8 = Conv(mk, mk, kernel_size=1, **kw)

    def forward(self, z2_hat, y1_prior):
        x = torch.cat([upsample4(z2_hat), y1_prior], dim=1)
        s = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        sigma = F.relu(self.Conv_2(s)).float()
        u = F.leaky_relu(self.Conv_4(F.leaky_relu(self.Conv_3(x))))
        means = self.Conv_5(u).float()
        w = self.Conv_7(F.leaky_relu(self.Conv_6(x)))
        w = self.Conv_8(F.leaky_relu(spatial_max_pool(w)))
        return sigma, means, softmax_over_mixture(w.float(), self.K)


class HESIC(nn.Module):
    """The HSIC model, N=128, M=192, K=5 by default.

    Parameters are drawn on the CPU from ``torch.Generator().manual_seed(
    seed)`` and then moved to ``device``."""

    entropy_bottlenecks = ("entropy_bottleneck1", "entropy_bottleneck2")
    single_image = False
    uses_homography = True

    def __init__(self, N: int = 128, M: int = 192, K: int = 5, dtype=None,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.N, self.M, self.K, self.dtype = N, M, K, dtype
        g = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, generator=g)
        self.encoder1 = StereoEncoder(N, M, **kw)
        self.encoder2 = StereoEncoder2(N, M, **kw)
        self.decoder1 = StereoDecoder(N, M, **kw)
        self.decoder2 = StereoDecoder2(N, M, **kw)
        self.h_a1 = HyperEncoder(N, M, **kw)
        self.h_a2 = HyperEncoder(N, M, **kw)
        self.h_s1 = GmmHyperY1(N, M, K, **kw)
        self.h_s2 = GmmHyperY2(N, M, K, **kw)
        self.entropy_bottleneck1 = EntropyBottleneck(N, generator=g)
        self.entropy_bottleneck2 = EntropyBottleneck(N, generator=g)
        self.gaussian1 = GaussianMixtureConditional(K)
        self.gaussian2 = GaussianMixtureConditional(K)
        self.to(device)
        self.requires_grad_(False)

    def aux_loss(self) -> torch.Tensor:
        return (self.entropy_bottleneck1.loss()
                + self.entropy_bottleneck2.loss())

    def forward(self, x1, x2, h, training: bool = False, generator=None):
        """x1, x2 (B, 3, H, W) float32 views, h (B, 3, 3) homographies ->
        {"x1_hat", "x2_hat", "y1_hat", "y2_hat", "likelihoods": {"y1",
        "y2", "z1", "z2"}}, NCHW float32.

        Training draws the noise of the five quantizations from
        `generator`, in the JAX package's order: z1, y1, the re-encoded
        warped left reconstruction, z2, y2.  Eval rounds instead.  The
        warped left reconstruction feeds both the right eye's prior and
        its decoder, so gradients reach decoder1 through both, and
        encoder1 (applied twice, shared weights) through both its uses."""
        mode = "noise" if training else "dequantize"
        y1 = self.encoder1(x1)
        z1 = self.h_a1(y1)
        z1_hat, z1_lik = self.entropy_bottleneck1(z1, training, generator)
        sigma1, means1, weights1 = self.h_s1(z1_hat)
        y1_hat, y1_lik = self.gaussian1(y1, sigma1, means1, weights1,
                                        training, generator)
        x1_hat = self.decoder1(y1_hat)

        x1_warp = warp_perspective_train(x1, h, self.dtype)
        y2 = self.encoder2(x1_warp, x2)
        # the decoder-reproducible cross-eye prior: the decoded left view,
        # warped and re-encoded
        x1_hat_warp = warp_perspective_train(x1_hat, h, self.dtype)
        y1_warpf2 = self.encoder1(x1_hat_warp)
        y1_hat_warpf2 = quantize(y1_warpf2, mode, generator=generator)

        z2 = self.h_a2(y2)
        z2_hat, z2_lik = self.entropy_bottleneck2(z2, training, generator)
        sigma2, means2, weights2 = self.h_s2(z2_hat, y1_hat_warpf2)
        y2_hat, y2_lik = self.gaussian2(y2, sigma2, means2, weights2,
                                        training, generator)
        x2_hat = self.decoder2(y2_hat, x1_hat_warp)
        return {"x1_hat": x1_hat, "x2_hat": x2_hat, "y1_hat": y1_hat,
                "y2_hat": y2_hat,
                "likelihoods": {"y1": y1_lik, "y2": y2_lik, "z1": z1_lik,
                                "z2": z2_lik}}

    # ---- codec-facing sub-programs ----

    def analysis1(self, x1):
        return self.encoder1(x1)

    def analysis2(self, x1_warp, x2):
        return self.encoder2(x1_warp, x2)

    def synthesis1(self, y1_hat):
        return self.decoder1(y1_hat)

    def synthesis2(self, y2_hat, x1_hat_warp):
        return self.decoder2(y2_hat, x1_hat_warp)

    def hyper_analysis1(self, y1):
        return self.h_a1(y1)

    def hyper_analysis2(self, y2):
        return self.h_a2(y2)

    def gmm1(self, z1_hat):
        return self.h_s1(z1_hat)

    def gmm2(self, z2_hat, y1_prior):
        return self.h_s2(z2_hat, y1_prior)

    def left_prior(self, x1_hat, h):
        """The decoder-reproducible cross-eye prior of the reference-layout
        codec (models/hesic_codec.py): the decoded left view warped by
        `h`, re-encoded and rounded (eval quantization, no means)."""
        warped = warp_perspective_train(x1_hat, h, self.dtype)
        return quantize(self.encoder1(warped), "dequantize")


# ---- stage 2: the cross-view enhancement ----

class EnhancementBlock(nn.Module):
    """Three residual blocks of 32 channels and a skip."""

    def __init__(self, generator=None):
        super().__init__()
        for i in range(3):
            self.add_module(f"ResidualBlock_{i}",
                            ResidualBlock(32, 32, generator))

    def forward(self, x):
        out = x
        for i in range(3):
            out = getattr(self, f"ResidualBlock_{i}")(out)
        return out + x


class Enhancement(nn.Module):
    """Cross-view quality enhancement of one reconstruction: the other
    view, warped onto it, is concatenated on the channels, then a 3x3 conv
    to 32, three EnhancementBlocks, a 3x3 conv to 3 and the skip.  With
    ``cross=False`` (DSIC+'s EnhancementSelf) the first conv takes the
    reconstruction alone."""

    def __init__(self, cross: bool = True, generator=None):
        super().__init__()
        self.Conv_0 = conv3x3(6 if cross else 3, 32, generator=generator)
        for i in range(3):
            self.add_module(f"EnhancementBlock_{i}",
                            EnhancementBlock(generator))
        self.Conv_1 = conv3x3(32, 3, generator=generator)

    def forward(self, x, x_other_warp=None):
        out = x if x_other_warp is None else torch.cat([x, x_other_warp],
                                                       dim=1)
        out = self.Conv_0(out)
        for i in range(3):
            out = getattr(self, f"EnhancementBlock_{i}")(out)
        return self.Conv_1(out) + x


class IndependentEnhancement(nn.Module):
    """Stage 2's cross-enhancement of both reconstructions: each view is
    enhanced with the other warped onto it (x1 by H, x2 by H^-1).  As in
    the JAX package, whose callers pass no dtype: the warps compute in
    float32 and the convs in the dtype of their input (the concatenation
    promotes a bf16 reconstruction to the warp's float32)."""

    def __init__(self, generator=None):
        super().__init__()
        self.Enhancement_0 = Enhancement(True, generator)
        self.Enhancement_1 = Enhancement(True, generator)

    def forward(self, x1_hat, x2_hat, h):
        x1_hat_warp = warp_perspective_train(x1_hat, h)
        x2_hat_warp = warp_perspective_train(x2_hat, torch.linalg.inv(h))
        return {"x1_hat": self.Enhancement_0(x1_hat, x2_hat_warp),
                "x2_hat": self.Enhancement_1(x2_hat, x1_hat_warp)}


class Together(nn.Module):
    """A stereo model ``m1`` and its stage-2 enhancement ``m2``, end to
    end: the enhancement runs on m1's reconstructions, and the codec
    applies it after decoding (``enhance``).  ``m2``'s parameters are
    drawn from ``torch.Generator().manual_seed(seed)`` on the CPU and
    moved to m1's device, with gradients off."""

    entropy_bottlenecks = ("m1/entropy_bottleneck1", "m1/entropy_bottleneck2")
    single_image = False

    def _attach(self, m1, m2) -> None:
        self.m1, self.m2 = m1, m2
        m2.to(next(m1.parameters()).device)
        m2.requires_grad_(False)
        self.N, self.M = m1.N, m1.M
        self.uses_homography = m1.uses_homography

    def aux_loss(self) -> torch.Tensor:
        return self.m1.aux_loss()

    def enhance(self, *args):
        """Stage 2 on decoded reconstructions (NCHW; H where m1 takes
        one) -> {"x1_hat", "x2_hat"}."""
        return self.m2(*args)

    def forward(self, x1, x2, *h, training: bool = False, generator=None):
        """m1's forward, then the enhancement of its reconstructions ->
        {"x1_hat", "x2_hat", "likelihoods"}.  Training noise is m1's."""
        out1 = self.m1(x1, x2, *h, training=training, generator=generator)
        out2 = self.m2(out1["x1_hat"], out1["x2_hat"], *h)
        return {"x1_hat": out2["x1_hat"], "x2_hat": out2["x2_hat"],
                "likelihoods": out1["likelihoods"]}


class HESICTogether(Together):
    """HESIC and the cross-view enhancement, N=128, M=192, K=5 by
    default.  ``m1`` takes an existing HESIC to enhance instead of a new
    one (its widths then hold)."""

    def __init__(self, N: int = 128, M: int = 192, K: int = 5,
                 device="cuda", seed: int = 0, m1=None):
        super().__init__()
        m1 = m1 if m1 is not None else HESIC(N, M, K, device=device,
                                             seed=seed)
        self._attach(m1, IndependentEnhancement(
            torch.Generator().manual_seed(seed)))
        self.K = m1.K
