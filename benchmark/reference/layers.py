"""Plain float32 layers of the benchmark's references (NCHW).

A frozen copy of the published models' layer equations, as the port's
``layers/``, ``entropy_models/``, ``geometry/warp.py`` and ``ops/`` state
them, kept here so that the benchmark's yardstick does not move when the
program changes.  Parameter names and layouts are the program's, so one
state dict loads into both.  Every product and sum is float32; the
references run with TF32 off.

Precision.  Every convolution, GDN and matrix product passes its input
and its weight through ``self.cast`` (None: float32 as is).  The control
of the correctness check sets it to an fp8 (e4m3) round trip with a
per-tensor scale (``set_precision``): the reference computed one step
below the program's stated bf16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11
_PEDESTAL = (2 ** -18) ** 2


def fp8_round_trip(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax / 448) and
    back to float32."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Cast(nn.Module):
    """Base of every layer that rounds its operands under a precision."""

    cast = None

    def c(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.cast is None else self.cast(t)


def set_precision(model: nn.Module, name: str) -> None:
    """"f32" (the reference) or "fp8" (its control) on every layer."""
    fn = {"f32": None, "fp8": fp8_round_trip}[name]
    for mod in model.modules():
        if isinstance(mod, Cast):
            mod.cast = fn


@contextlib.contextmanager
def f32_backends():
    """For the block: cuDNN deterministic and not benchmarking, and no
    TF32 in convolutions or matmuls; the settings before it come back
    after it, so the program runs under its own."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    was = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
           matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
         matmul.allow_tf32) = was


def z_symbols(eb, y, h_a):
    """The hyper-latent's symbols as the codec codes them: `h_a`(y) less
    the entropy bottleneck `eb`'s medians, rounded."""
    return torch.round(h_a(y) - eb.medians()[None, :, None, None])


def z_hat(eb, sym):
    """The hyper-latent of its symbols: `sym` plus `eb`'s medians."""
    return sym + eb.medians()[None, :, None, None]


class LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes the output up."""

    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return torch.where(keep, g, torch.zeros_like(g)), None


def lower_bound(x, bound: float):
    return LowerBound.apply(x, bound)


def nonneg_init(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x + _PEDESTAL, _PEDESTAL))


def nonneg_apply(x: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    out = lower_bound(x, (minimum + _PEDESTAL) ** 0.5)
    return out * out - _PEDESTAL


class Conv(Cast):
    """Conv2d(k, s, padding k // 2); kaiming-normal weights (fan_in)."""

    def __init__(self, cin, cout, kernel_size=5, stride=2, device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, k // 2
        self.fan_in = cin * k * k
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.conv2d(self.c(x), self.c(self.weight), self.bias,
                        stride=self.stride, padding=self.padding)


class Deconv(Cast):
    """ConvTranspose2d(k, s, padding k // 2, output_padding s - 1): the
    output is exactly the input times the stride."""

    def __init__(self, cin, cout, kernel_size=5, stride=2, device=None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, k // 2
        self.fan_in = cin * k * k
        self.weight = nn.Parameter(torch.zeros(cin, cout, k, k,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        return F.conv_transpose2d(
            self.c(x), self.c(self.weight), self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.stride - 1)


class GDN(Cast):
    """y = x / sqrt(beta + gamma x^2) (inverse: times the sqrt), beta and
    gamma in sqrt-space."""

    def __init__(self, channels, inverse=False, device=None):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels,
                                                        device=device)))
        self.gamma = nn.Parameter(nonneg_init(
            0.1 * torch.eye(channels, device=device)))

    def forward(self, x):
        beta = nonneg_apply(self.beta, 1e-6)
        gamma = nonneg_apply(self.gamma)
        norm = F.conv2d(self.c(x * x), self.c(gamma)[:, :, None, None],
                        beta)
        return x * (torch.sqrt(norm) if self.inverse else torch.rsqrt(norm))


def matmul(mod: Cast, a, b):
    return torch.matmul(mod.c(a), mod.c(b))


def half_pixel_matrix(n_in: int, scale: int, device) -> torch.Tensor:
    """(n_in * scale, n_in) linear interpolation, half-pixel centres,
    edge-clamped."""
    pos = torch.clamp((torch.arange(n_in * scale, dtype=torch.float32,
                                    device=device) + 0.5) / scale - 0.5,
                      0.0, n_in - 1)
    lo = torch.floor(pos).to(torch.int64)
    fr = pos - lo.float()
    cols = torch.arange(n_in, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return (torch.where(cols == lo[:, None], (1.0 - fr)[:, None], zero)
            + torch.where(cols == lo[:, None] + 1, fr[:, None], zero))


class Upsample4(Cast):
    """Bilinear x4, half-pixel centres: two interpolation products."""

    def forward(self, z):
        h, w = z.shape[-2:]
        mh = half_pixel_matrix(h, 4, z.device)
        mw = half_pixel_matrix(w, 4, z.device)
        return matmul(self, matmul(self, mh, z), mw.t())


def warp(src: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dst(x, y) = src(M^-1 (x, y)): bilinear over the whole image, zero
    outside it, float32.  src (B, C, H, W), m (B, 3, 3)."""
    b, c, h, w = src.shape
    mi = torch.linalg.inv(m.double()).float()[:, :, :, None, None]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=src.device),
        torch.arange(w, dtype=torch.float32, device=src.device),
        indexing="ij")
    px = mi[:, 0, 0] * xs + mi[:, 0, 1] * ys + mi[:, 0, 2]
    py = mi[:, 1, 0] * xs + mi[:, 1, 1] * ys + mi[:, 1, 2]
    pz = mi[:, 2, 0] * xs + mi[:, 2, 1] * ys + mi[:, 2, 2]
    pz = torch.where(pz.abs() < 1e-8, torch.full_like(pz, 1e-8), pz)
    sx, sy = px / pz, py / pz
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    flat = src.reshape(b, c, h * w)
    out = torch.zeros_like(flat)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(
                b, 1, -1)
            v = torch.gather(flat, 2, idx.expand(b, c, idx.shape[-1]))
            wgt = torch.where(ok, wx * wy, torch.zeros_like(wx))
            out = out + v * wgt.reshape(b, 1, -1)
    return out.reshape(b, c, h, w)


class Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        for name, layer in layers:
            self.add_module(name, layer)

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


def enc_layers(cin, n, m, device, pre_fuse=False):
    """Analysis: [pre-fusion conv s1 + GDN,] then 4x (conv s2 [+ GDN])."""
    layers, chans = [], [cin]
    if pre_fuse:
        layers += [("Conv_0", Conv(cin, 3, stride=1, device=device)),
                   ("GDN_0", GDN(3, device=device))]
        chans = [3]
    off = len(layers) // 2
    for i, out in enumerate((n, n, n, m)):
        layers.append((f"Conv_{i + off}", Conv(chans[-1], out,
                                               device=device)))
        chans.append(out)
        if i < 3:
            layers.append((f"GDN_{i + off}", GDN(out, device=device)))
    return layers


def dec_layers(m, n, device, final_gdn=False):
    """Synthesis: 4x (deconv s2 [+ IGDN])."""
    layers = []
    for i, (cin, cout) in enumerate(zip((m, n, n, n), (n, n, n, 3))):
        layers.append((f"Deconv_{i}", Deconv(cin, cout, device=device)))
        if i < 3 or final_gdn:
            layers.append((f"GDN_{i}", GDN(cout, inverse=True,
                                           device=device)))
    return layers


class HyperEncoder(nn.Module):
    """abs -> conv s1 -> relu -> conv s2 -> relu -> conv s2."""

    def __init__(self, n, m, device=None):
        super().__init__()
        self.Conv_0 = Conv(m, n, stride=1, device=device)
        self.Conv_1 = Conv(n, n, device=device)
        self.Conv_2 = Conv(n, n, device=device)

    def forward(self, y):
        z = F.relu(self.Conv_0(torch.abs(y)))
        return self.Conv_2(F.relu(self.Conv_1(z)))


def softmax_over_mixture(w, k):
    b, mk, h, ww = w.shape
    return torch.softmax(w.reshape(b, k, mk // k, h, ww), dim=1).reshape(
        w.shape)


class GmmHyperY1(nn.Module):
    """Left GMM head: (sigma, means, weights) from z1_hat; weights pooled
    over space."""

    def __init__(self, n, m, k, device=None):
        super().__init__()
        self.K = k
        mk, kw = m * k, dict(device=device)
        self.Deconv_0, self.Deconv_1 = Deconv(n, n, **kw), Deconv(n, n, **kw)
        self.Conv_0 = Conv(n, mk, stride=1, **kw)
        self.Deconv_2, self.Deconv_3 = Deconv(n, n, **kw), Deconv(n, n, **kw)
        self.Conv_1 = Conv(n, mk, stride=1, **kw)
        self.Deconv_4, self.Deconv_5 = Deconv(n, n, **kw), Deconv(n, mk, **kw)
        self.Conv_2 = Conv(mk, mk, kernel_size=1, stride=1, **kw)

    def forward(self, z):
        s = F.relu(self.Deconv_1(F.relu(self.Deconv_0(z))))
        sigma = F.relu(self.Conv_0(s))
        u = F.leaky_relu(self.Deconv_3(F.leaky_relu(self.Deconv_2(z))))
        means = self.Conv_1(u)
        w = self.Deconv_5(F.leaky_relu(self.Deconv_4(z)))
        w = self.Conv_2(F.leaky_relu(torch.amax(w, dim=(2, 3),
                                                keepdim=True)))
        return sigma, means, softmax_over_mixture(w, self.K)


class GmmHyperY2(nn.Module):
    """Right GMM head on cat(upsample4(z2_hat), the left prior)."""

    def __init__(self, n, m, k, device=None):
        super().__init__()
        self.K = k
        mk, kw = m * k, dict(stride=1, device=device)
        cin = n + m
        self.Conv_0, self.Conv_1 = Conv(cin, n, **kw), Conv(n, n, **kw)
        self.Conv_2 = Conv(n, mk, **kw)
        self.Conv_3, self.Conv_4 = Conv(cin, n, **kw), Conv(n, n, **kw)
        self.Conv_5 = Conv(n, mk, **kw)
        self.Conv_6, self.Conv_7 = Conv(cin, n, **kw), Conv(n, mk, **kw)
        self.Conv_8 = Conv(mk, mk, kernel_size=1, **kw)
        self.up = Upsample4()

    def forward(self, z, prior):
        x = torch.cat([self.up(z), prior], dim=1)
        s = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        sigma = F.relu(self.Conv_2(s))
        u = F.leaky_relu(self.Conv_4(F.leaky_relu(self.Conv_3(x))))
        means = self.Conv_5(u)
        w = self.Conv_7(F.leaky_relu(self.Conv_6(x)))
        w = self.Conv_8(F.leaky_relu(torch.amax(w, dim=(2, 3),
                                                keepdim=True)))
        return sigma, means, softmax_over_mixture(w, self.K)


def std_cdf(x):
    return 0.5 * torch.erfc(-(2 ** -0.5) * x)


class EntropyBottleneck(nn.Module):
    """The factorized prior of Balle et al. 2018 (filters 3, 3, 3, 3,
    init scale 10, tail mass 1e-9); values laid out (C, 1, N), N in (h,
    w, b) order."""

    def __init__(self, channels, device=None, init_scale=10.0,
                 tail_mass=1e-9):
        super().__init__()
        self.tail_mass = tail_mass
        dims = (1, 3, 3, 3, 3, 1)
        scale = init_scale ** (1 / 5)
        c = channels
        for i in range(5):
            init_v = math.log(math.expm1(1 / scale / dims[i + 1]))
            setattr(self, f"matrix_{i}", nn.Parameter(torch.full(
                (c, dims[i + 1], dims[i]), init_v, device=device)))
            setattr(self, f"bias_{i}", nn.Parameter(
                torch.zeros(c, dims[i + 1], 1, device=device)))
            if i < 4:
                setattr(self, f"factor_{i}", nn.Parameter(
                    torch.zeros(c, dims[i + 1], 1, device=device)))
        self.quantiles = nn.Parameter(torch.tensor(
            [[-init_scale, 0.0, init_scale]], device=device).repeat(c, 1, 1))

    def medians(self):
        return self.quantiles[:, 0, 1]

    def _logits(self, x, stop_gradient: bool):
        for i in range(5):
            m = getattr(self, f"matrix_{i}")
            b = getattr(self, f"bias_{i}")
            if stop_gradient:
                m, b = m.detach(), b.detach()
            x = torch.matmul(torch.logaddexp(m, torch.zeros_like(m)), x) + b
            if i < 4:
                f = getattr(self, f"factor_{i}")
                f = f.detach() if stop_gradient else f
                x = x + torch.tanh(f) * torch.tanh(x)
        return x

    def loss(self):
        t = math.log(2 / self.tail_mass - 1)
        target = torch.tensor([-t, 0.0, t], device=self.quantiles.device)
        return torch.sum(torch.abs(self._logits(self.quantiles, True)
                                   - target))

    def likelihood(self, v):
        lower = self._logits(v - 0.5, False)
        upper = self._logits(v + 0.5, False)
        sign = -torch.sign(lower + upper).detach()
        return lower_bound(torch.abs(torch.sigmoid(sign * upper)
                                     - torch.sigmoid(sign * lower)),
                           LIKELIHOOD_BOUND)

    def forward(self, x, noise):
        """Training: x plus U(-0.5, 0.5) `noise` (laid out as x) ->
        (x_tilde, likelihoods)."""
        b, c, h, w = x.shape
        v = (x + noise).permute(1, 2, 3, 0).reshape(c, 1, -1)
        lik = self.likelihood(v)

        def nchw(t):
            return t.reshape(c, h, w, b).permute(3, 0, 1, 2)

        return nchw(v), nchw(lik)


def gmm_likelihood(y, sigma, means, weights, k: int):
    """The K-component mixture's mass of the unit bin around each y:
    channels k*M + m, scales bounded at 0.11, likelihoods at 1e-9."""
    m = y.shape[1]

    def slab(t):
        return t.reshape(t.shape[0], k, m, *t.shape[2:])

    sc = lower_bound(slab(sigma), SCALE_BOUND)
    v = torch.abs(y[:, None] - slab(means))
    mass = (std_cdf((0.5 - v) / sc) - std_cdf((-0.5 - v) / sc)) \
        * slab(weights)
    return lower_bound(mass.sum(dim=1), LIKELIHOOD_BOUND)


def kaiming_modules(model: nn.Module):
    """The layers whose weights are drawn kaiming-normal (fan_in)."""
    return [mod for mod in model.modules() if hasattr(mod, "fan_in")]
