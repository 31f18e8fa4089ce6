"""Port: GDN's dispatch and the conv-bias fold (hesic_tpu_torch/layers/gdn.py)
on the CPU, in bf16 at tiny shapes.  The kernel (codecs/csrc/gdn.cu) runs
only on the card; chip_smoke.py's phase_gdn holds it against its twin.

On the card a convolution with a bias runs the bias-free product and then
a bf16 broadcast add (cuDNN's ``output.add_(bias)``), which the kernel
takes over.  The CPU's convolution adds its bias inside its own sum
instead, so these tests give F.conv2d and F.conv_transpose2d the card's
order (``cudnn_like_bias``) on both sides of each comparison, and make
GDN take its kernel path here (``kernel_path``): the path's arguments go
through the wrapper's own checks and then through the plain twin, so
everything but the kernel's arithmetic runs as it does on the card.

* The folded path (the conv without its bias, then ``GDN(x, bias=b)``)
  is bit-equal to ``GDN(conv(x))``: GDN and IGDN, 3 and 128 channels.
* Every stack of models/hesic.py (through HESIC's and HESIC+'s forward)
  and DSIC's explicit chains (through DSIC's forward) give bit-equal
  outputs with and without the fold, and each of their GDNs gets its
  conv's bias.
* A forward that records a gradient takes today's ops, with the same
  output and gradients; one that records none takes the kernel's path.
* A channels-last input reaches the kernel as it is, and its result keeps
  that layout.
* The wrapper refuses unsupported channel counts, dtypes, shapes,
  non-contiguous and CPU tensors before anything is built or launched.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hesic_tpu_torch.codecs import build
from hesic_tpu_torch.layers import Conv, Deconv, conv_gdn, gdn
from hesic_tpu_torch.layers.gdn import GDN, GDN1
from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_plus import HESICPlus
from hesic_tpu_torch.ops import nonneg_apply

torch.set_num_threads(2)

BF16 = torch.bfloat16
SHAPES = ((2, 8, 8), (1, 5, 7))         # (B, H, W) of the GDN's input


def _bits(t):
    return t.detach().contiguous().view(torch.int16)


def _perturb(module, seed):
    """Nonzero conv biases and GDN parameters off their init, so that the
    bias and the channel mix both count."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (Conv, Deconv)):
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.add_(0.1 * torch.rand(c, generator=g))
                m.gamma.add_(0.05 * torch.rand(c, c, generator=g))


@pytest.fixture
def cudnn_like_bias(monkeypatch):
    """F.conv2d and F.conv_transpose2d with a bias as the card runs them:
    the bias-free product rounded to its dtype, then the bias added."""
    for name in ("conv2d", "conv_transpose2d"):
        real = getattr(F, name)

        def conv(x, w, bias=None, *args, _real=real, **kw):
            y = _real(x, w, None, *args, **kw)
            return y if bias is None else y + bias[:, None, None]
        monkeypatch.setattr(F, name, conv)


def _take_kernel_path(monkeypatch):
    """GDN takes its kernel path on the CPU (the dtype and gradient tests
    as they are), the kernel stood in for by the wrapper's checks and the
    twin; returns the list of calls, True where a bias came along."""
    calls = []
    takes = GDN.takes_kernel

    def takes_here(self, on_cuda, x_dtype, *inputs):
        return takes(self, True, x_dtype, *inputs)

    def kernel(x, beta, gamma, inverse, bias=None):
        gdn._check_gdn_args(x, beta, gamma, bias)
        calls.append(bias is not None)
        return gdn.gdn_plain(x, beta, gamma, inverse, None, bias)

    monkeypatch.setattr(GDN, "takes_kernel", takes_here)
    monkeypatch.setattr(GDN1, "takes_kernel",
                        lambda self, *a: False)
    monkeypatch.setattr(gdn, "gdn_cuda", kernel)
    return calls


@pytest.fixture
def kernel_path(monkeypatch):
    return _take_kernel_path(monkeypatch)


def _pair(c, inverse, deconv, seed=0):
    g = torch.Generator().manual_seed(seed)
    conv = (Deconv(4, c, dtype=BF16, generator=g) if deconv
            else Conv(4, c, dtype=BF16, generator=g))
    layer = GDN(c, inverse=inverse, dtype=BF16)
    _perturb(conv, seed + 1)
    _perturb(layer, seed + 2)
    conv.requires_grad_(False)
    layer.requires_grad_(False)
    return conv, layer


def _beta(layer):
    return nonneg_apply(layer.beta, layer.beta_min).to(BF16)


def _gamma(layer):
    return nonneg_apply(layer.gamma).to(BF16)


def _conv_input(shape, deconv, seed=3):
    b, hh, w = shape
    g = torch.Generator().manual_seed(seed)
    if deconv:          # the deconv doubles H and W
        return torch.randn(b, 4, hh // 2 or 1, w // 2 or 1, generator=g)
    return torch.randn(b, 4, 2 * hh, 2 * w, generator=g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", (3, 128))
@pytest.mark.parametrize("inverse", (False, True), ids=("gdn", "igdn"))
def test_folded_bias_bit_equal(inverse, c, shape, cudnn_like_bias,
                               kernel_path):
    """conv(bias=None) then GDN(x, bias=b) equals GDN(conv(x)) bit for
    bit, through the kernel's path and through the twin alike."""
    conv, layer = _pair(c, inverse, deconv=inverse)
    x = _conv_input(shape, deconv=inverse)
    with torch.no_grad():
        want = gdn.gdn_plain(conv(x), _beta(layer), _gamma(layer),
                             inverse)
        folded = layer(conv(x, with_bias=False), bias=conv.bias.to(BF16))
        paired = conv_gdn(conv, layer, x)
    assert kernel_path == [True, True]
    assert want.dtype == BF16 and want.shape == folded.shape
    assert torch.equal(_bits(folded), _bits(want))
    assert torch.equal(_bits(paired), _bits(want))


def _images(b=2, size=64, seed=5):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.rand(b, 3, size, size)
                                  .astype(np.float32)) for _ in range(2))


def _homographies(b=2):
    th = 0.1
    h = np.array([[np.cos(th), -np.sin(th), 5.0],
                  [np.sin(th), np.cos(th), -1.0], [0, 0, 1]], np.float32)
    return torch.from_numpy(np.tile(h[None], (b, 1, 1)))


def _forward_leaves(out):
    if isinstance(out, dict):
        return [t for v in out.values() for t in _forward_leaves(v)]
    return [out]


# (model, GDN calls of one forward, each with its conv's bias: HESIC's and
# HESIC+'s encoder1 twice (the warped left reconstruction re-encoded),
# encoder2, decoder1 and decoder2, the last two with a 3-channel GDN;
# DSIC's two encoders and two decoders).  N is the cells' 128, a channel
# count the kernel takes; the rest is cut to a tiny size.
MODELS = {
    "hesic": (lambda: HESIC(N=128, M=24, K=2, dtype=BF16, device="cpu",
                            seed=0), 5 * 3 + 2),
    "hesic-plus": (lambda: HESICPlus(N=128, M=24, dtype=BF16, device="cpu",
                                     seed=0), 5 * 3 + 2),
    "dsic": (lambda: DSIC(N=128, M=24, F=6, C=4, K=2, dtype=BF16,
                          device="cpu", seed=0), 4 * 3),
}


@pytest.mark.parametrize("arch", tuple(MODELS))
def test_stacks_bit_equal_with_fold(arch, cudnn_like_bias, monkeypatch):
    """Each model's forward (eval) gives bit-equal outputs with and
    without the fold; every GDN of its stacks and chains gets a bias."""
    build_model, n_gdn = MODELS[arch]
    model = build_model()
    _perturb(model, 7)
    x1, x2 = _images()
    args = (x1, x2) if arch == "dsic" else (x1, x2, _homographies())
    with torch.no_grad():
        want = _forward_leaves(model(*args))
        calls = _take_kernel_path(monkeypatch)
        got = _forward_leaves(model(*args))
    assert calls == [True] * n_gdn
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("c", (3, 128))
@pytest.mark.parametrize("inverse", (False, True), ids=("gdn", "igdn"))
def test_recorded_gradient_takes_todays_ops(inverse, c, kernel_path):
    """A forward that records a gradient runs today's ops (no kernel, no
    fold), with today's output and gradients; under no_grad the same
    pair takes the kernel's path."""
    conv, layer = _pair(c, inverse, deconv=inverse)
    x = _conv_input((2, 8, 8), deconv=inverse)

    def grads(fn):
        conv.requires_grad_(True)
        layer.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        out = fn(xi)
        out.float().square().sum().backward()
        params = [conv.weight, conv.bias, layer.beta, layer.gamma]
        res = [out.detach(), xi.grad] + [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        return res

    got = grads(lambda xi: conv_gdn(conv, layer, xi))
    assert kernel_path == []

    def today(xi):
        d = BF16
        y = F.conv_transpose2d if inverse else F.conv2d
        kw = (dict(stride=2, padding=2, output_padding=1) if inverse
              else dict(stride=2, padding=2))
        y = y(xi.to(d), conv.weight.to(d), conv.bias.to(d), **kw)
        return gdn.gdn_plain(y, _beta(layer), _gamma(layer),
                             inverse, d)

    want = grads(today)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    conv.requires_grad_(False)
    layer.requires_grad_(False)
    with torch.no_grad():
        conv_gdn(conv, layer, x)
    assert kernel_path == [True]


@pytest.mark.parametrize("c", (3, 128))
@pytest.mark.parametrize("inverse", (False, True), ids=("gdn", "igdn"))
def test_channels_last_keeps_its_layout(inverse, c, cudnn_like_bias,
                                        kernel_path, monkeypatch):
    """A channels-last conv output (HESIC+'s decoder feeds its synthesis
    stacks channels-last latents) reaches the kernel's path as it is, not
    made contiguous, and the folded pair's result is the unfolded one's,
    layout included."""
    seen = []
    stand_in = gdn.gdn_cuda

    def kernel(x, *args, **kw):
        seen.append(x.is_contiguous())
        return stand_in(x, *args, **kw)
    monkeypatch.setattr(gdn, "gdn_cuda", kernel)
    conv, layer = _pair(c, inverse, deconv=inverse)
    x = _conv_input((2, 8, 8), deconv=inverse).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want = gdn.gdn_plain(conv(x), _beta(layer), _gamma(layer), inverse)
        got = conv_gdn(conv, layer, x)
    assert kernel_path == [True] and seen == [False]
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert want.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))


def test_float32_and_gdn1_keep_todays_ops(kernel_path):
    """A float32 GDN and GDN1 never take the kernel's path."""
    x = torch.randn(2, 16, 4, 4)
    with torch.no_grad():
        GDN(16)(x)
        GDN(16, dtype=BF16)(x)          # float32 input
        GDN1(16, dtype=BF16)(x.to(BF16))
    assert kernel_path == []


def _args(c=128, dtype=BF16, b=2, hh=4, w=4):
    x = torch.randn(b, c, hh, w).to(dtype)
    return (x, torch.ones(c, dtype=dtype),
            torch.full((c, c), 0.1).to(dtype))


REFUSED = {
    "c20": (lambda: _args(c=20), "channels"),
    "c272": (lambda: _args(c=272), "channels"),
    "c0": (lambda: _args(c=0), "channels"),
    "c16": (lambda: _args(c=16), "channels"),
    "c256": (lambda: _args(c=256), "channels"),
    "float32": (lambda: _args(dtype=torch.float32), "bf16"),
    "3-d": (lambda: (_args()[0][0],) + _args()[1:], "4-D"),
    "non-contiguous": (lambda: (_args()[0].transpose(2, 3),) + _args()[1:],
                       "contiguous"),
    "gamma-shape": (lambda: _args()[:2] + (torch.ones(128, 64,
                                                      dtype=BF16),),
                    "shape"),
    "cpu": (lambda: _args(), "CUDA tensor"),
}


@pytest.mark.parametrize("case", tuple(REFUSED))
def test_wrapper_refuses(case, monkeypatch):
    """gdn_cuda raises ValueError on what the kernel does not take, with
    nothing built or launched."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(build, "load", no_build)
    args, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        gdn.gdn_cuda(*args(), False)


def test_wrapper_refuses_bias_of_another_dtype(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: None)
    x, beta, gamma = _args()
    with pytest.raises(ValueError, match="bf16 bias"):
        gdn.gdn_cuda(x, beta, gamma, True, torch.zeros(128))


@pytest.mark.parametrize("c", (3, 128))
def test_kernel_flops_match_the_twins_count(c):
    """The kernel's FLOP formula equals what PyTorch's counter counts for
    the twin (its 1x1 convolution), so device_flops reads the same on the
    card and on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode
    x, beta, gamma = _args(c=c, b=2, hh=5, w=7)
    with FlopCounterMode(display=False) as counter:
        gdn.gdn_plain(x, beta, gamma, False, None, beta)
    assert gdn._gdn_flops(tuple(x.shape)) == counter.get_total_flops() > 0
