"""Port: GMM -> frequency rows (hesic_tpu_torch/codecs/pmf.py, kernel 1's
plain twin; the CUDA kernel itself runs only on the card, where
chip_smoke.py holds it bit-equal to this twin).

* The plain twin is BIT-equal to a strict-IEEE numpy evaluation of the
  same chain (every frequency equal).
* Against the JAX package (the plain-XLA ``_gmm_freq_fast`` and
  ``gmm_freq_pallas`` in interpret mode) at the same explicit centres:
  identical centres, valid rows (sum 65536, bins >= 1), and at most 6% of
  bins differing, by at most 64 counts: XLA:CPU contracts FMAs in the
  float chain (the same tripwire tests/test_det_math.py keeps between
  the two JAX paths).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.codecs.pallas_pmf import gmm_freq_pallas
from hesic_tpu.models.hesic_fast import _gmm_freq_fast
from hesic_tpu_torch.codecs import pmf
from test_torch_det_math import np_det_qscale, np_det_recip, np_det_std_cdf

torch.set_num_threads(2)

f32 = np.float32


def np_gmm_freq(sigma, means, weights, mm, k, center):
    """Strict numpy evaluation, NCHW inputs as the port takes them."""
    b, mk, h, w = sigma.shape
    m, hw = mk // k, h * w
    mu = means.reshape(b, k, m, hw)
    inv = np_det_recip(np.maximum(sigma.reshape(b, k, m, hw),
                                  f32(pmf.SCALE_MIN)))
    wgt = weights.reshape(b, k, m, -1)
    edges = (np.arange(-mm, mm + 2, dtype=f32) - f32(0.5))[None, None, :] \
        + center.astype(f32)[:, :, None]
    prev = np_det_std_cdf((edges[:, :, 0][:, None, :, None] - mu) * inv)
    rows, total = [], None
    for s in range(1, 2 * mm + 2):
        cur = np_det_std_cdf((edges[:, :, s][:, None, :, None] - mu) * inv)
        diff = (cur - prev) * wgt
        acc = diff[:, 0]
        for kk in range(1, k):
            acc = acc + diff[:, kk]
        p_s = np.maximum(acc, f32(0.0))
        rows.append(p_s)
        total = p_s if total is None else total + p_s
        prev = cur
    p = np.stack(rows, axis=2)
    freq = np.maximum(np.floor(p * np_det_qscale(total)[:, :, None, :]),
                      f32(1.0)).astype(np.int32)
    deficit = 65536 - freq.sum(axis=2, keepdims=True)
    amax = np.argmax(freq, axis=2)[:, :, None, :]
    np.put_along_axis(freq, amax,
                      np.take_along_axis(freq, amax, 2) + deficit, axis=2)
    return freq


def _heads(seed, b=2, h=4, w=8, m=8, k=3, spatial_w=False):
    """NCHW head outputs (sigma spans the clamp at 0.11), mixture-
    normalized weights, integer centres."""
    rng = np.random.RandomState(seed)
    sigma = rng.choice([1e-4, 0.05, 0.11, 0.3, 1.0, 3.0, 30.0],
                       size=(b, m * k, h, w)).astype(f32)
    sigma *= (1 + 0.3 * rng.randn(*sigma.shape)).astype(f32)
    sigma = np.abs(sigma)
    center = rng.randint(-5, 6, (b, m)).astype(np.int32)
    means = (np.tile(center, (1, k))[:, :, None, None]
             + rng.randn(b, m * k, h, w) * 3).astype(f32)
    wshape = (b, k, m, h, w) if spatial_w else (b, k, m, 1, 1)
    wr = rng.rand(*wshape).astype(f32) + 0.05
    wr = (wr / wr.sum(axis=1, keepdims=True)).astype(f32)
    weights = wr.reshape(b, k * m, *wshape[3:])
    return sigma, means, weights, center


CASES = [(6, 3, False), (16, 2, True), (8, 1, False), (32, 5, False)]


@pytest.mark.parametrize("mm,k,spatial_w", CASES)
def test_plain_bit_equal_to_numpy(mm, k, spatial_w):
    sigma, means, weights, center = _heads(mm + k, k=k,
                                           spatial_w=spatial_w)
    got = pmf.gmm_freq(*(torch.from_numpy(a) for a in
                         (sigma, means, weights)), mm, k,
                       torch.from_numpy(center))
    np.testing.assert_array_equal(
        got.numpy(), np_gmm_freq(sigma, means, weights, mm, k, center))


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("mm,k,spatial_w", CASES[:3])
def test_close_to_jax_paths(mm, k, spatial_w):
    sigma, means, weights, center = _heads(10 + mm, k=k,
                                           spatial_w=spatial_w)
    got = pmf.gmm_freq_plain(*(torch.from_numpy(a) for a in
                               (sigma, means, weights)), mm, k,
                             torch.from_numpy(center)).numpy()
    assert (got.sum(axis=2) == 65536).all() and (got >= 1).all()
    args = (_nhwc(sigma), _nhwc(means), _nhwc(weights), mm, k)
    f_xla, c_xla = _gmm_freq_fast(*args, center=jnp.asarray(center))
    f_pal, c_pal = gmm_freq_pallas(*args, center=jnp.asarray(center),
                                   interpret=True)
    for f_j, c_j in ((f_xla, c_xla), (f_pal, c_pal)):
        np.testing.assert_array_equal(np.asarray(c_j), center)
        f_j = np.asarray(f_j)
        assert f_j.shape == got.shape
        diff = f_j != got
        assert diff.mean() < 0.06, diff.mean()
        if diff.any():
            assert np.abs(f_j - got).max() <= 64


def test_cuda_tensor_never_falls_back():
    """A CUDA input must reach the kernel or raise; here (no card) the
    kernel wrapper refuses CPU tensors outright."""
    sigma, means, weights, center = _heads(0)
    with pytest.raises(ValueError, match="CUDA"):
        pmf.gmm_freq_cuda(*(torch.from_numpy(a) for a in
                            (sigma, means, weights)), 4, 3,
                          torch.from_numpy(center))
