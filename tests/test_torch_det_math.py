"""Port: deterministic float math (hesic_tpu_torch/codecs/det_math.py).

Every det function must be BIT-equal to a strict-IEEE numpy evaluation of
the same op sequence (numpy float32 rounds each operation once and never
fuses), over sweeps.  Against the JAX package on the CPU only closeness is
claimed: XLA:CPU contracts mul+add chains into FMAs, so its last bits
differ.  Stated bounds, for outputs above 1e-6: 4 ULP for det_recip and
det_exp, 16 ULP for det_std_cdf (the erfc tail amplifies the exp's
difference; measured 11); below 1e-6, 1e-12 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.codecs import det_math as jdm
from hesic_tpu_torch.codecs import det_math as tdm

torch.set_num_threads(2)

f32 = np.float32


def np_det_recip(d):
    d = np.asarray(d, f32)
    x = (np.int32(0x7EF311C3) - d.view(np.int32)).view(f32)
    for _ in range(3):
        x = x * (f32(2.0) - d * x)
    return x


def np_det_exp(v):
    v = np.asarray(v, f32)
    k = np.floor(v * f32(tdm.LOG2E) + f32(0.5))
    r = (v - k * f32(tdm.LN2_HI)) - k * f32(tdm.LN2_LO)
    p = np.full_like(r, f32(tdm.EXP_C[7]))
    for c in reversed(tdm.EXP_C[:7]):
        p = p * r + f32(c)
    ki = k.astype(np.int32)
    with np.errstate(over="ignore"):
        scale = ((ki + np.int32(127)) << np.int32(23)).view(f32)
        out = p * scale
    return np.where(ki < -126, f32(0.0), out).astype(f32)


def np_det_std_cdf(x):
    x = np.asarray(x, f32)
    z = np.minimum(np.abs(x) * f32(tdm.INV_SQRT2), f32(16.0))
    t = np_det_recip(f32(1.0) + f32(tdm.P) * z)
    poly = t * (f32(tdm.A1) + t * (f32(tdm.A2) + t * (
        f32(tdm.A3) + t * (f32(tdm.A4) + t * f32(tdm.A5)))))
    erfc_z = poly * np_det_exp(-z * z)
    return np.where(x >= 0, f32(1.0) - f32(0.5) * erfc_z,
                    f32(0.5) * erfc_z).astype(f32)


def np_det_qscale(total):
    total = np.asarray(total, f32)
    return f32(65536.0) * np_det_recip(np.maximum(total, f32(1e-30)))


def _bits_equal(a, b):
    return np.array_equal(np.asarray(a, f32).view(np.int32),
                          np.asarray(b, f32).view(np.int32))


def _ulp_diff(a, b):
    ai = np.asarray(a, f32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, f32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


RECIP_SWEEP = np.concatenate([
    np.logspace(-30, 30, 40001).astype(f32),
    f32([0.11, 1.0, 65536.0, 1e-30, 3.0, 7.0])])
EXP_SWEEP = np.linspace(-200, 0, 200001, dtype=f32)
CDF_SWEEP = np.concatenate([np.linspace(-40, 40, 200001, dtype=f32),
                            f32([0.0, -0.0, 1e-8, -1e-8])])


@pytest.mark.parametrize("name,sweep,t_fn,np_fn", [
    ("recip", RECIP_SWEEP, tdm.det_recip, np_det_recip),
    ("exp", EXP_SWEEP, tdm.det_exp, np_det_exp),
    ("std_cdf", CDF_SWEEP, tdm.det_std_cdf, np_det_std_cdf),
    ("qscale", np.logspace(-35, 3, 20001).astype(f32), tdm.det_qscale,
     np_det_qscale),
])
def test_bit_equal_to_strict_numpy(name, sweep, t_fn, np_fn):
    got = t_fn(torch.from_numpy(sweep)).numpy()
    assert _bits_equal(got, np_fn(sweep)), name


@pytest.mark.parametrize("name,sweep,t_fn,j_fn,ulps", [
    ("recip", RECIP_SWEEP, tdm.det_recip, jdm.det_recip, 4),
    ("exp", EXP_SWEEP[EXP_SWEEP > -87], tdm.det_exp, jdm.det_exp, 4),
    ("std_cdf", CDF_SWEEP, tdm.det_std_cdf, jdm.det_std_cdf, 16),
])
def test_close_to_jax_cpu(name, sweep, t_fn, j_fn, ulps):
    """XLA:CPU contracts FMAs, so equality is not claimed; closeness is."""
    got = t_fn(torch.from_numpy(sweep)).numpy()
    want = np.asarray(jax.jit(j_fn)(jnp.asarray(sweep)))
    big = np.abs(want) > 1e-6
    assert _ulp_diff(got, want)[big].max() <= ulps, name
    if (~big).any():
        tiny = np.abs(got[~big].astype(np.float64) - want[~big])
        assert tiny.max() <= 1e-12, name


def test_steal_and_freq_rows_match_jax():
    rng = np.random.RandomState(0)
    pmf = rng.dirichlet(np.ones(17) * 0.5, size=(3, 5, 40)).astype(f32)
    pmf = pmf.transpose(0, 1, 3, 2)                    # (3, 5, S, 40)
    total = pmf.sum(axis=2)
    qscale = np_det_qscale(total)[:, :, None, :]
    got = tdm.det_freq_rows(torch.from_numpy(pmf),
                            torch.from_numpy(qscale), dim=2).numpy()
    raw = np.maximum(np.floor(pmf * qscale), f32(1.0)).astype(np.int32)
    want = np.asarray(jdm.det_steal(jnp.asarray(raw), axis=2))
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=2) == 65536).all() and (got >= 1).all()


def test_steal_first_max_on_ties():
    freq = torch.tensor([[5, 9, 9, 2]], dtype=torch.int32)
    out = tdm.det_steal(freq, dim=1)
    assert out.tolist() == [[5, 9 + 65536 - 25, 9, 2]]
