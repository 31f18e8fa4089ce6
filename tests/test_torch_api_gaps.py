"""Port: public functions of ported modules that the port lacked (ROADMAP
C11), each held against the JAX package on the CPU: the entropy-coder
registry, ``ops.upper_bound`` and its gradient gate, ``layers.GDN1``,
``entropy_models.gmm_pmf_edges`` and ``CdfTables``' state dicts.

Tolerances: upper_bound exact (values and gradients); GDN1 and its
inverse rtol 2e-6 / atol 1e-6 on carried weights (float32 rounding of
one channel mix); gmm_pmf_edges within 1e-6 of JAX's and of the port's
gmm_pmf.  About 5 s on the CPU.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def test_entropy_coder_registry():
    import hesic_tpu
    import hesic_tpu_torch as port
    assert port.available_entropy_coders() == \
        hesic_tpu.available_entropy_coders()
    assert port.get_entropy_coder() == hesic_tpu.get_entropy_coder() == "ans"
    try:
        port.set_entropy_coder("rangecoder")
        assert port.get_entropy_coder() == "rangecoder"
    finally:
        port.set_entropy_coder("ans")
    assert port.get_entropy_coder() == "ans"
    for bad in ("huffman", 0xFF):
        with pytest.raises(ValueError) as t_err:
            port.set_entropy_coder(bad)
        with pytest.raises(ValueError) as j_err:
            hesic_tpu.set_entropy_coder(bad)
        assert str(t_err.value) == str(j_err.value)
    assert port.get_entropy_coder() == "ans"


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_upper_bound_value_and_gate(sign):
    from hesic_tpu.ops import upper_bound as j_upper
    from hesic_tpu_torch.ops import upper_bound
    bound = 0.25
    x = np.array([-2.0, -0.5, 0.0, 0.25, 0.3, 1.0, 3.0], np.float32)
    g = np.float32(sign) * np.linspace(0.5, 2.0, x.size).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: j_upper(v, bound), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = upper_bound(xt, bound)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_j))
    above = x > bound
    # the gate: above the bound the gradient passes only when positive
    assert (xt.grad.numpy()[above] != 0).all() == (sign > 0)
    assert (xt.grad.numpy()[~above] == g[~above]).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn1_against_jax(inverse):
    from hesic_tpu.layers import GDN1 as JGDN1
    from hesic_tpu.ops.parametrizers import nonneg_init
    from hesic_tpu_torch.layers import GDN1
    from hesic_tpu_torch.utils.from_jax import hesic_from_jax
    c = 6
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    params = {
        "beta": np.asarray(nonneg_init(jnp.asarray(
            rng.rand(c).astype(np.float32) + 0.5))),
        "gamma": np.asarray(nonneg_init(jnp.asarray(
            0.1 * np.eye(c, dtype=np.float32)
            + 0.05 * rng.rand(c, c).astype(np.float32)))),
    }
    want = JGDN1(inverse=inverse).apply({"params": params}, jnp.asarray(x))
    mod = GDN1(c, inverse=inverse)
    mod.load_state_dict(hesic_from_jax(params, mod))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2e-6, atol=1e-6)


def test_gmm_pmf_edges_against_jax_and_gmm_pmf():
    from hesic_tpu.entropy_models import gmm_pmf_edges as j_edges
    from hesic_tpu_torch.entropy_models import gmm_pmf, gmm_pmf_edges
    k, m = 3, 4
    rng = np.random.RandomState(5)
    shape = (2, 3, 3, m * k)
    scales = rng.uniform(0.05, 4.0, shape).astype(np.float32)
    means = rng.uniform(-3.0, 3.0, shape).astype(np.float32)
    w = rng.rand(*shape).astype(np.float32)
    w /= w.reshape(2, 3, 3, k, m).sum(3, keepdims=True).repeat(
        k, 3).reshape(shape)
    samples = np.arange(-8, 9, dtype=np.float32)
    want = np.asarray(j_edges(jnp.asarray(samples), jnp.asarray(scales),
                              jnp.asarray(means), jnp.asarray(w), k))
    args = [torch.from_numpy(a) for a in (samples, scales, means, w)]
    got = gmm_pmf_edges(*args, k).numpy()
    assert got.shape == want.shape == (2, 3, 3, m, samples.size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, gmm_pmf(*args, k).numpy(), rtol=0,
                               atol=1e-6)


def test_cdf_tables_state_dict(tmp_path):
    from hesic_tpu.entropy_models import (gaussian_tables as j_tables,
                                          get_scale_table)
    from hesic_tpu_torch.entropy_models import CdfTables, gaussian_tables
    from hesic_tpu_torch.utils.persist import read_pickle
    table = get_scale_table()
    mine = gaussian_tables(table)
    assert mine.num_cdfs == len(table)
    back = CdfTables.from_state_dict(mine.state_dict())
    for f in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(back, f), getattr(mine, f))
        assert getattr(back, f).dtype == np.int32
    # a state dict written by the JAX package reads back equal
    theirs = j_tables(table)
    path = tmp_path / "tables.pkl"
    with open(path, "wb") as f:
        pickle.dump(theirs.state_dict(), f)
    read = CdfTables.from_state_dict(read_pickle(str(path)))
    assert read.num_cdfs == theirs.num_cdfs
    for f in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(read, f), getattr(theirs, f))
