"""Port: the host rANS coder for z (hesic_tpu_torch/codecs/host_rans.py
over its own copy of rans.cpp) and the EntropyBottleneck tables.

* The integer quantizer is the same code: from the SAME PMF table the
  port's CDF tables EQUAL the JAX package's.
* The PMF table itself is float math (softplus, tanh, sigmoid): PyTorch's
  CPU kernels and XLA:CPU's approximations differ in the last bit.  Each
  PMF entry is a difference of two sigmoids near 1, so the port's
  ``pmf_data`` is held to 2.4e-7 absolute (2 ULP at 1; measured 1.2e-7),
  and the tables quantized from it to at most 32 counts on at most 3% of
  the CDF entries (measured 22 and 1.9%: a 1-ULP change can flip one
  rounding, which the quantizer's renormalization and steal spread along
  the row).  A z stream therefore decodes across packages only with the
  encoder's tables, which is what the cross-decode test uses.
* At the same symbols and tables the z strings are byte-identical and
  decode both ways, escapes included.

Weights are the JAX initialisation, optionally with every EB parameter
perturbed by seeded noise so the monotone MLP's tanh factors are live.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.entropy_models import EntropyBottleneck as JEB
from hesic_tpu.entropy_models import codec as jcodec
from hesic_tpu_torch.entropy_models import EntropyBottleneck, codec

torch.set_num_threads(2)

CH = 128


def _pmfs(seed, scale):
    eb = JEB(channels=CH)
    params = eb.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 2, CH)))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + (scale * rng.randn(*v.shape)).astype(
            np.float32), params["params"])
    jp = [np.asarray(a) for a in eb.apply({"params": params},
                                          method="pmf_data")]
    teb = EntropyBottleneck(CH)
    teb.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()})
    tp = [a.numpy() for a in teb.pmf_data()]
    return jp, tp


CASES = [(0, 0.0), (1, 0.0), (2, 0.05), (3, 0.3)]


@pytest.mark.parametrize("seed,scale", CASES)
def test_tables_from_same_pmf_equal_jax(seed, scale):
    jp, _ = _pmfs(seed, scale)
    jt = jcodec.tables_from_pmf(*jp)
    tt = codec.tables_from_pmf(*jp)
    np.testing.assert_array_equal(tt.quantized_cdf, jt.quantized_cdf)
    np.testing.assert_array_equal(tt.cdf_length, jt.cdf_length)
    np.testing.assert_array_equal(tt.offset, jt.offset)


@pytest.mark.parametrize("seed,scale", CASES)
def test_pmf_data_and_tables_close_to_jax(seed, scale):
    jp, tp = _pmfs(seed, scale)
    for j, t in zip(jp[2:], tp[2:]):              # lengths and offsets
        np.testing.assert_array_equal(t, j)
    for j, t in zip(jp[:2], tp[:2]):              # pmf and tail mass
        assert np.abs(j.astype(np.float64) - t).max() <= 2.4e-7
    diff = np.abs(codec.tables_from_pmf(*tp).quantized_cdf
                  - jcodec.tables_from_pmf(*jp).quantized_cdf)
    assert diff.max() <= 32 and (diff > 0).mean() <= 0.03


@pytest.mark.parametrize("b", [1, 3])
def test_z_strings_byte_identical_and_cross_decode(b):
    jp, _ = _pmfs(5, 0.3)
    jt, tt = jcodec.tables_from_pmf(*jp), codec.tables_from_pmf(*jp)
    rng = np.random.RandomState(b)
    # NHWC symbols, channel = table index; include escapes past the tables
    sym = rng.randint(-14, 15, (b, 2, 3, CH)).astype(np.int32)
    sym[0, 0, 0, :3] = [40, -60, 300]
    idx = np.broadcast_to(np.arange(CH, dtype=np.int32), sym.shape)
    t_strs = codec.compress_with_indexes(sym, idx, tt)
    j_strs = jcodec.compress_with_indexes(sym, idx, jt)
    assert t_strs == j_strs
    np.testing.assert_array_equal(
        codec.decompress_with_indexes(j_strs, idx, tt), sym)
    np.testing.assert_array_equal(
        jcodec.decompress_with_indexes(t_strs, idx, jt), sym)
