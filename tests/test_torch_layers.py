"""Port: Conv, Deconv, GDN and IGDN (hesic_tpu_torch/layers) against the
flax modules of hesic_tpu/layers, with the JAX parameters carried over by
hesic_tpu_torch.utils.from_jax.  float32 on the CPU; tolerance atol 1e-5
(different summation orders of the same products)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.layers import GDN as JGDN
from hesic_tpu.layers import Conv as JConv
from hesic_tpu.layers import Deconv as JDeconv
from hesic_tpu_torch.layers import GDN, Conv, Deconv
from hesic_tpu_torch.ops import lower_bound
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

ATOL = 1e-5


def _run_pair(jmod, tmod, x_nhwc, name):
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if "gamma" in params:
        # perturb GDN away from its diagonal init so the mix is tested
        rng = np.random.RandomState(1)
        params = {k: v + 0.05 * np.abs(rng.randn(*v.shape)).astype(
            np.float32) for k, v in params.items()}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x_nhwc)))
    sd = hesic_from_jax({name: params}, torch.nn.ModuleDict({name: tmod}))
    tmod.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()})
    got = tmod(torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()))
    return got.detach().numpy().transpose(0, 2, 3, 1), want


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,s,cin,cout", [(5, 2, 4, 8), (5, 1, 6, 3),
                                          (1, 1, 8, 8), (3, 2, 3, 5)])
def test_conv_matches_flax(k, s, cin, cout):
    x = _x((2, 16, 12, cin))
    got, want = _run_pair(JConv(cout, kernel_size=k, stride=s),
                          Conv(cin, cout, k, s), x, "Conv_0")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,s,cin,cout", [(5, 2, 4, 8), (5, 1, 6, 3),
                                          (3, 2, 5, 2)])
def test_deconv_matches_flax(k, s, cin, cout):
    x = _x((2, 6, 5, cin), seed=2)
    got, want = _run_pair(JDeconv(cout, kernel_size=k, stride=s),
                          Deconv(cin, cout, k, s), x, "Deconv_0")
    assert got.shape == want.shape == (2, 6 * s, 5 * s, cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_matches_flax(inverse):
    x = _x((2, 7, 9, 6), seed=3)
    got, want = _run_pair(JGDN(inverse=inverse), GDN(6, inverse=inverse),
                          x, "GDN_0")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_lower_bound_gradient_gate():
    x = torch.tensor([0.5, 2.0, 0.5, 2.0], requires_grad=True)
    y = lower_bound(x, 1.0)
    assert y.tolist() == [1.0, 2.0, 1.0, 2.0]
    y.backward(torch.tensor([1.0, 1.0, -1.0, -1.0]))
    # below the bound the gradient passes only when it pushes x upward
    assert x.grad.tolist() == [0.0, 1.0, -1.0, -1.0]
