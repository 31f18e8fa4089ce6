"""Port: the slot-stream rANS encoder (kernel 4's plain twin,
hesic_tpu_torch/codecs/pairs_rans.py) against the JAX package's
encoders on the CPU.

The case is tests/test_device_rans.py's slot-stream case: 40 slots x 21
lanes (21 is not a multiple of 8: the Pallas kernel's lane padding),
rows quantized by JAX's quantize_pmf_device, symbols drawn per slot and
20% of the slots skipped.  The twin must be bit-equal (tolerance 0: the
coder is integer-only) to rans_encode_pairs_pallas in interpret mode and
to JAX's lockstep rans_encode_grid: words within counts, counts and
states.  The CUDA kernel is held to the twin on the card by
chip_smoke.py; its launch plan (``pairs_plan``) is checked here on the
shapes the codec and the tests give it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.codecs.device_rans import quantize_pmf_device
from hesic_tpu.codecs.device_rans import rans_encode_grid as j_encode_grid
from hesic_tpu.codecs.pallas_rans import rans_encode_pairs_pallas
from hesic_tpu_torch.codecs import build, pairs_rans
from hesic_tpu_torch.codecs.pairs_rans import (rans_encode_pairs,
                                               rans_encode_pairs_cuda,
                                               rans_encode_pairs_plain)


def _case(seed, t_dim=40, l_dim=21, s=9):
    rng = np.random.RandomState(seed)
    pmf = rng.dirichlet(np.ones(s) * 0.5,
                        size=t_dim * l_dim).astype(np.float32)
    freq = np.asarray(quantize_pmf_device(jnp.asarray(pmf)))
    freq = freq.reshape(t_dim, l_dim, s)
    sym = rng.randint(0, s, size=(t_dim, l_dim))
    starts = np.take_along_axis(np.concatenate(
        [np.zeros((t_dim, l_dim, 1), np.int64),
         np.cumsum(freq, axis=-1)], -1), sym[..., None], -1)[..., 0]
    frs = np.take_along_axis(freq, sym[..., None], -1)[..., 0]
    valid = rng.rand(t_dim, l_dim) > 0.2
    return starts.astype(np.int32), frs.astype(np.int32), valid


def _torch(starts, frs, valid):
    return (torch.from_numpy(starts), torch.from_numpy(frs),
            torch.from_numpy(valid))


@pytest.mark.parametrize("seed", [4, 7])
def test_matches_jax_pallas_and_grid(seed):
    starts, frs, valid = _case(seed)
    w_p, c_p, s_p = (np.asarray(a) for a in rans_encode_pairs_pallas(
        jnp.asarray(starts, jnp.uint32), jnp.asarray(frs, jnp.uint32),
        jnp.asarray(valid), cap=64, interpret=True))
    w_g, c_g, s_g = (np.asarray(a) for a in j_encode_grid(
        jnp.asarray(starts, jnp.uint32), jnp.asarray(frs, jnp.uint32),
        jnp.asarray(valid)))
    words, counts, states = (t.numpy() for t in rans_encode_pairs_plain(
        *_torch(starts, frs, valid), cap=64))
    assert words.shape == (21, 64)
    for c_ref, s_ref in ((c_p, s_p), (c_g, s_g)):
        np.testing.assert_array_equal(counts, c_ref)
        np.testing.assert_array_equal(states, s_ref.astype(np.int64))
    keep = np.arange(64) < counts[:, None]
    np.testing.assert_array_equal(words[keep], w_p[keep])
    cap_g = w_g.shape[1]           # T + 2 >= every count
    np.testing.assert_array_equal(words[:, :cap_g][keep[:, :cap_g]],
                                  w_g[keep[:, :cap_g]])


def test_overflow_keeps_true_counts():
    """A cap below the payload: words past it are dropped, counts still
    report the true count (the caller's retry signal), states are
    unchanged."""
    starts, frs, valid = _case(5)
    full = rans_encode_pairs_plain(*_torch(starts, frs, valid), cap=64)
    cut = rans_encode_pairs_plain(*_torch(starts, frs, valid), cap=3)
    assert int(full[1].max()) > 3
    assert cut[0].shape == (21, 3)
    torch.testing.assert_close(cut[1], full[1], rtol=0, atol=0)
    torch.testing.assert_close(cut[2], full[2], rtol=0, atol=0)
    torch.testing.assert_close(cut[0], full[0][:, :3], rtol=0, atol=0)


def test_skipped_slots_may_carry_zero_freq():
    """The wavefront's teacher pass writes 0 intervals on rows past a
    level; skipped slots never divide."""
    starts, frs, valid = _case(6)
    zeroed = np.where(valid, frs, 0).astype(np.int32)
    ref = rans_encode_pairs_plain(*_torch(starts, frs, valid), cap=64)
    got = rans_encode_pairs(*_torch(starts, zeroed, valid), cap=64)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    starts, frs, valid = _torch(*_case(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rans_encode_pairs_cuda(starts, frs, valid, cap=64)


# (T, L, sm_count): the HESIC+ point (B=11, 32x32 latents, M=192, 8
# groups), its batch 22, the test case above (21 lanes: a ragged lane
# group), a T that is not a multiple of a stage, and a smaller card
PLAN_SHAPES = [(1000, 2904, 132), (1000, 5808, 132), (40, 21, 132),
               (37, 96, 132), (1000, 2904, 66)]


@pytest.mark.parametrize("t_dim,lanes,sms", PLAN_SHAPES)
def test_pairs_plan_within_limits(t_dim, lanes, sms):
    plan = pairs_rans.pairs_plan(t_dim, lanes, sms)
    assert plan.lg == build.LANE_GROUP == 8
    assert plan.blocks == -(-lanes // plan.lg)
    assert plan.threads == 32 * (plan.helpers + 1) <= 512
    assert plan.d % 2 == 0 and plan.ahead >= 1
    assert plan.d >= (plan.ahead + 1) * plan.helpers
    assert plan.ring & (plan.ring - 1) == 0
    assert plan.ring >= plan.d * pairs_rans.SLOTS + 4
    assert plan.smem >= (plan.d * (24 + 4 * pairs_rans.STAGE_INTS)
                         + 4 * plan.lg * (plan.ring + 4))
    assert plan.smem <= build.SMEM_BLOCK
    per_sm = -(-plan.blocks // sms)
    assert per_sm * (plan.smem + 1024) <= build.SMEM_SM
    assert per_sm * (plan.helpers + 1) <= build.WARPS_SM
    assert plan.vec == (4 if lanes % 4 == 0 else 1)


def test_pairs_plan_at_the_hesic_plus_point():
    """363 lane groups, three to an SM: the deepest ring and every
    helper fit."""
    plan = pairs_rans.pairs_plan(1000, 2904)
    assert (plan.blocks, plan.d, plan.helpers, plan.vec) == (
        363, pairs_rans.MAX_STAGES, pairs_rans.HELPERS, 4)
    assert pairs_rans.pairs_plan(1000, 2904, 132) == plan
