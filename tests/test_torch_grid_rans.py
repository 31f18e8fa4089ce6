"""Port: grid rANS coder (hesic_tpu_torch/codecs/grid_rans.py and
device_rans.py; kernels 2 and 3 run only on the card, where chip_smoke.py
holds them bit-equal to these plain twins).

Integer arithmetic is the same on every backend, so on IDENTICAL frequency
rows and symbols the port must reproduce the JAX package exactly:
words, counts and states bit-equal to ``rans_encode_grid_pallas``
(interpret mode) and to ``device_rans.rans_encode_grid``, for ppl 1 and 2
and when the word budget overflows, and at the fast codec's own layout
(ppl 8, hw 1024) and a ragged one (ppl 1, hw 100); the port decodes the
JAX words back to the symbols; the container packing is byte-identical.
The kernels' launch plan (``grid_rans.rans_plan``) is checked on the
shapes the codec and bench.py give it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.codecs import device_rans as jdr
from hesic_tpu.codecs.pallas_rans import (rans_decode_grid_pallas,
                                          rans_encode_grid_pallas)
from hesic_tpu_torch.codecs import device_rans as tdr
from hesic_tpu_torch.codecs import grid_rans

torch.set_num_threads(2)


def _case(seed, b=2, m=6, s=9, hw=16):
    """Valid rows (sum 2^16, bins >= 1) from skewed Dirichlet PMFs and
    symbols drawn uniformly (so some land in thin bins)."""
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(s) * 0.4, size=(b, m, hw))
    freq = np.maximum(np.floor(p * 65536), 1).astype(np.int32)
    amax = freq.argmax(axis=-1)[..., None]
    np.put_along_axis(freq, amax, np.take_along_axis(freq, amax, -1)
                      + 65536 - freq.sum(-1, keepdims=True), -1)
    freq = np.ascontiguousarray(freq.transpose(0, 1, 3, 2))  # (B, M, S, hw)
    sym = rng.randint(0, s, size=(m, b, hw)).astype(np.int32)
    return freq, sym


def _jax_generic(freq, sym, ppl):
    """device_rans.rans_encode_grid on the (m*ppl, b*ls) slot layout."""
    b, m, s, hw = freq.shape
    ls = hw // ppl
    sym_b = sym.transpose(1, 0, 2)[:, :, None, :]
    iota = np.arange(s).reshape(1, 1, s, 1)
    start = (freq * (iota < sym_b)).sum(2)
    frs = (freq * (iota == sym_b)).sum(2)

    def grid(t):
        return t.reshape(b, m, ppl, ls).transpose(1, 2, 0, 3).reshape(
            m * ppl, b * ls)

    buf, counts, states = jdr.rans_encode_grid(
        jnp.asarray(grid(start), jnp.uint32),
        jnp.asarray(grid(frs), jnp.uint32),
        jnp.ones((m * ppl, b * ls), bool))
    return np.asarray(buf), np.asarray(counts), np.asarray(states)


@pytest.mark.parametrize("ppl,cap", [(1, None), (2, None), (2, 3)])
def test_encode_bit_equal_to_jax(ppl, cap):
    freq, sym = _case(ppl + (cap or 0))
    b, m, s, hw = freq.shape
    ls = hw // ppl
    words, counts, states = grid_rans.rans_encode_grid_rows(
        torch.from_numpy(freq), torch.from_numpy(sym), ppl=ppl, cap=cap)
    words, counts, states = words.numpy(), counts.numpy(), states.numpy()
    jcap = m * ppl + 2 if cap is None else cap
    wp, cp, sp = rans_encode_grid_pallas(jnp.asarray(freq), jnp.asarray(sym),
                                         ppl=ppl, cap=jcap, interpret=True)
    np.testing.assert_array_equal(words, np.asarray(wp))
    np.testing.assert_array_equal(counts, np.asarray(cp))
    np.testing.assert_array_equal(states, np.asarray(sp).astype(np.int64))
    if cap is not None:
        assert counts.max() > cap, "case must overflow its budget"

    buf, cx, sx = _jax_generic(freq, sym, ppl)
    np.testing.assert_array_equal(counts.reshape(-1), cx)
    np.testing.assert_array_equal(states.reshape(-1), sx.astype(np.int64))
    flat = words.transpose(0, 2, 1).reshape(b * ls, -1)
    n = min(flat.shape[1], buf.shape[1])
    keep = np.arange(n) < np.minimum(cx, n)[:, None]
    np.testing.assert_array_equal(flat[:, :n][keep], buf[:, :n][keep])


@pytest.mark.parametrize("ppl", [1, 2])
def test_port_decodes_jax_words(ppl):
    freq, sym = _case(10 + ppl)
    m = freq.shape[1]
    wp, cp, sp = rans_encode_grid_pallas(jnp.asarray(freq), jnp.asarray(sym),
                                         ppl=ppl, cap=m * ppl + 2,
                                         interpret=True)
    got = grid_rans.rans_decode_grid_rows(
        torch.from_numpy(freq), torch.from_numpy(np.array(wp)),
        torch.from_numpy(np.array(cp)),
        torch.from_numpy(np.asarray(sp).astype(np.int64)), ppl=ppl)
    np.testing.assert_array_equal(got.numpy(), sym)
    jdec = rans_decode_grid_pallas(jnp.asarray(freq), wp, cp, sp, ppl=ppl,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdec))


@pytest.mark.parametrize("b,m,s,hw,ppl", [(2, 4, 9, 1024, 8),
                                           (2, 6, 33, 100, 1)],
                         ids=["main-path-ppl8-hw1024", "ragged-ppl1-hw100"])
def test_codec_layouts_bit_equal_to_pallas(b, m, s, hw, ppl):
    """The layouts kernels 2 and 3 meet: the fast codec's (ppl 8, ls 128)
    and a ragged lane count (ls 100, not a multiple of the lane group)."""
    freq, sym = _case(20 + ppl, b=b, m=m, s=s, hw=hw)
    cap = grid_rans.default_cap(m, ppl)
    words, counts, states = grid_rans.rans_encode_grid_rows(
        torch.from_numpy(freq), torch.from_numpy(sym), ppl=ppl, cap=cap)
    wp, cp, sp = rans_encode_grid_pallas(jnp.asarray(freq), jnp.asarray(sym),
                                         ppl=ppl, cap=cap, interpret=True)
    np.testing.assert_array_equal(words.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(cp))
    np.testing.assert_array_equal(states.numpy(),
                                  np.asarray(sp).astype(np.int64))
    got = grid_rans.rans_decode_grid_rows(torch.from_numpy(freq), words,
                                          counts, states, ppl=ppl)
    np.testing.assert_array_equal(got.numpy(), sym)
    jdec = rans_decode_grid_pallas(jnp.asarray(freq), wp, cp, sp, ppl=ppl,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdec))


_PLAN_LAYOUTS = [(1024, 8), (100, 1), (90, 1), (16, 1)]


@pytest.mark.parametrize("hw,ppl", _PLAN_LAYOUTS,
                         ids=[f"hw{h}-ppl{p}" for h, p in _PLAN_LAYOUTS])
@pytest.mark.parametrize("encode", [False, True], ids=["decode", "encode"])
def test_rans_plan_fits_and_covers_every_lane(hw, ppl, encode):
    ls = hw // ppl
    for b in (1, 8, 64):
        for s in (9, 17, 33, 65, 129):
            plan = grid_rans.rans_plan(b, s, hw, ppl, encode=encode)
            assert plan.lg % 4 == 0 and 32 % plan.lg == 0
            assert plan.smem <= grid_rans.SMEM_BLOCK == 227 * 1024
            stages = plan.d * (4 * grid_rans.stage_ints(s, plan.lg, encode)
                               + 24)
            extra = 0 if encode else grid_rans.WORD_RING_BYTES
            assert plan.smem >= stages + extra
            assert plan.d % 2 == 0 and plan.ahead >= 1
            assert plan.d >= (plan.ahead + 1) * plan.helpers
            assert plan.threads == 32 * (plan.helpers + 1) <= 512
            # 16-byte copies only where every staged row segment is aligned
            assert plan.vec == (4 if hw % 4 == 0 and ls % 4 == 0 else 1)
            assert plan.search in ("split", "binary")
            if plan.search == "split":
                assert plan.lg == 8 and 4 * grid_rans.split_entries(s) >= s - 1
            # block k owns pair k // G, lanes [g*LG, min((g+1)*LG, ls)),
            # g = k % G, G = ceil(ls / LG): the kernels' block_geometry
            groups = -(-ls // plan.lg)
            assert plan.blocks == b * groups
            seen = np.zeros((b, ls), np.int64)
            for k in range(plan.blocks):
                lo = (k % groups) * plan.lg
                seen[k // groups, lo:min(lo + plan.lg, ls)] += 1
            assert (seen == 1).all()


def test_rans_plan_spreads_the_main_path_over_the_card():
    """B=8, hw 1024, ppl 8: 8-lane groups, 128 blocks, the deepest ring."""
    for s in (9, 17, 33, 65):
        for encode in (False, True):
            plan = grid_rans.rans_plan(8, s, 1024, 8, encode=encode)
            assert (plan.lg, plan.blocks, plan.vec) == (8, 128, 4)
            assert plan.d == grid_rans.MAX_STAGES
    assert grid_rans.rans_plan(8, 33, 1024, 8).search == "split"
    assert grid_rans.rans_plan(8, 65, 1024, 8).search == "binary"
    # the split search's widest rows are within what its kernels take
    assert grid_rans.split_entries(grid_rans.SPLIT_MAX_S) > 0


def test_rans_plan_follows_the_cards_sm_count():
    """bench.py's B=64: 1024 blocks share the SMs, so fewer SMs give
    each block fewer helper warps and a ring no deeper; B=8 fits any."""
    big = grid_rans.rans_plan(64, 33, 1024, 8, sm_count=132)
    small = grid_rans.rans_plan(64, 33, 1024, 8, sm_count=66)
    assert grid_rans.rans_plan(64, 33, 1024, 8) == big
    assert small.blocks == big.blocks == 1024
    assert small.helpers < big.helpers and small.d <= big.d
    assert 16 * (small.smem + 1024) <= grid_rans.SMEM_SM
    assert grid_rans.rans_plan(8, 33, 1024, 8, sm_count=66) == (
        grid_rans.rans_plan(8, 33, 1024, 8))


def test_generic_grid_with_skipped_slots_matches_jax():
    rng = np.random.RandomState(3)
    t_steps, lanes, s = 11, 24, 7
    p = rng.dirichlet(np.ones(s) * 0.5, size=(t_steps, lanes))
    freq = np.maximum(np.floor(p * 65536), 1).astype(np.int64)
    freq[..., 0] += 65536 - freq.sum(-1)
    sym = rng.randint(0, s, (t_steps, lanes))
    cdf = np.concatenate([np.zeros((t_steps, lanes, 1), np.int64),
                          np.cumsum(freq, -1)], -1)
    starts = np.take_along_axis(cdf, sym[..., None], -1)[..., 0]
    frs = np.take_along_axis(freq, sym[..., None], -1)[..., 0]
    valid = rng.rand(t_steps, lanes) > 0.2
    buf, counts, states = tdr.rans_encode_grid(
        torch.from_numpy(starts), torch.from_numpy(frs),
        torch.from_numpy(valid))
    jb, jc, js = jdr.rans_encode_grid(jnp.asarray(starts, jnp.uint32),
                                      jnp.asarray(frs, jnp.uint32),
                                      jnp.asarray(valid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(states.numpy(),
                                  np.asarray(js).astype(np.int64))
    keep = np.arange(buf.shape[1]) < np.asarray(jc)[:, None]
    np.testing.assert_array_equal(buf.numpy()[keep], np.asarray(jb)[keep])
    rows = torch.from_numpy(cdf.transpose(0, 2, 1).copy())   # (T, S+1, L)
    dec = tdr.rans_decode_grid(buf, counts, states, rows,
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(dec.numpy(), np.where(valid, sym, 0))


@pytest.mark.parametrize("spread", [10, 300])
def test_stream_packing_byte_identical(spread):
    rng = np.random.RandomState(spread)
    lanes = 40
    counts = rng.randint(50, 50 + spread, lanes)
    states = rng.randint(1 << 16, 1 << 31, lanes).astype(np.uint32)
    flat = rng.randint(0, 1 << 16, int(counts.sum())).astype(np.uint16)
    blob = tdr.pack_stream_dense(flat, counts, states)
    assert blob == jdr.pack_stream_dense(flat, counts, states)
    w, c, st, off = tdr.unpack_stream(blob + b"tail", 0)
    jw, jc, jst, joff = jdr.unpack_stream(blob + b"tail", 0)
    assert off == joff == len(blob)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(st, jst)


def test_freq_to_cdf_matches_jax():
    freq, _ = _case(5)
    got = tdr.freq_to_cdf(torch.from_numpy(freq), dim=2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jdr.freq_to_cdf(jnp.asarray(freq), axis=2)))


def test_cuda_wrappers_refuse_cpu_tensors():
    freq, sym = _case(0)
    with pytest.raises(ValueError, match="CUDA"):
        grid_rans.rans_encode_grid_cuda(torch.from_numpy(freq),
                                        torch.from_numpy(sym))
