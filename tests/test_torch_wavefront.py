"""Port: the wavefront schedule (hesic_tpu_torch/models/ar_device.py) and
kernel 5's plain twin (hesic_tpu_torch/models/wavefront.py) against the
JAX package on the CPU.

* schedule, wavefront_valid_mask and the mask-A taps: equal integers.
* Teacher pass on tests/test_pallas_wavefront.py's three CASES (no post,
  post with B=2 and a wide latent, one group on a tall latent), f32
  weights, against ar_wavefront_pallas in interpret mode and against the
  lax.scan ar_wavefront, at the tolerances the JAX package holds its own
  kernel to: residuals equal; y_hat within 1e-5 (float32 products summed
  in another order); starts/freqs within +-2 counts on valid slots (the
  three Phi implementations, A&S over det_math here, A&S over exact
  division in the Pallas kernel, XLA's erfc in the scan, differ in the
  last bits).
* Round trip on the CPU: teacher pass -> the pairs encoder -> decode
  pass, with the escape side-channel: y_hat and residuals bit-exact.
* The CUDA kernel's arithmetic layout, in plain torch: the packed weights,
  the compacted row map of every level, the split form of the first MLP
  layer (the hoisted product plus the context rows) against JAX's
  concatenated form and against JAX's level scan, and the level plans
  against the design's rules at HESIC+'s and the dry run's widths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.models.ar_device import _TAPS as J_TAPS
from hesic_tpu.models.ar_device import ar_wavefront as j_ar_wavefront
from hesic_tpu.models.ar_device import schedule as j_schedule
from hesic_tpu.models.ar_device import (
    wavefront_valid_mask as j_valid_mask)
from hesic_tpu.models.autoregressive import ArWeights as JArWeights
from hesic_tpu.models.autoregressive import raster_causal_mask
from hesic_tpu.models.pallas_wavefront import ar_wavefront_pallas
from hesic_tpu_torch.codecs.pairs_rans import rans_encode_pairs
from hesic_tpu_torch.models.ar_device import (TAPS, schedule,
                                              wavefront_valid_mask)
from hesic_tpu_torch.models.autoregressive import ArWeights
from hesic_tpu_torch.models.wavefront import (
    HOIST_PLAN, TILE_WIDTHS, PackedArWeights, ar_wavefront,
    ar_wavefront_cuda, column_slices, freq_rows, hoisted_base_plain,
    k_groups, level_ctas, level_pixels, level_plan, level_plan_ok,
    level_rows, level_smem, pack_weights, raw_weights, stage_shapes,
    tap_kernel)

torch.set_num_threads(2)

CASES = [
    # (b, hy, wy, m, mm, groups, q_dim), tests/test_pallas_wavefront.py
    (1, 4, 4, 16, 3, 2, 0),
    (2, 4, 8, 16, 3, 2, 16),
    (1, 8, 4, 8, 2, 1, 0),
]


def test_taps_equal_jax():
    assert TAPS == J_TAPS


@pytest.mark.parametrize("hy,wy", [(4, 4), (5, 9), (8, 3), (1, 7),
                                   (32, 32)])
def test_schedule_and_valid_mask_equal_jax(hy, wy):
    got, want = schedule(hy, wy), j_schedule(hy, wy)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(
        wavefront_valid_mask(hy, wy, 2, 4, 8).numpy(),
        np.asarray(j_valid_mask(hy, wy, 2, 4, 8)))


def _setup(seed, b, hy, wy, m, mm, groups, q_dim):
    """tests/test_pallas_wavefront.py's weights and inputs, numpy."""
    rng = np.random.RandomState(seed)
    p_dim = 2 * m
    k = rng.randn(5, 5, m, 2 * m).astype(np.float32) * 0.1
    k = k * np.asarray(raster_causal_mask(5, 5, "A"))[:, :, None, None]
    cin = p_dim + 2 * m + q_dim
    h1 = h2 = 2 * m
    w = dict(
        ctx_kernel=k,
        ctx_bias=rng.randn(2 * m).astype(np.float32) * 0.05,
        ep_kernels=(rng.randn(cin, h1).astype(np.float32) * 0.1,
                    rng.randn(h1, h2).astype(np.float32) * 0.1,
                    rng.randn(h2, 2 * m).astype(np.float32) * 0.1),
        ep_biases=(rng.randn(h1).astype(np.float32) * 0.05,
                   rng.randn(h2).astype(np.float32) * 0.05,
                   np.concatenate([np.full(m, 0.5),
                                   np.zeros(m)]).astype(np.float32)))
    y = rng.randn(b, hy, wy, m).astype(np.float32) * 2
    pre = rng.randn(b, hy, wy, p_dim).astype(np.float32) * 0.3
    post = rng.randn(b, hy, wy, q_dim).astype(np.float32) * 0.3
    return w, pre, post, y


def _weights(w, lib):
    if lib == "jax":
        return JArWeights(
            jnp.asarray(w["ctx_kernel"]), jnp.asarray(w["ctx_bias"]),
            tuple(jnp.asarray(a) for a in w["ep_kernels"]),
            tuple(jnp.asarray(a) for a in w["ep_biases"]))
    t = torch.from_numpy
    return ArWeights(t(w["ctx_kernel"]), t(w["ctx_bias"]),
                     tuple(t(a) for a in w["ep_kernels"]),
                     tuple(t(a) for a in w["ep_biases"]))


def _port_teacher(w, pre, post, y, mm, groups):
    post_t = torch.from_numpy(post) if post.shape[-1] else None
    return [t.numpy() for t in ar_wavefront(
        _weights(w, "torch"), torch.from_numpy(pre), post_t,
        torch.from_numpy(y), None, None, None, None, None, True, mm,
        groups)]


@pytest.mark.parametrize("case", CASES)
def test_teacher_matches_jax(case):
    b, hy, wy, m, mm, groups, q_dim = case
    w, pre, post, y = _setup(0, *case)
    _, _, _, p_max = schedule(hy, wy)
    lanes = b * p_max * (m // groups)
    zimg = jnp.zeros((b, hy, wy, m), jnp.int32)
    zl = jnp.zeros((lanes,), jnp.int32)
    args = (_weights(w, "jax"), jnp.asarray(pre), jnp.asarray(post),
            jnp.asarray(y), zimg, zimg, jnp.zeros((lanes, 1), jnp.int32),
            zl, zl.astype(jnp.uint32), jnp.bool_(True), hy, wy, mm, groups)
    refs = {"pallas": ar_wavefront_pallas(*args, interpret=True),
            "scan": j_ar_wavefront(*args)}
    st, fr, yh, rs = _port_teacher(w, pre, post, y, mm, groups)
    valid = wavefront_valid_mask(hy, wy, b, groups, m).numpy()
    for name, ref in refs.items():
        st_j, fr_j, yh_j, rs_j = (np.asarray(a) for a in ref)
        np.testing.assert_array_equal(rs, rs_j, err_msg=name)
        assert np.abs(yh - yh_j).max() < 1e-5, name
        assert np.abs(st - st_j)[valid].max() <= 2, name
        assert np.abs(fr - fr_j)[valid].max() <= 2, name
    assert (st[~valid] == 0).all() and (fr[~valid] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_plain_roundtrip_bit_exact(case):
    b, hy, wy, m, mm, groups, q_dim = case
    w, pre, post, y = _setup(1, *case)
    st, fr, yh_enc, rs = (torch.from_numpy(a) for a in
                          _port_teacher(w, pre, post, y, mm, groups))
    valid = wavefront_valid_mask(hy, wy, b, groups, m)
    words, counts, states = rans_encode_pairs(st, fr, valid, cap=256)
    assert int(counts.max()) <= 256
    esc = rs.abs() > mm
    assert esc.any(), "case must produce escapes"
    post_t = torch.from_numpy(post) if q_dim else None
    _, _, yh_dec, rs_dec = ar_wavefront(
        _weights(w, "torch"), torch.from_numpy(pre), post_t, None,
        esc.to(torch.int32), torch.where(esc, rs, 0), words, counts,
        states, False, mm, groups)
    torch.testing.assert_close(yh_dec, yh_enc, rtol=0, atol=0)
    torch.testing.assert_close(rs_dec, rs, rtol=0, atol=0)


@pytest.mark.parametrize("mm", [1, 3, 16])
def test_freq_rows_are_coder_rows(mm):
    scales = torch.from_numpy(np.random.RandomState(mm).rand(
        5, 7).astype(np.float32) * 20 + 0.11)
    f = freq_rows(scales, mm)
    assert f.shape == (5, 7, 2 * mm + 1) and f.dtype == torch.int32
    assert (f.sum(-1) == 1 << 16).all() and (f >= 1).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    case = CASES[0]
    w, pre, post, y = _setup(0, *case)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ar_wavefront_cuda(_weights(w, "torch"), torch.from_numpy(pre), None,
                          torch.from_numpy(y), None, None, None, None, None,
                          True, case[4], case[5])


@pytest.mark.parametrize("q_dim", [0, 16])
def test_pack_weights_split_w0(q_dim):
    w, _, _, _ = _setup(0, 1, 4, 4, 16, 3, 2, q_dim)
    raw = _weights(w, "torch")
    pk = pack_weights(raw, q_dim)
    m = 16
    w0 = raw.ep_kernels[0]
    p_dim = w0.shape[0] - 2 * m - q_dim
    assert raw_weights(pk) is raw and raw_weights(raw) is raw
    assert pk.q_dim == q_dim
    torch.testing.assert_close(pk.tapk, tap_kernel(raw), rtol=0, atol=0)
    torch.testing.assert_close(pk.w0_ctx, w0[p_dim:p_dim + 2 * m], rtol=0,
                               atol=0)
    torch.testing.assert_close(
        pk.w0_pp, torch.cat([w0[:p_dim], w0[p_dim + 2 * m:]]), rtol=0, atol=0)
    assert all(t.is_contiguous() for t in (pk.tapk, pk.w0_pp, pk.w0_ctx))
    with pytest.raises(ValueError, match="fewer than"):
        pack_weights(raw, w0.shape[0])


@pytest.mark.parametrize("hy,wy", [(4, 4), (5, 9), (8, 3), (1, 7),
                                   (32, 32)])
def test_level_rows_name_valid_pixels(hy, wy):
    """Level s's compacted rows are exactly the valid pixels of
    level_pixels, image by image, in (b, p) order."""
    b = 3
    n_levels, p_max, i_of, j_of, valid = level_pixels(hy, wy)
    for s in range(n_levels):
        bi, i, j = level_rows(hy, wy, b, s)
        p = np.flatnonzero(valid[s])
        np.testing.assert_array_equal(bi, np.repeat(np.arange(b), p.size))
        np.testing.assert_array_equal(i, np.tile(i_of[s, p], b))
        np.testing.assert_array_equal(j, np.tile(j_of[s, p], b))
        assert ((i >= 0) & (i < hy) & (j >= 0) & (j < wy)).all()


def _ctx_rows(raw, y_hat, bi, i, j):
    """The context input of pixels (bi, i, j) from a finished y_hat (every
    mask-A tap lies at an earlier level, so its value is final)."""
    b, hy, wy, m = y_hat.shape
    buf = torch.zeros((b, hy + 2, wy + 4, m))
    buf[:, 2:, 2:wy + 2] = y_hat
    bi, i, j = (torch.from_numpy(a) for a in (bi, i, j))
    taps = [buf[bi, i + 2 + di, j + 2 + dj] for di, dj in TAPS]
    return torch.cat(taps, 1) @ tap_kernel(raw) + raw.ctx_bias


@pytest.mark.parametrize("case", [CASES[0], CASES[1]])
def test_split_first_layer_matches_jax(case):
    """The kernel's split first layer, base (the hoisted product) + ctx @
    w0[P:P+2M], against cat(pre, ctx, post) @ w0 + b0 in JAX within 2e-6
    (f32, sums in another order), and carried through the MLP to the means
    it reproduces JAX's level scan: residuals equal, resid + means within
    1e-5 of its y_hat.  Eye 1 (no post) and eye 2 (post)."""
    b, hy, wy, m, mm, groups, q_dim = case
    w, pre, post, y = _setup(0, *case)
    _, _, _, p_max = schedule(hy, wy)
    lanes = b * p_max * (m // groups)
    zimg = jnp.zeros((b, hy, wy, m), jnp.int32)
    zl = jnp.zeros((lanes,), jnp.int32)
    _, _, yh_j, rs_j = (np.asarray(a) for a in j_ar_wavefront(
        _weights(w, "jax"), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(y), zimg, zimg, jnp.zeros((lanes, 1), jnp.int32), zl,
        zl.astype(jnp.uint32), jnp.bool_(True), hy, wy, mm, groups))
    raw = _weights(w, "torch")
    pk = pack_weights(raw, q_dim)
    post_t = torch.from_numpy(post) if q_dim else None
    base = hoisted_base_plain(pk, torch.from_numpy(pre), post_t)
    assert base.shape == (b, hy, wy, raw.ep_kernels[0].shape[1])
    w0, w1, w2 = raw.ep_kernels
    b0, b1, b2 = raw.ep_biases
    n_levels = schedule(hy, wy)[0]
    for s in range(n_levels):
        bi, i, j = level_rows(hy, wy, b, s)
        ctx = _ctx_rows(raw, torch.tensor(yh_j), bi, i, j)
        split = base[bi, i, j] + ctx @ pk.w0_ctx
        feat = [pre[bi, i, j], ctx.numpy()] + ([post[bi, i, j]] if q_dim
                                               else [])
        cat = np.asarray(jnp.dot(jnp.concatenate(feat, -1), w["ep_kernels"][0])
                         + w["ep_biases"][0])
        assert np.abs(split.numpy() - cat).max() <= 2e-6, s
        g = torch.nn.functional.leaky_relu(split, 0.01)
        g = torch.nn.functional.leaky_relu(g @ w1 + b1, 0.01) @ w2 + b2
        means = g[:, m:].numpy()
        np.testing.assert_array_equal(
            np.round(y[bi, i, j] - means).astype(np.int32), rs_j[bi, i, j])
        assert np.abs(rs_j[bi, i, j] + means - yh_j[bi, i, j]).max() < 1e-5


def test_packed_weights_run_the_plain_twin():
    case = CASES[1]
    w, pre, post, y = _setup(2, *case)
    raw = _weights(w, "torch")
    args = (torch.from_numpy(pre), torch.from_numpy(post),
            torch.from_numpy(y), None, None, None, None, None, True,
            case[4], case[5])
    got = ar_wavefront(pack_weights(raw, case[6]), *args)
    want = ar_wavefront(raw, *args)
    assert isinstance(pack_weights(raw, case[6]), PackedArWeights)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (M, H1, H2) packed: HESIC+ and mbt2018 at M=192, and the split codec's
# dry run at HESIC+ N=8/M=16 (H1 53 -> 64, H2 42 -> 48)
LEVEL_WIDTHS = [(192, 640, 512), (16, 64, 48)]
# a block's shared memory on Hopper: 227 KB
SMEM_BLOCK = 232448


def check_level_plans(m, h1, h2):
    """Every level plan of a 32x32 pass at B=64 and B=11 (each distinct
    row count): built and fitting, in 227 KB, clusters of at most 16, at
    least one block; every output column of every product owned by
    exactly one block of a cluster, and the taps' input quads shared
    out the same way."""
    _, _, count, _ = schedule(32, 32)
    for b in (64, 11):
        for rows in sorted({b * int(n) for n in count}):
            plan = level_plan(m, h1, h2, rows)
            assert level_plan_ok(m, h1, h2, plan), (rows, plan)
            assert level_smem(m, h1, h2, plan) <= SMEM_BLOCK
            assert 1 <= plan.cluster <= 16
            assert level_ctas(plan, rows) >= 1
            assert plan.bm % plan.tile == 0 and plan.tile in (4, 8)
            cuts = [(12 * m, 4)] + [(n, plan.tile) for n in (2 * m, h1, h2)]
            for n, unit in cuts:
                slices = column_slices(n, plan.cluster, unit)
                assert len(slices) == plan.cluster
                owned = [c for lo, hi in slices for c in range(lo, hi)]
                assert owned == list(range(n)), (n, plan)
                assert all(lo % unit == 0 for lo, _ in slices)


@pytest.mark.parametrize("widths", LEVEL_WIDTHS)
def test_level_plans_meet_design_rules(widths):
    check_level_plans(*widths)


@pytest.mark.parametrize("b", [64, 11])
def test_full_levels_fill_the_card(b):
    """HESIC+ at M=192 (H1 640, H2 512), 32x32 latents: a full level
    (704 rows at B=64, 121 at B=11) launches close to the 128 blocks
    the card holds in one wave of clusters (15 clusters of 8 or 7 of
    16), and no more than one wave."""
    _, _, _, p_max = schedule(32, 32)
    full = b * p_max
    plan = level_plan(192, 640, 512, full)
    assert 0.85 * 128 <= level_ctas(plan, full) <= 132, plan


def test_k_order_depends_on_k_alone():
    """The order of every sum is k_groups(K): four runs of whole
    quarters, k ascending, fixed by K alone.  No plan field names a k
    order, so any row count's plan sums every product in that order."""
    for m, h1, h2 in LEVEL_WIDTHS:
        for k, _ in stage_shapes(m, h1, h2).values():
            groups = k_groups(k)
            assert [lo for lo, _ in groups] == [g * k // 4 for g in range(4)]
            assert groups[-1][1] == k
            assert all(hi - lo == k // 4 for lo, hi in groups)
    assert set(level_plan(192, 640, 512, 704)._fields) == {
        "bm", "cluster", "kq", "tile"}
    assert HOIST_PLAN.bn in TILE_WIDTHS and HOIST_PLAN.kt % 16 == 0
