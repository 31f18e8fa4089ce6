"""Port: the classical homography estimate (hesic_tpu_torch/geometry/
features.py) and ``StereoImageFolder(classical_h=True)`` against the JAX
package's (hesic_tpu/geometry/features.py), on the CPU, at the JAX tests'
sizes (tests/test_features.py: 160x160 block-textured images, 192
keypoints, 256 hypotheses).

Tolerances:
* the Harris response within 1e-5 relative (of the map's largest
  magnitude): float32 convolutions summed in another order;
* keypoints: the valid (x, y) set equal to JAX's;
* descriptors given JAX's keypoints within 1e-5; matching given JAX's
  descriptors: the same best index on every match and the same ratio
  verdicts;
* ``_dlt_refit`` on the same points and weights within 1e-4 of JAX's
  (both normalised to h[2, 2] = 1);
* RANSAC scoring given JAX's sample indices (``jax.random.choice``
  replayed with JAX's key): the same best inlier set and count.  The
  port draws its own samples (``torch.multinomial``), so end to end it is
  held to the JAX tests' bounds on the transfer error (below 1 px for a
  known warp, 0.5 at the identity, 0.75 for shifts, 0.1 with 40%
  outliers), not to JAX's estimate;
* a batch of hypotheses whose samples repeat a point scores -1 there
  without raising.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.geometry import features as jf
from hesic_tpu.geometry.homography import \
    get_perspective_transform as j_gpt
from hesic_tpu_torch.datasets import StereoImageFolder
from hesic_tpu_torch.datasets.image_io import write_png
from hesic_tpu_torch.geometry import features as tf
from hesic_tpu_torch.geometry.homography import warp_perspective

torch.set_num_threads(2)

HW = 160
KP = 192
HYP = 256
CPU = dict(device="cpu")


def _textured(seed=0, hw=HW):
    """Block-textured image: plenty of strong corners for Harris."""
    rng = np.random.RandomState(seed)
    blocks = rng.rand(hw // 8, hw // 8, 3).astype(np.float32)
    img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)
    img += 0.05 * rng.rand(hw, hw, 3).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _warp(im, h):
    """im (H, W, 3) warped by h with the port's full bilinear warp."""
    x = torch.from_numpy(im).permute(2, 0, 1)[None]
    out = warp_perspective(x, torch.from_numpy(h)[None])
    return out[0].permute(1, 2, 0).numpy()


def _transfer_error(h_est, h_true, hw=HW):
    """Mean transfer distance over an interior point grid."""
    ys, xs = np.meshgrid(np.linspace(hw * 0.25, hw * 0.75, 5),
                         np.linspace(hw * 0.25, hw * 0.75, 5))
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=-1)

    def proj(h):
        q = pts @ np.asarray(h, np.float64).T
        return q[:, :2] / q[:, 2:3]

    return float(np.mean(np.linalg.norm(proj(h_est) - proj(h_true),
                                        axis=-1)))


def _gray(seed=0):
    return _textured(seed)[..., 0]


def test_harris_matches_jax():
    g = _gray()
    want = np.asarray(jf.harris_response(jnp.asarray(g)))
    got = tf.harris_response(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_detect_keypoints_on_texture_as_jax():
    g = _gray()
    jxy, js = jf.detect_keypoints(jnp.asarray(g), max_kp=KP)
    xy, score = tf.detect_keypoints(torch.from_numpy(g), max_kp=KP)
    valid = score.numpy() > 0
    assert valid.sum() > 50
    vxy = xy.numpy()[valid]
    assert vxy.min() >= 9 and vxy.max() <= HW - 10
    jvalid = np.asarray(js) > 0
    assert set(map(tuple, vxy)) == set(map(tuple, np.asarray(jxy)[jvalid]))


def _jax_keypoints(seed=0):
    g = _gray(seed)
    xy, s = jf.detect_keypoints(jnp.asarray(g), max_kp=KP)
    return g, xy, s


def test_descriptors_match_jax_given_its_keypoints():
    g, jxy, js = _jax_keypoints()
    want = np.asarray(jf.describe_keypoints(jnp.asarray(g), jxy))
    got = tf.describe_keypoints(torch.from_numpy(g),
                                torch.tensor(np.asarray(jxy)))
    assert got.shape == (KP, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    norms = np.linalg.norm(got.numpy(), axis=-1)
    np.testing.assert_allclose(norms[np.asarray(js) > 0], 1.0, atol=1e-4)


def test_matching_matches_jax_given_its_descriptors():
    g1, xy1, s1 = _jax_keypoints(0)
    g2 = _gray(0)[::-1].copy()            # another corner set
    xy2, s2 = jf.detect_keypoints(jnp.asarray(g2), max_kp=KP)
    d1 = jf.describe_keypoints(jnp.asarray(g1), xy1)
    d2 = jf.describe_keypoints(jnp.asarray(g2), xy2)
    for a, b, va, vb in ((d1, d1, s1, s1), (d1, d2, s1, s2)):
        want_idx, want_good = jf.match_descriptors(a, b, va > 0, vb > 0)
        t = [torch.tensor(np.asarray(v)) for v in (a, b, va, vb)]
        idx, good = tf.match_descriptors(t[0], t[1], t[2] > 0, t[3] > 0)
        np.testing.assert_array_equal(good.numpy(), np.asarray(want_good))
        m = good.numpy() > 0
        np.testing.assert_array_equal(idx.numpy()[m],
                                      np.asarray(want_idx)[m])
    # self-matching maps every good match to itself (the JAX test's case)
    idx, good = tf.match_descriptors(*(torch.tensor(np.asarray(v))
                                       for v in (d1, d1)),
                                     torch.tensor(np.asarray(s1)) > 0,
                                     torch.tensor(np.asarray(s1)) > 0)
    m = good.numpy() > 0
    assert m.sum() > 30
    np.testing.assert_array_equal(idx.numpy()[m], np.arange(KP)[m])


def _outlier_problem(seed=3):
    rng = np.random.RandomState(seed)
    h_true = np.array([[1.02, 0.01, 4.0],
                       [-0.008, 0.99, -2.5],
                       [1e-5, -2e-5, 1.0]], np.float32)
    src = rng.rand(KP, 2).astype(np.float32) * HW
    proj = np.concatenate([src, np.ones((KP, 1), np.float32)], -1) \
        @ h_true.T
    dst = proj[:, :2] / proj[:, 2:3]
    bad = rng.rand(KP) < 0.4
    dst[bad] = rng.rand(bad.sum(), 2) * HW
    return h_true, src, dst.astype(np.float32), bad


def test_dlt_refit_matches_jax():
    h_true, src, dst, bad = _outlier_problem()
    w = (~bad).astype(np.float32) * np.random.RandomState(5).uniform(
        0.5, 1.0, KP).astype(np.float32)
    want = np.asarray(jf._dlt_refit(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(w)))
    got = tf._dlt_refit(torch.from_numpy(src), torch.from_numpy(dst),
                        torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got / got[2, 2], want / want[2, 2],
                               atol=1e-4, rtol=0)
    assert _transfer_error(got, h_true) < 0.1


def _jax_scoring(src, dst, weight, idx, thresh=5.0):
    """The JAX package's hypothesis scoring (find_homography_ransac's
    body) on given sample indices -> (best inlier mask, score)."""
    n = idx.shape[0]
    hs = j_gpt(jnp.take(src, idx.reshape(-1), axis=0).reshape(n, 4, 2),
               jnp.take(dst, idx.reshape(-1), axis=0).reshape(n, 4, 2))
    src_h = jnp.concatenate([src, jnp.ones((src.shape[0], 1))], -1)
    proj = jnp.einsum("nij,kj->nki", hs, src_h)
    z = jnp.where(jnp.abs(proj[..., 2]) < 1e-8, 1e-8, proj[..., 2])
    err2 = jnp.sum((proj[..., :2] / z[..., None] - dst[None]) ** 2, -1)
    inl = (err2 < thresh * thresh) & (weight > 0)[None]
    finite = jnp.all(jnp.isfinite(hs.reshape(n, -1)), axis=-1)
    score = jnp.where(finite, jnp.sum(inl, axis=-1), -1)
    return np.asarray(inl[jnp.argmax(score)]), np.asarray(score)


def test_ransac_scoring_given_jax_indices():
    h_true, src, dst, bad = _outlier_problem()
    weight = np.ones(KP, np.float32)
    p = jnp.asarray(weight / weight.sum())
    idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), KP,
                                       shape=(HYP, 4), replace=True, p=p))
    want_inl, want_score = _jax_scoring(jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(weight),
                                        jnp.asarray(idx))
    t = [torch.from_numpy(v) for v in (src, dst, weight)]
    _, inl, score = tf.score_hypotheses(*t, torch.tensor(idx))
    best = int(torch.argmax(score))
    np.testing.assert_array_equal(inl[best].numpy(), want_inl)
    h, n_inl = tf.ransac_from_samples(*t, torch.tensor(idx))
    jh, jn = jf.find_homography_ransac(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(weight),
        jax.random.PRNGKey(0), n_hyp=HYP)
    assert int(n_inl) == int(jn) == int(want_inl.sum())
    assert _transfer_error(h.numpy(), np.asarray(jh)) < 1e-2


def test_ransac_rejects_outliers():
    h_true, src, dst, bad = _outlier_problem()
    gen = torch.Generator().manual_seed(0)
    h, n_inl = tf.find_homography_ransac(
        torch.from_numpy(src), torch.from_numpy(dst), torch.ones(KP), gen,
        n_hyp=HYP)
    assert int(n_inl) >= int((~bad).sum() * 0.9)
    assert _transfer_error(h.numpy(), h_true) < 0.1


def test_singular_hypotheses_score_minus_one():
    h_true, src, dst, _ = _outlier_problem()
    idx = torch.tensor([[0, 1, 2, 3], [5, 5, 5, 5], [7, 7, 8, 9],
                        [10, 11, 12, 13]])
    t = [torch.from_numpy(v) for v in (src, dst)]
    _, _, score = tf.score_hypotheses(*t, torch.ones(KP), idx)
    assert score[1] == -1 and score[2] == -1
    assert score[0] >= 0 and score[3] >= 0
    # a whole draw of duplicates: no raise, the identity, no inliers
    h, n_inl = tf.ransac_from_samples(*t, torch.ones(KP),
                                      idx[1:3].repeat(4, 1))
    np.testing.assert_array_equal(h.numpy(), np.eye(3, dtype=np.float32))
    assert int(n_inl) == 0
    # and with no weight at all
    gen = torch.Generator().manual_seed(1)
    h, n_inl = tf.find_homography_ransac(*t, torch.zeros(KP), gen,
                                         n_hyp=16)
    np.testing.assert_array_equal(h.numpy(), np.eye(3, dtype=np.float32))


def test_estimate_homography_known_warp():
    h_true = np.array([[1.01, 0.02, 5.0],
                       [-0.015, 0.99, -3.0],
                       [2e-5, -1e-5, 1.0]], np.float32)
    im1 = _textured(seed=1)
    im2 = _warp(im1, h_true)
    out = tf.estimate_homography(im1, im2, max_kp=KP, n_hyp=HYP, **CPU)
    assert int(out["n_inliers"]) >= 20
    assert _transfer_error(out["h"].numpy(), h_true) < 1.0


def test_estimate_homography_identity():
    im = _textured(seed=2)
    out = tf.estimate_homography(im, im, max_kp=KP, n_hyp=HYP, **CPU)
    assert _transfer_error(out["h"].numpy(), np.eye(3)) < 0.5


def test_get_h_classical_contract():
    h_true = np.array([[1.0, 0.0, 3.0],
                       [0.0, 1.0, -2.0],
                       [0.0, 0.0, 1.0]], np.float32)
    im1 = _textured(seed=4)
    im2 = _warp(im1, h_true)
    h = tf.get_h_classical(im1, im2, max_kp=KP, n_hyp=HYP, **CPU)
    assert h is not None and h.shape == (3, 3) and h.dtype == np.float32
    assert _transfer_error(h, h_true) < 1.0
    flat = np.full((HW, HW, 3), 0.5, np.float32)
    assert tf.get_h_classical(flat, flat, max_kp=KP, n_hyp=HYP,
                              **CPU) is None


@pytest.mark.parametrize("shift", [2.0, 6.0])
def test_estimate_translation_only(shift):
    h_true = np.eye(3, dtype=np.float32)
    h_true[0, 2] = shift
    im1 = _textured(seed=5)
    im2 = _warp(im1, h_true)
    out = tf.estimate_homography(im1, im2, max_kp=KP, n_hyp=HYP, **CPU)
    assert _transfer_error(out["h"].numpy(), h_true) < 0.75


def test_dataset_classical_h_item(tmp_path):
    """StereoImageFolder(classical_h=True): item["h"] the estimate on the
    crops (within 1 px of the true warp), the identity for a featureless
    pair; a PNG round trip quantises the images as the reference's
    loader does."""
    h_true = np.array([[1.0, 0.01, 4.0], [-0.01, 1.0, -2.0],
                       [0.0, 0.0, 1.0]], np.float32)
    im1 = _textured(seed=6, hw=256)
    pairs = {"00.png": (im1, _warp(im1, h_true)),
             "01.png": (np.full((256, 256, 3), 0.5, np.float32),) * 2}
    for eye in (0, 1):
        d = tmp_path / "test" / ("left", "right")[eye]
        d.mkdir(parents=True)
        for name, pair in pairs.items():
            write_png(str(d / name),
                      np.round(pair[eye] * 255).astype(np.uint8))
    ds = StereoImageFolder(str(tmp_path), "test", patch_size=256,
                           classical_h=True, h_device="cpu",
                           rng=np.random.RandomState(0))
    item = ds[0]
    assert item["h"].shape == (3, 3) and item["h"].dtype == np.float32
    assert _transfer_error(item["h"], h_true, hw=256) < 1.0
    np.testing.assert_array_equal(ds[1]["h"], np.eye(3, dtype=np.float32))
