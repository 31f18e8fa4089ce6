"""Port: HESICFastCodec compress_fast -> decompress_fast
(hesic_tpu_torch/models/hesic_fast.py) on the CPU, where every kernel
runs as its plain twin, at the tiny config (N=16, M=24, K=2, 64x64) with
the JAX codec's weights carried over by hesic_from_jax.

* Round trip: the decoded latents EQUAL the port encoder's own quantized
  latents, for the identity H, a rotated H (which selects a narrower
  warp window, stored in the header) and a case forced into outliers;
  each pair's container decoded alone, and the list reversed, give the
  whole list's latents; the grid encoder launches once per eye.
* The writer byte: a container of the JAX package, or of the port's
  other backend, is refused, naming both writers.
* Against the JAX codec at the same weights and inputs:
  - the header bytes after the writer byte (mm1, mm2, win, xwin/16,
    shape) are equal;
  - the decoded y1_hat/y2_hat are equal on every cell that is not within
    a rounding margin of a .5 boundary (2e-4 for y1, 2e-3 for y2, whose
    input passes the bf16 warp), the audit of tests/test_trained_parity;
  - bpp_real is within 2% (the frequency rows and z tables agree only to
    XLA:CPU's FMA and approximation differences; see test_torch_pmf and
    test_torch_host_rans);
  - with the JAX tables injected, the z strings are byte-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.geometry.fast_warp import pick_warp_win as j_pick_win
from hesic_tpu.geometry.fast_warp import pick_warp_xwin as j_pick_xwin
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models import HESICFastCodec as JCodec
from hesic_tpu_torch.geometry import warp_perspective
from hesic_tpu_torch.models import hesic_fast
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

SHAPES = [(1, 64, 64, 3), (1, 64, 64, 3), (1, 3, 3)]


@pytest.fixture(scope="module")
def codecs():
    jc = JCodec.init(JHESIC(N=16, M=24, K=2), SHAPES, seed=0)
    jc.update()
    params = jax.tree_util.tree_map(np.asarray, jc.params)
    model = HESIC(N=16, M=24, K=2, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return jc, HESICFastCodec(model).update()


def _pair(b=1, seed=0, deg=0.0, scale=1.0):
    rng = np.random.RandomState(seed)
    x1 = (rng.rand(b, 64, 64, 3) * scale).astype(np.float32)
    x2 = (rng.rand(b, 64, 64, 3) * scale).astype(np.float32)
    th = np.deg2rad(deg)
    h = np.array([[np.cos(th), -np.sin(th), 3.0 if deg else 0.0],
                  [np.sin(th), np.cos(th), -2.0 if deg else 0.0],
                  [0, 0, 1]], np.float32)
    return x1, x2, np.tile(h[None], (b, 1, 1))


def _enc_latents(codec, x1, x2, h, win):
    enc = codec.transforms_enc(codec._to_device(x1), codec._to_device(x2),
                               torch.from_numpy(h), win)
    return [e.permute(0, 2, 3, 1).float().numpy() for e in enc[:2]]


@pytest.mark.parametrize("deg,b", [(0.0, 1), (6.0, 2)])
def test_roundtrip_bit_exact(codecs, deg, b):
    _, codec = codecs
    x1, x2, h = _pair(b, seed=1, deg=deg)
    out = codec.compress_fast(x1, x2, h)
    assert len(out["blobs"]) == b and 0 < out["bpp_real"] < 20
    assert out["blob"][3] == j_pick_win(h, 64, 64)
    rec = codec.decompress_fast(out["blobs"])
    y1, y2 = _enc_latents(codec, x1, x2, h, out["blob"][3])
    np.testing.assert_array_equal(rec["y1_hat"].numpy(), y1)
    np.testing.assert_array_equal(rec["y2_hat"].numpy(), y2)
    for key in ("x1_hat", "x2_hat"):
        assert tuple(rec[key].shape) == x1.shape
        assert torch.isfinite(rec[key]).all()


def test_outliers_roundtrip_bit_exact(codecs):
    """A grid cap of mm=2 with amplified inputs forces latents past the
    grid: they must come back exactly through the escape side-channel."""
    _, codec = codecs
    hot = HESICFastCodec(codec.model, mm=2).update()
    x1, x2, h = _pair(1, seed=2, scale=50.0)
    x1, x2 = x1 - 25.0, x2 - 25.0
    out = hot.compress_fast(x1, x2, h)
    assert min(out["outliers"]) > 0, "case must produce outliers"
    rec = hot.decompress_fast(out["blob"])
    y1, y2 = _enc_latents(hot, x1, x2, h, out["blob"][3])
    np.testing.assert_array_equal(rec["y1_hat"].numpy(), y1)
    np.testing.assert_array_equal(rec["y2_hat"].numpy(), y2)


def test_each_blob_alone_and_reversed(codecs):
    """Pair i decoded alone sits in row 0 of a padded chunk, and the
    reversed list in another row: the latents must not depend on it."""
    _, codec = codecs
    x1, x2, h = _pair(3, seed=6, deg=6.0)
    blobs = codec.compress_fast(x1, x2, h)["blobs"]
    whole = codec.decompress_fast(blobs)
    rev = codec.decompress_fast(blobs[::-1])
    for key in ("y1_hat", "y2_hat"):
        np.testing.assert_array_equal(rev[key].numpy()[::-1],
                                      whole[key].numpy())
    for i, blob in enumerate(blobs):
        alone = codec.decompress_fast(blob)
        for key in ("y1_hat", "y2_hat"):
            np.testing.assert_array_equal(alone[key].numpy()[0],
                                          whole[key].numpy()[i])


def test_grid_encoder_launches_once_per_eye(codecs, monkeypatch):
    _, codec = codecs
    calls = []
    encode = hesic_fast.rans_encode_grid_rows

    def counted(*args, **kwargs):
        calls.append(kwargs["cap"])
        return encode(*args, **kwargs)

    monkeypatch.setattr(hesic_fast, "rans_encode_grid_rows", counted)
    x1, x2, h = _pair(2, seed=7)
    out = codec.compress_fast(x1, x2, h)
    assert calls == [24 * hesic_fast.auto_ppl(16) + 2] * 2
    rec = codec.decompress_fast(out["blobs"])
    y1, y2 = _enc_latents(codec, x1, x2, h, out["blob"][3])
    np.testing.assert_array_equal(rec["y1_hat"].numpy(), y1)
    np.testing.assert_array_equal(rec["y2_hat"].numpy(), y2)


def test_jax_container_raises_naming_both_writers(codecs):
    jc, codec = codecs
    x1, x2, h = _pair(1, seed=8)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(h))["blob"]
    assert j_blob[0] == 3
    with pytest.raises(ValueError) as err:
        codec.decompress_fast(j_blob)
    assert "the JAX package's format v3" in str(err.value)
    assert "torch-plain-fast-v3" in str(err.value)


def test_card_container_raises_on_the_cpu_codec(codecs):
    _, codec = codecs
    x1, x2, h = _pair(1, seed=9)
    blob = codec.compress_fast(x1, x2, h)["blob"]
    assert blob[0] == hesic_fast.writer_id("cpu") == 16
    card = bytes([hesic_fast.writer_id("cuda")]) + blob[1:]
    with pytest.raises(ValueError) as err:
        codec.decompress_fast(card)
    assert "cuda-fast-v3" in str(err.value)
    assert "torch-plain-fast-v3" in str(err.value)


def test_mixed_grid_blobs_raise(codecs):
    _, codec = codecs
    x1, x2, h = _pair(1, seed=3)
    a = codec.compress_fast(x1, x2, h)["blob"]
    b = bytearray(a)
    b[1] = 8 if a[1] != 8 else 16
    with pytest.raises(ValueError, match="share"):
        codec.decompress_fast([a, bytes(b)])


def _header(blob):
    """Bytes 1-8: byte 0 names the writer, the port's own by design."""
    return bytes(blob[1:9])


def _margin(y, eps):
    """Cells whose unrounded value lies within eps of a .5 boundary."""
    frac = np.abs(y - np.floor(y) - 0.5)
    return frac < eps


@pytest.mark.parametrize("deg", [0.0, 6.0])
def test_matches_jax_codec(codecs, deg):
    jc, codec = codecs
    x1, x2, h = _pair(1, seed=4, deg=deg)
    j_out = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                             jnp.asarray(h))
    t_out = codec.compress_fast(x1, x2, h)
    assert _header(t_out["blob"]) == _header(j_out["blob"])
    assert t_out["blob"][4] == (j_pick_xwin(h, 64, 64) or 0) // 16
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.02

    j_rec = jc.decompress_fast(j_out["blob"])
    t_rec = codec.decompress_fast(t_out["blob"])
    # unrounded latents for the margin audit: y1 from the JAX analysis;
    # y2 from the port's analysis of its own bf16 warp of the left view
    y1_raw = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray(x1), method="analysis1"))
    warped, _ = warp_perspective(codec._to_device(x1), torch.from_numpy(h),
                                 t_out["blob"][3])
    y2_raw = codec.model.analysis2(warped, codec._to_device(x2))
    y2_raw = y2_raw.permute(0, 2, 3, 1).numpy()
    for key, raw, eps in (("y1_hat", y1_raw, 2e-4),
                          ("y2_hat", y2_raw, 2e-3)):
        jy, ty = np.asarray(j_rec[key]), t_rec[key].numpy()
        keep = ~_margin(raw, eps)
        assert keep.mean() > 0.95
        np.testing.assert_array_equal(ty[keep], jy[keep])


def test_z_strings_equal_with_jax_tables(codecs):
    from hesic_tpu_torch.entropy_models import CdfTables
    jc, codec = codecs
    twin = HESICFastCodec(codec.model).update()
    twin.tables = {k: CdfTables(v.quantized_cdf, v.cdf_length, v.offset)
                   for k, v in jc.tables.items()}
    x1, x2, h = _pair(1, seed=5)
    j_blob = jc.compress_fast(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(h))["blob"]
    t_blob = twin.compress_fast(x1, x2, h)["blob"]
    off = 9
    for _ in range(2):
        n = int(np.frombuffer(j_blob, np.uint32, 1, off)[0])
        assert t_blob[off:off + 4 + n] == j_blob[off:off + 4 + n]
        off += 4 + n
