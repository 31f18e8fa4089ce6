"""Port: the codec API that the evaluation CLIs reach (repairs C7-C9 of
ROADMAP C), on the CPU.

* C7: the zoo's ``hesic`` and ``dsic`` codecs (``HESICFastCodec``,
  ``DSICFastCodec``) carry the reference-layout container API of the JAX
  classes they mirror (``compress(..., output_name, output_path)``,
  ``decompress``, ``decompress_bytes``).  At HESIC N16/M24/K2 and DSIC
  N8/M16/F6/C8/K2, 64x64, their files are byte-equal to the port's
  ``HESICCodec`` / ``DSICCodec`` on the same weights and tables, and
  decode to the encoder's latents.  The fast container and the reference
  container decode to the same y1 exactly, and y2 within 1 on under 1%
  of the cells (the JAX test's bound, tests/test_hesic_fast.py:45-62:
  the fast codec's warp is bf16, the container's the f32 gather).
* C8: ``CompressionModel.forward(..., training=False)`` takes and gives
  NHWC as the JAX codec's, for bmshj2018-factorized (N32/M48),
  hesic (N16/M24/K2) and hesic-plus (N16/M24) on weights carried from
  JAX by hesic_from_jax: the bits of every likelihood within 1e-4
  relative of JAX's, the reconstructions within ATOL 2e-5 (the port's
  forward tests' tolerance; measured at most 2.1e-6).  ``aux_loss``
  within rtol 1e-6.
* C9: ``JointAutoregressiveDeviceCodec.decompress(strings, shape)``
  takes the host codecs' shape argument, as JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.zoo as jzoo
from hesic_tpu.training.losses import bits as j_bits
from hesic_tpu_torch import zoo
from hesic_tpu_torch.models.dsic_codec import DSICCodec
from hesic_tpu_torch.models.hesic_codec import HESICCodec
from hesic_tpu_torch.training.losses import bits
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

HW = 64
ATOL = 2e-5
BITS_RTOL = 1e-4
SMALL = {"hesic": dict(N=16, M=24, K=2),
         "dsic": dict(N=8, M=16, F=6, C=8, K=2)}


def _pair(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, HW, HW, 3).astype(np.float32),
            rng.rand(1, HW, HW, 3).astype(np.float32))


def _rotated(deg=3.0, tx=2.0, ty=-1.5):
    th = np.deg2rad(deg)
    return np.array([[np.cos(th), -np.sin(th), tx],
                     [np.sin(th), np.cos(th), ty], [0, 0, 1]],
                    np.float32)[None]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(SMALL))
def test_c7_container_api_matches_reference_codec(name, tmp_path):
    cdc = zoo.create_model(name, device="cpu", seed=1,
                           **SMALL[name]).update()
    ref_cls = HESICCodec if name == "hesic" else DSICCodec
    ref = ref_cls(cdc.model)
    ref.tables, ref._medians = cdc.tables, cdc._medians
    x1, x2 = _pair(1)
    args = (x1, x2, _rotated()) if name == "hesic" else (x1, x2)
    comp = cdc.compress(*args, "fast", str(tmp_path))
    ref.compress(*args, "ref", str(tmp_path))
    for ext in ("npz", "bin"):
        assert _read(tmp_path / f"fast.{ext}") == _read(
            tmp_path / f"ref.{ext}")
    rec = cdc.decompress("fast", str(tmp_path))
    by_bytes = cdc.decompress_bytes(*comp["strings"])
    for k in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[k], comp[k], rtol=0, atol=0)
        torch.testing.assert_close(by_bytes[k], comp[k], rtol=0, atol=0)
    assert comp["bpp_real"] > 0


@pytest.mark.parametrize("name", list(SMALL))
def test_c7_fast_and_container_decodes_agree(name, tmp_path):
    cdc = zoo.create_model(name, device="cpu", seed=2,
                           **SMALL[name]).update()
    x1, x2 = _pair(2)
    h = _rotated() if name == "hesic" else None
    fast = cdc.decompress_fast(cdc.compress_fast(x1, x2, h)["blob"])
    args = (x1, x2, h) if name == "hesic" else (x1, x2)
    cdc.compress(*args, "ref", str(tmp_path))
    ref = cdc.decompress("ref", str(tmp_path))
    np.testing.assert_array_equal(np.asarray(fast["y1_hat"]),
                                  ref["y1_hat"].numpy())
    y2f = np.asarray(fast["y2_hat"])
    y2r = ref["y2_hat"].numpy()
    assert np.abs(y2f - y2r).max() <= 1
    assert np.mean(y2f != y2r) < 0.01
    assert np.isfinite(np.asarray(fast["x2_hat"])).all()


# arch: (widths, takes a homography)
FORWARD = {"bmshj2018-factorized": (dict(N=32, M=48), False),
           "hesic": (dict(N=16, M=24, K=2), True),
           "hesic-plus": (dict(N=16, M=24), True)}


@pytest.fixture(scope="module", params=list(FORWARD))
def carried(request):
    """(arch, the JAX codec, the port's codec on the JAX weights, the
    inputs as numpy)."""
    arch = request.param
    widths, with_h = FORWARD[arch]
    base = jzoo.create_model(arch, image_size=(HW, HW), **widths)
    cdc = zoo.create_model(arch, device="cpu", **widths)
    cdc.model.load_state_dict(hesic_from_jax(
        jax.tree_util.tree_map(np.asarray, base.params), cdc.model))
    x1, x2 = _pair(3)
    args = ((x1, x2, _rotated()) if with_h else (x1, x2)) \
        if zoo.is_stereo(arch) else (x1,)
    return arch, base, cdc, args


def test_c8_forward_matches_jax(carried):
    arch, base, cdc, args = carried
    want = base.forward(*(jnp.asarray(a) for a in args), training=False)
    mode = cdc.model.training
    got = cdc.forward(*args, training=False)
    assert set(got["likelihoods"]) == set(want["likelihoods"])
    for k, lik in want["likelihoods"].items():
        assert tuple(got["likelihoods"][k].shape) == lik.shape, k
        b_want = float(j_bits(lik))
        assert abs(float(bits(got["likelihoods"][k])) - b_want) \
            <= BITS_RTOL * abs(b_want), k
    keys = [k for k in ("x_hat", "x1_hat", "x2_hat") if k in want]
    assert keys
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=k)
    assert not got[keys[0]].requires_grad
    assert cdc.model.training == mode      # the caller's mode is kept


def test_c8_aux_loss_matches_jax(carried):
    _, base, cdc, _ = carried
    np.testing.assert_allclose(float(cdc.aux_loss()),
                               float(base.aux_loss()), rtol=1e-6)


def test_c8_forward_on_every_single_image_codec():
    """Every codec of the zoo's single-image families has forward."""
    rng = np.random.RandomState(4)
    x = rng.rand(1, HW, HW, 3).astype(np.float32)
    for arch, widths in (("bmshj2018-hyperprior", dict(N=8, M=12)),
                         ("mbt2018-mean", dict(N=8, M=12)),
                         ("mbt2018", dict(N=8, M=12))):
        out = zoo.create_model(arch, device="cpu", **widths).forward(x)
        assert tuple(out["x_hat"].shape) == x.shape
        assert set(out["likelihoods"]) == {"y", "z"}


def test_c9_device_codec_decompress_takes_shape():
    from hesic_tpu_torch.models.ar_device import \
        JointAutoregressiveDeviceCodec
    cdc = zoo.create_model("mbt2018", device="cpu", N=16, M=16)
    dev = JointAutoregressiveDeviceCodec(cdc.model).update()
    x, _ = _pair(5)
    comp = dev.compress(x)
    rec = dev.decompress(comp["strings"], comp["shape"])
    torch.testing.assert_close(rec["y_hat"], comp["y_hat"], rtol=0, atol=0)
