"""Port: HESIC+'s host codec (hesic_tpu_torch/models/hesic_plus_codec.py
``HESICPlusCodec``) against the JAX package's, on the CPU, at N16/M24,
one 64x64 pair, float32, the JAX parameters carried over by
hesic_from_jax; at the identity and at a rotated homography (1.5
degrees about the centre plus a (3, -2) shift).

* Its own round trip is exact: the decoded y1_hat and y2_hat equal the
  encoder's (tolerance 0), also through a container file; the decoded
  y1_hat also equals a plain torch scan of the recursion
  (``ar_encode_scan``) within 1e-4.
* The writer byte: a container of the other writer (the card's, 6),
  of an unknown writer or of the JAX package (no writer byte) is
  refused, naming both writers; a container with trailing bytes is
  refused.
* Against JAX's HESICPlusCodec on the same pair and weights: the
  decoded latents within 1e-4 (the means come from the same float32
  chain computed in another order; on these pairs no cell lies on a
  rounding margin: measured 1.7e-6), the reconstructions x1_hat and
  x2_hat within X_TOL = 1e-5 (convolutions summed in another order:
  measured 1.6e-6), and bpp_real within 1% (the port's container is one
  writer byte longer: measured 1029 against 1028 bytes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.models import HESICPlus as JHESICPlus
from hesic_tpu.models import HESICPlusCodec as JCodec
from hesic_tpu_torch.models.autoregressive import (ar_encode_scan,
                                                   extract_ar_weights)
from hesic_tpu_torch.models.hesic_plus import HESICPlus
from hesic_tpu_torch.models.hesic_plus_codec import (HESICPlusCodec,
                                                     writer_id)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

SHAPES = [(1, 64, 64, 3), (1, 64, 64, 3), (1, 3, 3)]
X_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    base = JCodec.init(JHESICPlus(N=16, M=24), SHAPES, seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    model = HESICPlus(N=16, M=24, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return base, model


@pytest.fixture(scope="module")
def codec(models):
    return HESICPlusCodec(models[1]).update()


def _pair(seed, deg=0.0):
    rng = np.random.RandomState(seed)
    x1 = rng.rand(1, 64, 64, 3).astype(np.float32)
    x2 = rng.rand(1, 64, 64, 3).astype(np.float32)
    c = 31.5
    th = np.deg2rad(deg)
    r = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    t = np.array([[1, 0, c + (3 if deg else 0)],
                  [0, 1, c - (2 if deg else 0)], [0, 0, 1]])
    t0 = np.array([[1, 0, -c], [0, 1, -c], [0, 0, 1]])
    return x1, x2, (t @ r @ t0).astype(np.float32)[None]


CASES = {"identity": dict(seed=0), "rotated": dict(seed=1, deg=1.5)}


@pytest.fixture(scope="module")
def trips(codec):
    """Per case: the pair, the port's encode and its decode."""
    out = {}
    for name, kw in CASES.items():
        x1, x2, h = _pair(**kw)
        enc = codec.compress(x1, x2, h)
        out[name] = ((x1, x2, h), enc, codec.decompress(enc["strings"]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_exact(trips, case):
    (x1, x2, h), enc, rec = trips[case]
    for key in ("y1_hat", "y2_hat"):
        torch.testing.assert_close(rec[key], enc[key], rtol=0, atol=0)
    assert tuple(rec["x1_hat"].shape) == tuple(rec["x2_hat"].shape) == \
        x1.shape
    assert torch.isfinite(rec["x2_hat"]).all()
    np.testing.assert_array_equal(rec["h_matrix"], h)
    blob = enc["strings"][0]
    assert blob[0] == writer_id("cpu") == 5
    assert 0 < enc["bpp_real"] == len(blob) * 8 / (2 * 64 * 64)


def test_container_file_round_trip(codec, trips, tmp_path):
    (x1, x2, h), enc, _ = trips["rotated"]
    again = codec.compress(x1, x2, h, "pair0", str(tmp_path))
    assert again["strings"] == enc["strings"]
    assert (tmp_path / "pair0.hesicp").read_bytes() == enc["strings"][0]
    rec = codec.decompress("pair0", str(tmp_path))
    torch.testing.assert_close(rec["y2_hat"], enc["y2_hat"], rtol=0,
                               atol=0)


def test_left_latents_match_torch_scan(codec, models, trips):
    (x1, _, _), enc, rec = trips["identity"]
    model = models[1]
    with torch.no_grad():
        y1 = model.analysis1(torch.from_numpy(x1).permute(0, 3, 1, 2))
        z1_hat = codec.eb_decompress(
            "entropy_bottleneck1",
            codec.eb_compress("entropy_bottleneck1",
                              model.hyper_analysis1(y1)), (1, 1))
        pre = model.hyper_synthesis1(z1_hat)
    _, _, y_hat = ar_encode_scan(
        extract_ar_weights(model, "context_prediction1",
                           "entropy_parameters1"), y1, pre, None,
        codec.scale_table)
    np.testing.assert_allclose(y_hat.permute(0, 2, 3, 1).numpy(),
                               rec["y1_hat"].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("tag,named", [(6, "cuda-host-ar"),
                                       (9, "unknown writer (9)"),
                                       (64, "unknown writer (64)")])
def test_other_writers_refused(codec, trips, tag, named):
    blob = trips["identity"][1]["strings"][0]
    with pytest.raises(ValueError, match="torch-cpu-host-ar") as err:
        codec.decompress([bytes([tag]) + blob[1:]])
    assert named in str(err.value)


def test_jax_container_refused(codec, models):
    x1, x2, h = _pair(seed=0)
    j_blob = models[0].compress(jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(h))["strings"][0]
    with pytest.raises(ValueError, match="written by"):
        codec.decompress([j_blob])


def test_trailing_bytes_refused(codec, trips):
    blob = trips["identity"][1]["strings"][0]
    with pytest.raises(ValueError, match="ends at byte"):
        codec.decompress([blob + b"\0"])


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_codec(models, trips, case):
    base = models[0]
    (x1, x2, h), enc, rec = trips[case]
    j_enc = base.compress(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(h))
    j_rec = base.decompress(j_enc["strings"][0])
    assert abs(enc["bpp_real"] / j_enc["bpp_real"] - 1) < 0.01
    # on these pairs no latent lies on a rounding margin, so both sides
    # decode the same latents and the reconstructions follow
    for key in ("y1_hat", "y2_hat"):
        np.testing.assert_allclose(rec[key].numpy(), np.asarray(j_rec[key]),
                                   rtol=0, atol=1e-4)
    for key in ("x1_hat", "x2_hat"):
        np.testing.assert_allclose(rec[key].numpy(), np.asarray(j_rec[key]),
                                   rtol=0, atol=X_TOL)
