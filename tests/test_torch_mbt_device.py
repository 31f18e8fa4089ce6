"""Port: mbt2018's wavefront device codec
(hesic_tpu_torch/models/ar_device.py ``JointAutoregressiveDeviceCodec``)
against the JAX package's, on the CPU, at tests/test_ar_device.py's
config: N=16, M=16, 64x64 images, B=2, mm 8, 4 channel groups, float32,
the JAX parameters carried over by hesic_from_jax.  Kernels 4 and 5 run
as their plain twins here.

* The port's compress -> decompress: decoded latents equal the encoder's
  (tolerance 0), also for an mm=1 case whose residuals escape the grid
  (the escape count sits at byte offset 21: the backend byte and the
  5 x u32 header before it), and for groups 1 and 4, whose streams
  differ while y_hat does not.
* Against JAX's JointAutoregressiveDeviceCodec on the same inputs and
  weights: y_hat within 1e-4 on every cell not within 1e-4 of a rounding
  boundary (the means come from the same float32 chain computed in
  another order), and bpp_real within 1%.
* The backend byte: a container of another backend is refused, naming
  both; an input that is not a multiple of 64 is refused.
* Kernel 4 launches once per batch, at cap T.
* The bench loop (hesic_tpu_torch/bench.py's device point) at a tiny
  size, in modes 1 and 0: every container exact, the threaded encode's
  container equal to the synchronous one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hesic_tpu.models import (JointAutoregressiveCodec,
                              JointAutoregressiveHierarchicalPriors as JMbt)
from hesic_tpu.models.ar_device import (
    JointAutoregressiveDeviceCodec as JDeviceCodec)
from hesic_tpu_torch import bench
from hesic_tpu_torch.codecs import pairs_rans
from hesic_tpu_torch.models.ar_device import JointAutoregressiveDeviceCodec
from hesic_tpu_torch.models.priors import (
    JointAutoregressiveHierarchicalPriors)
from hesic_tpu_torch.utils.from_jax import hesic_from_jax

torch.set_num_threads(2)

CFG = dict(N=16, M=16)


@pytest.fixture(scope="module")
def models():
    base = JointAutoregressiveCodec.init(JMbt(**CFG), [(1, 64, 64, 3)],
                                         seed=0)
    base.update()
    params = jax.tree_util.tree_map(np.asarray, base.params)
    model = JointAutoregressiveHierarchicalPriors(**CFG, device="cpu")
    model.load_state_dict(hesic_from_jax(params, model))
    return base, model


@pytest.fixture(scope="module")
def codec(models):
    return JointAutoregressiveDeviceCodec(models[1], mm=8,
                                          groups=4).update()


def _images(b=2, seed=0, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 64, 64, 3) * scale + shift).astype(np.float32)


def _round_trip(cdc, x):
    out = cdc.compress(x)
    rec = cdc.decompress(out["strings"])
    torch.testing.assert_close(rec["y_hat"], out["y_hat"], rtol=0, atol=0)
    return out, rec


def test_roundtrip_bit_exact(codec):
    x = _images()
    out, rec = _round_trip(codec, x)
    assert 0 < out["bpp_real"] < 64
    assert out["shape"] == (1, 1)
    assert tuple(rec["x_hat"].shape) == x.shape
    assert float(rec["x_hat"].min()) >= 0 and float(rec["x_hat"].max()) <= 1


def test_escape_corrections_roundtrip(models):
    hot = JointAutoregressiveDeviceCodec(models[1], mm=1, groups=4).update()
    out, _ = _round_trip(hot, _images(b=1, seed=1, scale=4.0, shift=-1.5))
    (n_esc,) = np.frombuffer(out["strings"][0], np.uint32, 1, 21)
    assert n_esc > 0 and out["escapes"] == n_esc


def test_groups_change_stream_not_result(models):
    x = _images(b=1, seed=2)
    outs = [_round_trip(JointAutoregressiveDeviceCodec(
        models[1], mm=8, groups=g).update(), x)[0] for g in (1, 4)]
    torch.testing.assert_close(outs[0]["y_hat"], outs[1]["y_hat"], rtol=0,
                               atol=0)
    assert outs[0]["strings"] != outs[1]["strings"]


@pytest.mark.parametrize("seed", [0, 3])
def test_matches_jax_codec(models, codec, seed):
    base, model = models
    x = _images(seed=seed)
    j_out = JDeviceCodec(base, mm=8, groups=4).compress(jnp.asarray(x))
    t_out = codec.compress(x)
    assert abs(t_out["bpp_real"] / j_out["bpp_real"] - 1) < 0.01
    with torch.no_grad():
        raw = model.analysis(torch.from_numpy(x).permute(0, 3, 1, 2))
    raw = raw.numpy().transpose(0, 2, 3, 1)
    ty, jy = t_out["y_hat"].numpy(), np.asarray(j_out["y_hat"])
    # off the rounding margin: y - y_hat is the residual's rounding error
    keep = ~(np.abs(np.abs(raw - ty) - 0.5) < 1e-4)
    assert keep.mean() > 0.95
    np.testing.assert_allclose(ty[keep], jy[keep], atol=1e-4, rtol=0)


@pytest.mark.parametrize("tag", [0, 2, 4, 5])
def test_backend_mismatch_raises(codec, tag):
    names = {0: "xla-scan", 2: "pallas-level-scan", 4: "cuda-level-scan",
             5: "cuda-level-scan-cluster"}
    with pytest.raises(ValueError) as err:
        codec.decompress([bytes([tag]) + b"\0" * 40])
    assert names[tag] in str(err.value)
    assert "torch-plain-level-scan" in str(err.value)


def test_input_not_a_multiple_of_64_raises(codec):
    with pytest.raises(ValueError, match="multiples of 64"):
        codec.compress(np.zeros((1, 64, 96, 3), np.float32))


def test_pairs_encoder_launches_once(codec, monkeypatch):
    calls = []
    encode = pairs_rans.rans_encode_pairs

    def counted(starts, freqs, valid, cap):
        calls.append(cap)
        return encode(starts, freqs, valid, cap)

    monkeypatch.setattr(pairs_rans, "rans_encode_pairs", counted)
    _round_trip(codec, _images(seed=4))
    assert calls == [codec.groups * (3 * (4 - 1) + (4 - 1) + 1)]


@pytest.mark.parametrize("pipeline", [1, 0])
def test_bench_loop(models, pipeline):
    """bench.py's ar-device loop at a tiny size: 2 calibration steps, a
    pool of one batch of 2 images cycled over 3 timed batches."""
    import copy
    model = copy.deepcopy(models[1])
    args = bench.parse_args(["--model", "mbt-device", "--device", "cpu",
                             "--size", "64", "--batch", "2", "--batches",
                             "3", "--calib-steps", "2", "--mm", "8",
                             "--groups", "4", "--pipeline", str(pipeline)])
    res = bench.bench(model, args, calib_hw=64)
    assert res["seconds"] > 0 and res["bpp_real"] > 0
    assert len(res["escapes"]) == 3


def test_count_launch_loses_no_update():
    """Kernel wrappers count through build.count_launch from the bench's
    worker thread and the main thread at once: under a short switch
    interval, 8 threads x 2000 counts must all land."""
    import sys
    import threading
    from hesic_tpu_torch.codecs import build
    name = "count_launch stress"
    build.launch_counts.pop(name, None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(name) for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert build.launch_counts.pop(name) == 8 * 2000
