"""Port: the codecs' FLOP counts (``device_flops``) and the bench's MFU
fields and train point, on the CPU at tiny widths.

``device_flops`` is PyTorch's count of matmuls and convolutions
(FlopCounterMode), not XLA's cost analysis; no test compares it with the
JAX package's number.  Here:

* HESICFastCodec (N16/M24/K2) and DSICFastCodec (N16/M24/F6/C4/K2) give
  the JAX keys, each transform and conditioning program above 0 and the
  two stream programs (kernels 2 and 3) 0.0; the total is the JAX
  package's sum; flops_per_pair is the same at codec_batch 1 and 2, and
  HESIC's is four times as large at twice the side (its convolutions
  exactly, the whole within 1e-3: the hyper-decoder's upsampling is two
  matrix products, whose count grows eightfold, ~1e-4 of the whole).
* HESICPlusDeviceCodec (N16/M24, mm 8, 4 groups) gives its three
  programs above 0 and their sum; kernel 5's plain twin replaced by a
  stub that returns zeros of its shapes leaves the count unchanged, so
  the twin's products are not counted (the level scan runs as one
  operator the counter does not look into).
* A count leaves the codec's tables, grids and determinism policy as
  they were.
* The bench: ``mfu_fields`` raises on a count of 0 and on a share above
  100%; CPU rehearsals of ``--model train`` (size 64, batch 2, 1 step),
  ``--model hesic`` and ``--model hesic-plus-device`` (tiny models, 1
  calibration step) print their JSON lines with bench.py's keys, the
  rates and shares null off the card.

About 20 s on the CPU.
"""

import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch

from hesic_tpu_torch import bench
from hesic_tpu_torch.models import wavefront
from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.dsic_fast import DSICFastCodec
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
from hesic_tpu_torch.models.hesic_plus import HESICPlus

torch.set_num_threads(2)

FAST_KEYS = ("transforms_enc", "cond1", "cond2", "encode_stream",
             "decode_stream", "synth_out")
PLUS_KEYS = ("enc_transforms", "chain", "dec_out")
DSIC_CFG = dict(N=16, M=24, F=6, C=4, K=2)


@pytest.fixture(scope="module")
def hesic():
    return HESIC(N=16, M=24, K=2, device="cpu", seed=0)


@pytest.fixture(scope="module")
def plus():
    return HESICPlus(N=16, M=24, device="cpu", seed=0)


def _fast_total(per):
    return (per["transforms_enc"] + 2 * per["cond1"] + 2 * per["cond2"]
            + 2 * per["encode_stream"] + 2 * per["decode_stream"]
            + per["synth_out"])


@pytest.mark.parametrize("arch", ["hesic", "dsic"])
def test_fast_codec_flops(arch, hesic):
    if arch == "hesic":
        model, cls = hesic, HESICFastCodec
    else:
        model, cls = DSIC(**DSIC_CFG, device="cpu", seed=0), DSICFastCodec
    counts = {}
    for cb in (1, 2):
        codec = cls(model, mm=8, codec_batch=cb).update()
        for hw in (64, 128):
            counts[cb, hw] = codec.device_flops(hw, hw)
    fl = counts[2, 64]
    per = fl["per_program"]
    assert tuple(per) == FAST_KEYS
    for k in ("transforms_enc", "cond1", "cond2", "synth_out"):
        assert per[k] > 0, k
    assert per["encode_stream"] == per["decode_stream"] == 0.0
    assert fl["flops_total"] == _fast_total(per)
    assert fl["flops_per_pair"] == fl["flops_total"] / 2
    for hw in (64, 128):
        assert counts[1, hw]["flops_per_pair"] == \
            counts[2, hw]["flops_per_pair"]
    if arch == "hesic":
        big = counts[2, 128]
        for k in ("transforms_enc", "synth_out"):
            assert big["per_program"][k] == 4 * per[k], k
        ratio = big["flops_per_pair"] / fl["flops_per_pair"]
        assert abs(ratio / 4 - 1) < 1e-3


def test_fast_codec_flops_leave_the_codec_as_it_was(hesic):
    codec = HESICFastCodec(hesic, mm=8, codec_batch=2).update()
    tables = dict(codec.tables)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    a = codec.device_flops(64, 64, win=16)
    b = codec.device_flops(64, 64, cap=64, win=64, xwin=32)
    assert a == b            # the windows and the cap do not move it
    assert codec._next_mm is None
    assert codec.tables.keys() == tables.keys()
    assert all(codec.tables[k] is v for k, v in tables.items())
    assert flags == (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)


def test_hesic_plus_flops(plus, monkeypatch):
    codec = HESICPlusDeviceCodec(plus, mm=8, groups=4).update()
    fl = codec.device_flops(64, 64, batch=2)
    per = fl["per_program"]
    assert tuple(per) == PLUS_KEYS
    assert all(v > 0 for v in per.values())
    assert fl["flops_total"] == (per["enc_transforms"] + 2 * per["chain"]
                                 + per["dec_out"])
    assert fl["flops_per_pair"] == fl["flops_total"] / 2
    assert codec.device_flops(64, 64, batch=1)["flops_per_pair"] == \
        fl["flops_per_pair"]
    calls = []

    def stub(w, pre, post, y, cm, cv, words, counts, states, teacher, mm,
             groups):
        calls.append(teacher)
        b, hy, wy, _ = pre.shape
        m = w.ctx_kernel.shape[2]
        n_levels, _, _, p_max = wavefront.schedule(hy, wy)
        z = torch.zeros((n_levels * groups, b * p_max * (m // groups)),
                        dtype=torch.int32)
        return (z, z.clone(), torch.zeros((b, hy, wy, m)),
                torch.zeros((b, hy, wy, m), dtype=torch.int32))

    monkeypatch.setattr(wavefront, "ar_wavefront_plain", stub)
    assert codec.device_flops(64, 64, batch=2) == fl
    assert calls == [True, True]


def test_mfu_fields_raise():
    def codec(flops):
        return types.SimpleNamespace(
            device=torch.device("cuda"),
            device_flops=lambda h, w, **kw: {
                "flops_per_pair": flops, "flops_total": 2 * flops,
                "per_program": {}})

    got = bench.mfu_fields(codec(1e9), 512, 100.0, 989.4)
    assert got["tflops_per_sec"] == pytest.approx(0.1)
    assert got["mfu_pct_bf16"] == pytest.approx(100 * 0.1 / 989.4)
    with pytest.raises(RuntimeError):
        bench.mfu_fields(codec(0.0), 512, 100.0, 989.4)
    with pytest.raises(RuntimeError):
        bench.mfu_fields(codec(1e13), 512, 100.0, 989.4)


def _line(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench.main(argv + ["--device", "cpu", "--size", "64"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_bench_train_line(monkeypatch):
    monkeypatch.setattr(bench, "train_model", lambda args, dtype: HESIC(
        N=16, M=24, K=2, dtype=dtype, device=args.device, seed=0))
    line = _line(["--model", "train", "--batch", "2", "--steps", "1"])
    assert list(line)[:9] == ["metric", "value", "unit", "vs_baseline",
                              "model", "batch", "bf16", "f32",
                              "bf16_speedup"]
    assert line["metric"] == "hesic_train_pairs_per_sec_64px_bf16"
    assert line["unit"] == "pairs/s/chip" and line["batch"] == 2
    for key in ("peak_memory_gib", "flops_counter", "flops_scope",
                "peak_tflops", "backends", "card"):
        assert key in line
    assert line["flops_counter"] == "torch FlopCounterMode"
    assert line["peak_tflops"] == 989.4
    for prec in ("bf16", "f32"):
        res = line[prec]
        assert set(res) == {"steps_per_sec", "pairs_per_sec",
                            "tflops_per_sec", "mfu_pct_bf16",
                            "flops_per_step"}
        assert res["flops_per_step"] > 0
        assert res["tflops_per_sec"] is None and res["mfu_pct_bf16"] is None
    # the counter sees the same convolutions in either precision
    assert line["bf16"]["flops_per_step"] == line["f32"]["flops_per_step"]
    assert line["value"] == line["bf16"]["pairs_per_sec"]


@pytest.mark.parametrize("model", ["hesic", "hesic-plus-device"])
def test_bench_mfu_line(model, hesic, plus, monkeypatch):
    tiny = hesic if model == "hesic" else plus
    monkeypatch.setattr(bench, "build_model", lambda args: tiny)
    line = _line(["--model", model, "--batch", "2", "--batches", "2",
                  "--calib-steps", "1", "--bf16", "0", "--mm", "8",
                  "--groups", "4"])
    assert line["model"] == model
    assert line["flops_per_pair"] > 0
    assert line["flops_counter"] == "torch FlopCounterMode"
    assert line["peak_tflops"] == bench.PEAK_TFLOPS
    assert line["tflops_per_sec"] is None and line["mfu_pct_bf16"] is None
    keys = FAST_KEYS if model == "hesic" else PLUS_KEYS
    assert tuple(line["flops_per_program"]) == keys
    assert np.isfinite(line["value"]) and line["value"] > 0
