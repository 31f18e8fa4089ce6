"""Port: the metrics and the CLIs of hesic_tpu_torch/utils (metrics,
codec_cli, update_model, bench_codecs, find_close, plot,
eval_homography, logging) and models/utils.py, against the JAX package's
where it computes the same thing; the cases of tests/test_metrics_and_cli.py.

Tolerances: ``psnr``, ``ssim`` and ``ms_ssim`` within 1e-5 of JAX's at
64x64 (the scale count shrinks to 3) and 192x192 (5 scales): float32
filters summed in another order.  ``compute_metrics`` within 1e-5 of
JAX's (PSNR in float64, identical up to the last bits).  The codec CLI's
decoded PNG equals the decoder's x_hat rounded, exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.utils import bench_codecs as j_bench
from hesic_tpu.utils import metrics as jm
from hesic_tpu.utils.find_close import find_closest as j_find_closest
from hesic_tpu_torch.datasets.image_io import read_png, write_png
from hesic_tpu_torch.geometry.net import HomographyNet
from hesic_tpu_torch.utils import metrics as tm

torch.set_num_threads(2)

PIL = pytest.importorskip("PIL")
MET_TOL = 1e-5


def _pair(hw, seed=0, noise=0.05):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, hw, hw, 3).astype(np.float32)
    y = np.clip(x + rng.randn(*x.shape) * noise, 0, 1).astype(np.float32)
    return x, y


class TestMetrics:
    def test_psnr_known_value(self):
        a = np.zeros((1, 64, 64, 3), np.float32)
        b = np.full_like(a, 0.1)
        assert abs(float(tm.psnr(a, b)) - 20.0) < 1e-3
        assert abs(tm.np_psnr(a, b) - 20.0) < 1e-3

    def test_ssim_identity(self):
        x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
        assert float(tm.ssim(x, x)) > 0.999
        assert float(tm.ms_ssim(x, x)) > 0.999

    def test_msssim_orders_degradations(self):
        rng = np.random.RandomState(1)
        x = rng.rand(1, 192, 192, 3).astype(np.float32)
        a = np.clip(x + rng.randn(*x.shape) * 0.02, 0, 1).astype(np.float32)
        b = np.clip(x + rng.randn(*x.shape) * 0.2, 0, 1).astype(np.float32)
        ms_a, ms_b = float(tm.ms_ssim(x, a)), float(tm.ms_ssim(x, b))
        assert 0 < ms_b < ms_a <= 1

    @pytest.mark.parametrize("hw", [64, 192])
    def test_metrics_match_jax(self, hw):
        x, y = _pair(hw)
        for name in ("psnr", "ssim", "ms_ssim"):
            want = float(getattr(jm, name)(jnp.asarray(x), jnp.asarray(y)))
            got = float(getattr(tm, name)(torch.from_numpy(x),
                                          torch.from_numpy(y)))
            assert abs(got - want) <= MET_TOL * max(1.0, abs(want)), name
        assert tm.np_psnr(x, y) == jm.np_psnr(x, y)

    def test_compute_metrics_matches_jax(self):
        from hesic_tpu_torch.utils.bench_codecs import compute_metrics
        x, y = _pair(96, seed=2)
        want = j_bench.compute_metrics(x[0], y[0])
        got = compute_metrics(x[0], y[0])
        assert set(got) == set(want) == {"psnr-rgb", "psnr-y",
                                         "ms-ssim-rgb"}
        for k in want:
            assert abs(got[k] - want[k]) <= MET_TOL * max(1.0, abs(want[k]))


def _write_png(path, seed=0, size=(128, 160)):
    rng = np.random.RandomState(seed)
    write_png(path, (rng.rand(size[0], size[1], 3) * 255).astype(np.uint8))


def _factorized_ckpt(tmp_path):
    from hesic_tpu_torch.zoo import create_model
    ckpt = str(tmp_path / "model.pkl")
    create_model("bmshj2018-factorized", N=8, M=12,
                 device="cpu").update().save(ckpt)
    return ckpt


class TestCodecCLI:
    def test_encode_decode_roundtrip(self, tmp_path):
        from hesic_tpu_torch.utils import codec_cli
        src = str(tmp_path / "in.png")
        _write_png(src)
        ckpt = _factorized_ckpt(tmp_path)
        out_bin = str(tmp_path / "out.bin")
        rec_png = str(tmp_path / "rec.png")
        codec_cli.main(["encode", src, "-o", out_bin,
                        "--arch", "bmshj2018-factorized",
                        "--checkpoint", ckpt, "--device", "cpu"])
        with open(out_bin, "rb") as f:
            blob = f.read()
        assert blob[:4] == b"HTPU" and blob[4] == 16     # the CPU twin
        rec = codec_cli.main(["decode", out_bin, "-o", rec_png,
                              "--checkpoint", ckpt, "--device", "cpu"])
        got = read_png(rec_png)
        assert got.shape == (128, 160, 3)
        # 128x160 pads to 128x192: 16 columns each side
        x = rec["x_hat"][0, :, 16:176].numpy()
        np.testing.assert_array_equal(
            got, np.clip(x * 255 + 0.5, 0, 255).astype(np.uint8))

    def test_decoder_refuses_another_writer(self, tmp_path):
        from hesic_tpu_torch.utils import codec_cli
        src = str(tmp_path / "in.png")
        _write_png(src, size=(64, 64))
        ckpt = _factorized_ckpt(tmp_path)
        out_bin = str(tmp_path / "out.bin")
        codec_cli.main(["encode", src, "-o", out_bin, "--checkpoint", ckpt,
                        "--device", "cpu"])
        with open(out_bin, "rb") as f:
            blob = bytearray(f.read())
        for tag in (17, 0):           # the card; a JAX file's arch byte
            blob[4] = tag
            bad = str(tmp_path / f"w{tag}.bin")
            with open(bad, "wb") as f:
                f.write(blob)
            with pytest.raises(ValueError, match="written by"):
                codec_cli.main(["decode", bad, "-o",
                                str(tmp_path / "r.png"), "--checkpoint",
                                ckpt, "--device", "cpu"])


class TestUpdateModelCLI:
    def test_rebuild_and_rename(self, tmp_path):
        from hesic_tpu_torch.utils import update_model
        from hesic_tpu_torch.zoo import create_model
        codec = create_model("bmshj2018-factorized", N=8, M=12,
                             device="cpu")
        ckpt = str(tmp_path / "raw.pkl")
        codec.save(ckpt)
        out = update_model.main([ckpt, "--arch", "bmshj2018-factorized",
                                 "--device", "cpu"])
        assert os.path.exists(out)
        assert "-" in os.path.basename(out)
        again = create_model("bmshj2018-factorized", checkpoint=out,
                             device="cpu")
        fresh = codec.update()
        for k, t in fresh.tables.items():
            np.testing.assert_array_equal(again.tables[k].quantized_cdf,
                                          t.quantized_cdf)


def _image_dir(tmp_path, n=2, size=(96, 96)):
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(n):
        _write_png(str(d / f"{i}.png"), seed=i, size=size)
    return str(d)


class TestBenchCodecs:
    def test_jpeg_runs_as_jax(self, tmp_path):
        from hesic_tpu_torch.utils.bench_codecs import collect
        d = _image_dir(tmp_path)
        res = collect("jpeg", d, [50, 90])
        assert res["name"] == "jpeg"
        assert len(res["results"]["bpp"]) == 2
        assert res["results"]["psnr-rgb"][1] > res["results"]["psnr-rgb"][0]
        want = j_bench.collect("jpeg", d, [50, 90])
        assert res["results"]["bpp"] == want["results"]["bpp"]
        for k, v in want["results"].items():
            if "time" not in k:
                np.testing.assert_allclose(res["results"][k], v,
                                           rtol=MET_TOL, err_msg=k)

    def test_jpeg_pool_equals_serial(self, tmp_path):
        from hesic_tpu_torch.utils.bench_codecs import collect
        d = _image_dir(tmp_path)
        one = collect("jpeg", d, [75])
        two = collect("jpeg", d, [75], jobs=2)
        for k in ("bpp", "psnr-rgb", "psnr-y", "ms-ssim-rgb"):
            assert two["results"][k] == one["results"][k], k

    def test_jpeg2000_runs(self, tmp_path):
        from hesic_tpu_torch.utils.bench_codecs import collect
        d = _image_dir(tmp_path, n=1)
        res = collect("jpeg2000", d, [2, 100])
        assert res["results"]["bpp"][1] < res["results"]["bpp"][0]
        assert res["results"]["psnr-rgb"][0] > 25

    def test_ycbcr444_roundtrip_as_jax(self):
        from hesic_tpu_torch.utils.bench_codecs import (_rgb_to_ycbcr444_u8,
                                                        _ycbcr444_u8_to_rgb)
        img = np.random.RandomState(0).rand(16, 24, 3).astype(np.float32)
        planes = _rgb_to_ycbcr444_u8(img)
        assert planes.shape == (3, 16, 24) and planes.dtype == np.uint8
        np.testing.assert_array_equal(planes,
                                      j_bench._rgb_to_ycbcr444_u8(img))
        back = _ycbcr444_u8_to_rgb(planes)
        assert np.abs(back - img).max() < 0.02

    def test_binary_codecs_gate_on_their_binaries(self):
        from hesic_tpu_torch.utils import bench_codecs as tb
        assert set(tb.CODECS) == set(j_bench.CODECS)
        for name, cls in tb.CODECS.items():
            codec = cls()
            if isinstance(codec, tb.BinaryCodec):
                assert codec.available() == j_bench.CODECS[name]().available()
            assert cls.quality_range == j_bench.CODECS[name].quality_range
        for cls in (tb.VTM, tb.HM):
            assert not cls().available()

    def test_plot_writes_figure(self, tmp_path):
        pytest.importorskip("matplotlib")
        from hesic_tpu_torch.utils.plot import plot_rd
        res = {"name": "jpeg",
               "results": {"bpp": [0.2, 0.5], "psnr": [28.0, 33.0]}}
        out = str(tmp_path / "rd.png")
        plot_rd([res], output=out)
        assert os.path.getsize(out) > 0

    def test_find_close_bisection(self, tmp_path):
        from hesic_tpu_torch.utils.bench_codecs import JPEG
        from hesic_tpu_torch.utils.find_close import find_closest
        src = str(tmp_path / "img.png")
        _write_png(src, size=(96, 96))
        q, val, res = find_closest(JPEG(), src, 2.0, "bpp")
        assert JPEG.quality_range[0] <= q <= JPEG.quality_range[1]
        assert "psnr-rgb" in res
        jq, jval, _ = j_find_closest(j_bench.JPEG(), src, 2.0, "bpp")
        assert (q, val) == (jq, jval)

    def test_find_close_reversed_and_plateau(self):
        from hesic_tpu_torch.utils.find_close import find_closest

        class FakeQP:
            quality_range = (0, 51)
            quality_reversed = True
            calls = 0

            def run(self, path, q):
                type(self).calls += 1
                return {"bpp": 8.0 / (1 + q)}

        q, val, _ = find_closest(FakeQP(), "x", 0.25, "bpp")
        assert abs(8.0 / (1 + q) - 0.25) == min(
            abs(8.0 / (1 + qq) - 0.25) for qq in range(0, 52))
        assert FakeQP.calls < 10

        class FakePlateau:
            quality_range = (1, 100)
            quality_reversed = False

            def run(self, path, q):
                return {"bpp": float(min(max(q, 40), 60)) / 10.0}

        q, val, _ = find_closest(FakePlateau(), "x", 7.3, "bpp")
        assert val == 6.0


class TestEvalHomographyCLI:
    def test_smoke_fresh_init(self, tmp_path, capsys):
        from hesic_tpu_torch.utils import eval_homography
        rng = np.random.RandomState(0)
        for eye in ("left", "right"):
            d = tmp_path / "data" / "test" / eye
            d.mkdir(parents=True)
            for i in range(2):
                write_png(str(d / f"{i:02d}.png"),
                          (rng.rand(96, 96, 3) * 255).astype(np.uint8))
        figs = tmp_path / "figs"
        summary = eval_homography.main([
            str(tmp_path / "data"), "--n", "1", "--timing-reps", "1",
            "--figures", str(figs), "--device", "cpu"])
        out = capsys.readouterr().out
        assert "MACE" in out and "params:" in out and "FlopCounterMode" in out
        assert (figs / "input_0.gif").exists()
        assert (figs / "output_patch0.gif").exists()
        assert summary["flops"] > 0 and np.isfinite(summary["mace"])
        assert summary["params"] == sum(
            p.numel() for p in HomographyNet(device="cpu").parameters())


class TestTFCIWrapper:
    def test_gates_on_script(self):
        from hesic_tpu_torch.utils.bench_codecs import TFCI
        assert not TFCI().available()
        assert TFCI.quality_range == (1, 8)


class TestPlotBackends:
    def test_plotly_backend_gates_gracefully(self, tmp_path, monkeypatch):
        import builtins
        real_import = builtins.__import__

        def fake_import(name, *args, **kwargs):
            if name.startswith("plotly"):
                raise ImportError("forced for test")
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", fake_import)
        from hesic_tpu_torch.utils import plot
        res = tmp_path / "r.json"
        res.write_text(json.dumps(
            {"name": "jpeg", "results": {"bpp": [0.2], "psnr": [30.0]}}))
        with pytest.raises(SystemExit):
            plot.main([str(res), "--backend", "plotly"])


class TestLoggingAndParamHelpers:
    def test_meters_and_spans(self, tmp_path):
        from hesic_tpu_torch.utils.logging import (AverageMeter, SpanTimer,
                                                   device_trace)
        m = AverageMeter()
        for v in (1.0, 2.0, 6.0):
            m.update(v)
        assert (m.val, m.avg, m.count) == (6.0, 3.0, 3)
        spans = SpanTimer()
        x = torch.ones(4)
        for _ in range(2):
            with spans("op", sync=x):
                x = x + 1
        assert "op:" in spans.report() and spans.meters["op"].count == 2
        with device_trace(str(tmp_path / "trace")):
            torch.ones(8).sum()
        assert (tmp_path / "trace" / "trace.json").exists()

    def test_param_helpers_over_flat_names(self):
        from hesic_tpu.models import utils as ju
        from hesic_tpu_torch.models import utils as tu
        from hesic_tpu_torch.zoo import create_model
        model = create_model("bmshj2018-factorized", N=8, M=12,
                             device="cpu").model
        paths = tu.tree_paths(model)
        assert paths and all("." not in p for p in paths)
        assert tu.param_count(model) == sum(
            v.numel() for v in model.state_dict().values())
        assert tu.find_param(model, paths[0]) is not None
        assert tu.find_param(model, "no/such") is None
        base = {"a/w": 1, "b/w": 2}
        assert tu.merge_params(base, {"b/w": 3, "c/w": 4}) == {
            "a/w": 1, "b/w": 3, "c/w": 4}
        # the JAX helpers on the same names as a nested tree agree
        nested = {"a": {"w": np.zeros(3)}, "b": {"w": np.zeros((2, 2))}}
        flat = {"a/w": nested["a"]["w"], "b/w": nested["b"]["w"]}
        assert tu.tree_paths(flat) == ju.tree_paths(nested)
        assert tu.param_count(flat) == ju.param_count(nested) == 7
