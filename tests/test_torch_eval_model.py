"""Port: the eval_model CLI (hesic_tpu_torch/utils/eval_model.py), the
cases of tests/test_eval_model.py on the CPU, and both packages'
``--entropy-estimation`` on one folder with one JAX codec file loaded by
each: bpp, PSNR and MS-SSIM within 1e-4 relative (float32 forwards
summed in another order; the likelihoods' bits are held to 1e-4 in
tests/test_torch_codec_api.py).
"""

import numpy as np
import pytest
import torch

from hesic_tpu_torch.datasets.image_io import write_png
from hesic_tpu_torch.utils import eval_model

torch.set_num_threads(2)

EST_RTOL = 1e-4
CPU = ["--device", "cpu"]


def _stereo_tree(root, n=1, size=64):
    rng = np.random.RandomState(0)
    for eye in ("left", "right"):
        d = root / "test" / eye
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_png(str(d / f"{i}.png"),
                      (rng.rand(size, size, 3) * 255).astype(np.uint8))
    return str(root)


def _single_tree(root, n=1, size=96):
    d = root / "test"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(str(d / f"{i}.png"),
                  (rng.rand(size, size, 3) * 255).astype(np.uint8))
    return str(root)


def _ckpt(tmp_path, arch, **widths):
    from hesic_tpu_torch import zoo
    path = str(tmp_path / f"{arch}.pkl")
    zoo.create_model(arch, device="cpu", **widths).save(path)
    return path


class TestEvalModel:
    def test_single_image_entropy_estimation(self, tmp_path):
        data = _single_tree(tmp_path / "d")
        summary = eval_model.main([
            "--arch", "bmshj2018-factorized", "--dataset", data,
            "--entropy-estimation", "--max-images", "1", "--quality", "1",
            "--output", str(tmp_path / "out.json")] + CPU)
        res = summary["results"]
        assert res["bpp"] > 0
        assert np.isfinite(res["psnr"])
        assert (tmp_path / "out.json").exists()

    def test_single_image_real_coder(self, tmp_path):
        data = _single_tree(tmp_path / "d")
        ckpt = _ckpt(tmp_path, "bmshj2018-factorized", N=8, M=12)
        summary = eval_model.main([
            "--arch", "bmshj2018-factorized", "--dataset", data,
            "--checkpoint", ckpt, "--max-images", "1",
            "--workdir", str(tmp_path)] + CPU)
        res = summary["results"]
        assert res["bpp"] > 0
        assert res["encoding_time"] > 0 and res["decoding_time"] > 0

    def test_single_image_device_codec(self, tmp_path):
        """--device-codec codes mbt2018 through the wavefront codec (its
        kernels' plain twins on the CPU) behind the same CLI."""
        data = _single_tree(tmp_path / "d", size=64)
        ckpt = _ckpt(tmp_path, "mbt2018", N=8, M=16)
        summary = eval_model.main([
            "--arch", "mbt2018", "--dataset", data, "--checkpoint", ckpt,
            "--max-images", "1", "--workdir", str(tmp_path),
            "--device-codec"] + CPU)
        res = summary["results"]
        assert res["bpp"] > 0
        assert np.isfinite(res["psnr"])

    def test_stereo_device_codec(self, tmp_path):
        data = _stereo_tree(tmp_path / "d")
        ckpt = _ckpt(tmp_path, "hesic-plus", N=8, M=16)
        summary = eval_model.main([
            "--arch", "hesic-plus", "--dataset", data, "--checkpoint", ckpt,
            "--max-images", "1", "--workdir", str(tmp_path),
            "--device-codec"] + CPU)
        res = summary["results"]
        assert res["bpp"] > 0
        assert np.isfinite(res["psnr"])

    def test_stereo_real_coder_through_the_container(self, tmp_path):
        """hesic's zoo codec (HESICFastCodec) codes the pair through the
        reference-layout files (C7), as the JAX CLI does."""
        data = _stereo_tree(tmp_path / "d")
        ckpt = _ckpt(tmp_path, "hesic", N=8, M=16, K=2)
        work = tmp_path / "work"
        work.mkdir()
        summary = eval_model.main([
            "--arch", "hesic", "--dataset", data, "--checkpoint", ckpt,
            "--workdir", str(work)] + CPU)
        res = summary["results"]
        assert res["bpp"] > 0 and np.isfinite(res["ms-ssim"])
        assert (work / "eval_0.npz").exists() and (work / "eval_0.bin").exists()

    def test_device_codec_rejects_unsupported_arch(self, tmp_path):
        data = _single_tree(tmp_path / "d", size=64)
        with pytest.raises(SystemExit):
            eval_model.main(["--arch", "bmshj2018-factorized", "--dataset",
                             data, "--device-codec"] + CPU)

    def test_pad_unpad_roundtrip_as_jax(self):
        from hesic_tpu.utils import eval_model as j_eval
        x = np.random.RandomState(0).rand(1, 100, 130, 3).astype(np.float32)
        xp, meta = eval_model.pad_to_multiple(x, 64)
        assert xp.shape[1] % 64 == 0 and xp.shape[2] % 64 == 0
        np.testing.assert_array_equal(eval_model.unpad(xp, meta), x)
        jxp, jmeta = j_eval.pad_to_multiple(x, 64)
        np.testing.assert_array_equal(xp, jxp)
        assert meta == jmeta


@pytest.mark.parametrize("arch,widths,stereo", [
    ("bmshj2018-factorized", dict(N=8, M=12), False),
    ("hesic", dict(N=16, M=24, K=2), True)])
def test_entropy_estimation_matches_jax(arch, widths, stereo, tmp_path):
    import hesic_tpu.zoo as jzoo
    from hesic_tpu.utils import eval_model as j_eval
    data = (_stereo_tree if stereo else _single_tree)(tmp_path / "d",
                                                      size=64)
    ckpt = str(tmp_path / "jax.pkl")
    jzoo.create_model(arch, image_size=(64, 64), **widths).save(ckpt)
    args = ["--arch", arch, "--dataset", data, "--checkpoint", ckpt,
            "--entropy-estimation"]
    want = j_eval.main(args)["results"]
    got = eval_model.main(args + CPU)["results"]
    assert set(got) == set(want)
    for k in ("bpp", "psnr", "ms-ssim") + (("bpp1", "bpp2") if stereo
                                            else ()):
        assert abs(got[k] - want[k]) <= EST_RTOL * abs(want[k]), k
