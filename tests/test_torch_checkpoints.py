"""Port: keeping what was trained.  The reference checkpoint converter
(hesic_tpu_torch/utils/convert_torch.py) against the JAX package's, the
codec persistence (models/base.py state_dict/save/load_state_dict/load),
the training checkpoints (training/train_state.py save_checkpoint/
load_checkpoint) and the zoo's pretrained= and checkpoint= branches, on
the CPU at the fixtures' tiny widths (N8/M16, 64x64).

Tolerances: converted and carried weights are equal (tolerance 0); the
tiny models' forwards against JAX's within 1e-4 (eval mode, rounded
latents, as tests/test_torch_hesic.py's forward); a resumed train step is
bit-equal to the uninterrupted one.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.utils.convert_torch as jconv
import hesic_tpu.zoo as jzoo
from hesic_tpu.models import HESIC as JHESIC
from hesic_tpu.models.base import CompressionModel as JCompressionModel
from hesic_tpu_torch import zoo
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.training import (load_checkpoint, make_loss_fn,
                                      make_optimizer, make_train_step,
                                      save_checkpoint)
from hesic_tpu_torch.utils import convert_torch as tconv
from hesic_tpu_torch.utils.from_jax import hesic_from_jax
from hesic_tpu_torch.utils.persist import read_pickle

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE_ARCH = {"hsic": "hesic", "hplus": "hesic-plus", "dsic": "dsic",
                "mbt": "mbt2018"}
FWD_ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(name):
    return tconv.read_reference(os.path.join(FIXTURES,
                                             f"ref_{name}_tiny.pth.tar"))


def _pair(seed=0, hw=64):
    from hesic_tpu_torch.training.recipe import smooth_pairs
    return smooth_pairs(np.random.RandomState(seed), 1, hw)


def _equal_trees(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=path)


# ---- convert_torch ----

@pytest.mark.parametrize("name", sorted(FIXTURE_ARCH))
def test_load_reference_equals_jax_conversion(name):
    payload = _fixture(name)
    arch = FIXTURE_ARCH[name]
    codec = tconv.build_for(arch, payload)
    want = hesic_from_jax(jconv.convert_state_dict(payload, arch),
                          codec.model)
    got = codec.model.state_dict()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # every parameter came from the file
    assert {k for k, _ in codec.model.named_parameters()} == set(want)


class _Seeded(dict):
    """A state dict with the reference's key names that invents a seeded
    array for each key a converter reads, in the order it reads them."""

    SHAPES = {"fc.2.weight": (4, 128 * 16 * 16)}

    def __init__(self, base=(), cross=True):
        super().__init__(base)
        self.rng = np.random.RandomState(5)
        self.cross = cross

    def __missing__(self, key):
        shape = self.SHAPES.get(key, (4, 3, 3, 3))
        if key.endswith(("EH1.conv1.weight", "EH2.conv1.weight")):
            shape = (32, 6 if self.cross else 3, 3, 3)
        v = self.rng.randn(*shape).astype(np.float32)
        self[key] = v
        return v

    def __contains__(self, key):
        if dict.__contains__(self, key):
            return True
        if key == "state_dict":
            return False
        for probe, limit in (("._matrices.", 5), ("._factors.", 4)):
            if probe in key:
                return int(key.rsplit(".", 1)[1]) < limit
        return key.endswith((".bias", "downsample.weight"))


_OTHER = {"bmshj2018-factorized": "mbt", "bmshj2018-hyperprior": "mbt",
          "mbt2018-mean": "mbt", "cheng2020-anchor": None,
          "cheng2020-attn": None, "hesic-together": "hsic",
          "hesic-plus-together": "hplus", "dsic-plus": "dsic",
          "homography-net": None}


@pytest.mark.parametrize("arch", sorted(_OTHER))
def test_every_converter_equals_jax(arch):
    assert set(_OTHER) | set(FIXTURE_ARCH.values()) == set(
        jconv.ARCH_CONVERTERS) == set(tconv.ARCH_CONVERTERS)
    base = {}
    if _OTHER[arch] is not None:
        sd = _fixture(_OTHER[arch])["state_dict"]
        together = arch.endswith("together") or arch == "dsic-plus"
        base = {("m1." if together else "") + k: v.numpy()
                for k, v in sd.items()}
    state = _Seeded(base, cross=arch != "dsic-plus")
    want = jconv.convert_state_dict(state, arch)
    got = tconv.convert_state_dict(dict(state), arch)
    _equal_trees(got, want)


def test_converted_hesic_forward_matches_jax():
    payload = _fixture("hsic")
    codec = tconv.build_for("hesic", payload)
    jc = JCompressionModel(JHESIC(N=8, M=16, K=2), jax.tree_util.tree_map(
        jnp.asarray, jconv.convert_state_dict(payload, "hesic")))
    x1, x2 = _pair()
    h = np.eye(3, dtype=np.float32)[None]
    want = jc.forward(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(h))
    with torch.no_grad():
        got = codec.model(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                            for a in (x1, x2)), torch.from_numpy(h))
    for k in ("x1_hat", "x2_hat"):
        np.testing.assert_allclose(
            got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
            atol=FWD_ATOL, err_msg=k)


def test_convert_torch_main_writes_the_codec_format(tmp_path):
    out = str(tmp_path / "hesic.pkl")
    tconv.main([os.path.join(FIXTURES, "ref_hsic_tiny.pth.tar"), "--arch",
                "hesic", "-o", out])
    state = read_pickle(out)
    assert state["layout"] == "torch" and state["module_class"] == "HESIC"
    assert state["config"] == {"N": 8, "M": 16, "K": 2}
    codec = zoo.create_model("hesic", checkpoint=out, device="cpu")
    want = tconv.build_for("hesic", _fixture("hsic")).model.state_dict()
    for k, v in codec.model.state_dict().items():
        assert torch.equal(v, want[k]), k


# ---- codec persistence ----

def _fast_blobs(codec, seed=1):
    x1, x2 = _pair(seed)
    return codec.compress_fast(x1, x2, np.eye(3, dtype=np.float32)[None])[
        "blobs"]


def test_save_load_keeps_params_tables_and_bytes(tmp_path):
    codec = zoo.create_model("hesic", seed=3, device="cpu", N=8, M=16,
                             K=2).update()
    path = str(tmp_path / "hesic.pkl")
    codec.save(path)
    loaded = zoo.create_model("hesic", checkpoint=path, device="cpu")
    for (k, a), b in zip(codec.model.state_dict().items(),
                         loaded.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert set(loaded.tables) == set(codec.tables)
    for k, t in codec.tables.items():
        for f in ("quantized_cdf", "cdf_length", "offset"):
            np.testing.assert_array_equal(getattr(loaded.tables[k], f),
                                          getattr(t, f))
    assert loaded.eb_medians("entropy_bottleneck1").tolist() == \
        codec.eb_medians("entropy_bottleneck1").tolist()
    assert _fast_blobs(loaded) == _fast_blobs(codec)
    again = type(codec).load(HESIC(N=8, M=16, K=2, seed=9, device="cpu"),
                             path)
    assert _fast_blobs(again) == _fast_blobs(codec)


def test_together_load_resets_inner_codec(tmp_path):
    codec = zoo.create_model("hesic-together", seed=3, device="cpu", N=8,
                             M=16, K=2).update()
    path = str(tmp_path / "together.pkl")
    codec.save(path)
    other = zoo.create_model("hesic-together", seed=4, device="cpu", N=8,
                             M=16, K=2)
    old_inner = other.inner
    other.load_state_dict(read_pickle(path))
    assert other.inner is not old_inner and other.inner.model is \
        other.model.m1
    assert set(other.tables) == set(codec.tables)
    for (k, a), b in zip(codec.model.state_dict().items(),
                         other.model.state_dict().values()):
        assert torch.equal(a, b), k


def _jax_codec_file(tmp_path):
    jc = jzoo.create_model("hesic", seed=2, N=8, M=16, K=2,
                           image_size=(64, 64)).update()
    path = str(tmp_path / "jax_hesic.pkl")
    jc.save(path)
    return jc, path


def test_jax_written_codec_loads_and_matches_forward(tmp_path):
    jc, path = _jax_codec_file(tmp_path)
    codec = zoo.create_model("hesic", checkpoint=path, device="cpu")
    assert (codec.model.N, codec.model.M, codec.model.K) == (8, 16, 2)
    assert set(codec.tables) == set(jc.tables)
    np.testing.assert_array_equal(
        codec.tables["entropy_bottleneck1"].quantized_cdf,
        jc.tables["entropy_bottleneck1"].quantized_cdf)
    x1, x2 = _pair(4)
    h = np.eye(3, dtype=np.float32)[None]
    want = jc.forward(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(h))
    with torch.no_grad():
        got = codec.model(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                            for a in (x1, x2)), torch.from_numpy(h))
    for k in ("x1_hat", "x2_hat"):
        np.testing.assert_allclose(
            got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
            atol=FWD_ATOL, err_msg=k)


def test_jax_file_load_imports_no_jax(tmp_path):
    _, path = _jax_codec_file(tmp_path)
    code = ("import sys\n"
            "from hesic_tpu_torch import zoo\n"
            f"c = zoo.create_model('hesic', checkpoint={path!r}, "
            "device='cpu')\n"
            "assert c.tables\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'hesic_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_reader_refuses_code(tmp_path):
    import pickle
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "f": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        read_pickle(path)


# ---- training checkpoints ----

def _batch(seed):
    x1, x2 = _pair(seed)
    return {"x1": torch.from_numpy(x1).permute(0, 3, 1, 2).contiguous(),
            "x2": torch.from_numpy(x2).permute(0, 3, 1, 2).contiguous(),
            "h": torch.eye(3)[None]}


def test_step_after_load_checkpoint_is_bit_equal(tmp_path):
    model = HESIC(N=8, M=16, K=2, seed=1, device="cpu")
    opt = make_optimizer(model)
    step = make_train_step(model, opt, make_loss_fn())
    gen = torch.Generator().manual_seed(3)
    step(_batch(0), gen)
    path = str(tmp_path / "checkpoint.pkl")
    save_checkpoint(model, opt, path, 1, epoch=1, loss=1.5)
    gen_state = gen.get_state()
    step(_batch(1), gen)
    want = {k: v.clone() for k, v in model.state_dict().items()}

    other = HESIC(N=8, M=16, K=2, seed=2, device="cpu")
    other_opt = make_optimizer(other)
    payload = load_checkpoint(path, other, other_opt)
    assert (payload["step"], payload["epoch"], payload["loss"]) == (1, 1,
                                                                   1.5)
    assert set(payload["opt_state"]) == {"main", "aux"}
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    make_train_step(other, other_opt, make_loss_fn())(_batch(1), gen2)
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
    for g_a, g_b in zip(opt.param_groups, other_opt.param_groups):
        for p, q in zip(g_a["params"], g_b["params"]):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(opt.state[p][key], other_opt.state[q][key])


# ---- the zoo ----

def test_pretrained_without_files_names_both_paths(tmp_path, monkeypatch):
    monkeypatch.setenv("HESIC_ZOO_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError) as err:
        zoo.create_model("hesic", 1, pretrained=True, device="cpu")
    for ext in (".pkl", ".pth.tar"):
        assert os.path.join(str(tmp_path), "hesic-q1-mse" + ext) in str(
            err.value)


def test_pretrained_converts_and_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("HESIC_ZOO_DIR", str(tmp_path))
    shutil.copy(os.path.join(FIXTURES, "ref_hsic_tiny.pth.tar"),
                tmp_path / "hesic-q2-mse.pth.tar")
    first = zoo.create_model("hesic", 2, pretrained=True, device="cpu")
    assert os.path.exists(tmp_path / "hesic-q2-mse.pkl")
    assert first.tables and first.model.N == 8
    os.remove(tmp_path / "hesic-q2-mse.pth.tar")
    second = zoo.create_model("hesic", 2, pretrained=True, device="cpu")
    want = tconv.build_for("hesic", _fixture("hsic")).model.state_dict()
    for k, v in second.model.state_dict().items():
        assert torch.equal(v, first.model.state_dict()[k]), k
        assert torch.equal(v, want[k]), k
    assert _fast_blobs(second) == _fast_blobs(first)


def test_checkpoint_round_trip_through_the_zoo(tmp_path):
    codec = zoo.create_model("mbt2018", seed=5, device="cpu", N=8, M=16)
    path = str(tmp_path / "mbt.pkl")
    codec.save(path)
    back = zoo.create_model("mbt2018", checkpoint=path, device="cpu")
    assert (back.model.N, back.model.M) == (8, 16) and not back.tables
    for (k, a), b in zip(codec.model.state_dict().items(),
                         back.model.state_dict().values()):
        assert torch.equal(a, b), k
