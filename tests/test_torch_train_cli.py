"""Port: the training CLIs (hesic_tpu_torch/training/train.py,
training/train_homography.py) on the CPU at tiny sizes (N8, 64x64
images, batch 2, one or two epochs), and ``make_loss_fn`` against the
JAX package's at the same weights.

Noise is shared as in tests/test_torch_training.py: both packages'
``quantize_noise`` take one numpy sequence over one seed in call order,
the port's draws mapped from JAX's NHWC layout to NCHW; the JAX side runs
eagerly and draws at each call's shape.  Tolerances: the loss and its
metrics within LOSS_RTOL relative of JAX's; the homography from a
JAX-written homography net within 1e-5; stage 2 leaves m1 bit-unchanged.
"""

import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hesic_tpu.ops.ops as j_ops
import hesic_tpu.training.train as jtrain
import hesic_tpu.utils.convert_torch as jconv
import hesic_tpu.zoo as jzoo
import hesic_tpu_torch.ops.ops as t_ops
from hesic_tpu.geometry import HomographyNet as JHomographyNet
from hesic_tpu_torch import zoo
from hesic_tpu_torch.datasets.image_io import write_png
from hesic_tpu_torch.training import train, train_homography
from hesic_tpu_torch.training.recipe import smooth_pairs
from hesic_tpu_torch.utils.persist import load_params, read_pickle, \
    write_pickle

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
LOSS_RTOL = 1e-5
H_ATOL = 1e-5
TINY = {"hesic": dict(N=8, M=16, K=2), "hesic-together": dict(N=8, M=16,
                                                              K=2),
        "dsic": dict(N=8, M=16, F=6, C=4, K=2), "mbt2018": dict(N=8, M=12),
        "bmshj2018-factorized": dict(N=8, M=12)}


def _folder(root, n=2, size=64, stereo=True):
    x1, x2 = smooth_pairs(np.random.RandomState(0), 2 * n, size)
    for split, lo in (("train", 0), ("test", n)):
        for eye, imgs in ((("left", x1), ("right", x2)) if stereo
                          else ((None, x1),)):
            d = os.path.join(root, split, *(() if eye is None else (eye,)))
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                write_png(os.path.join(d, f"{i:02d}.png"),
                          np.round(imgs[lo + i] * 255).astype(np.uint8))
    return root


def _args(model, data, ckpt, log, *extra):
    over = ",".join(f"{k}={v}" for k, v in TINY[model].items())
    return ["--model", model, "--dataset", data, "--batch-size", "2",
            "--patch-size", "64", "--overrides", over, "--checkpoint-dir",
            ckpt, "--log-file", log, "--device", "cpu", *extra]


def _shape_of(line):
    """A log line with its numbers replaced."""
    return re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line)


@pytest.fixture(scope="module")
def homo_net(tmp_path_factory):
    root = tmp_path_factory.mktemp("homo")
    data = _folder(str(root / "data"))
    train_homography.main(["--dataset", data, "--epochs", "1",
                           "--batch-size", "2", "--checkpoint-dir",
                           str(root / "ckpt"), "--device", "cpu"])
    return data, str(root / "ckpt")


def test_train_homography_writes_its_files(homo_net):
    _, ckpt = homo_net
    for name in ("homo_latest.pkl", "homo_best.pkl"):
        state = read_pickle(os.path.join(ckpt, name))
        assert state["module_class"] == "HomographyNet"
        assert state["layout"] == "torch" and state["epoch"] == 0
        assert np.isfinite(state["loss"])
    net = train.load_homography_net(os.path.join(ckpt, "homo_best.pkl"),
                                    "cpu")
    assert not any(p.requires_grad for p in net.parameters())


def test_hesic_one_epoch_then_resume(homo_net, tmp_path, capsys):
    data, homo = homo_net
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "log.txt")
    args = _args("hesic", data, ckpt, log, "--homography-net",
                 os.path.join(homo, "homo_best.pkl"))
    first = train.main(args + ["--epochs", "1"])
    assert first["step"] == 1 and len(first["epochs"]) == 1
    for name in ("checkpoint.pkl", "checkpoint_best_loss.pkl",
                 "model_latest.pkl"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    saved = read_pickle(os.path.join(ckpt, "checkpoint_best_loss.pkl"))
    assert saved["epoch"] == 1 and saved["step"] == 1
    capsys.readouterr()
    again = train.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    resume = os.path.join(ckpt, "checkpoint_best_loss.pkl")
    assert f"resumed from {resume} (epoch 1)" in out
    assert [e["epoch"] for e in again["epochs"]] == [1]
    assert again["step"] == 2
    # model_latest.pkl is the codec format the zoo loads
    codec = zoo.create_model("hesic", checkpoint=os.path.join(
        ckpt, "model_latest.pkl"), device="cpu")
    for k, v in codec.model.state_dict().items():
        assert torch.equal(v, again["codec"].model.state_dict()[k]), k


def _jax_log_lines(monkeypatch, data, tmp_path):
    """The JAX CLI's log lines over `data`, its model and steps stubbed
    (its loops, data and log format are its own)."""
    metrics = {"loss": 1.5, "mse": 0.25, "bpp": 0.5, "aux": 3.0}
    monkeypatch.setattr(jtrain, "create_model", lambda *a, **k: (
        types.SimpleNamespace(module=None, params={}, save=lambda p: None)))
    monkeypatch.setattr(jtrain, "make_train_step", lambda m, tx, f: (
        lambda state, batch, rng: (state, metrics)))
    monkeypatch.setattr(jtrain, "make_loss_fn", lambda *a, **k: (
        lambda module, params, batch, rng: (1.5, metrics)))
    jlog = str(tmp_path / "jlog.txt")
    jtrain.main(["--model", "bmshj2018-factorized", "--dataset", data,
                 "--epochs", "1", "--batch-size", "2", "--patch-size", "64",
                 "--checkpoint-dir", str(tmp_path / "jckpt"), "--log-file",
                 jlog])
    return open(jlog).read().splitlines()


def test_single_image_model_and_log_format(monkeypatch, tmp_path):
    data = _folder(str(tmp_path / "data"), stereo=False)
    log = str(tmp_path / "log.txt")
    out = train.main(_args("bmshj2018-factorized", data,
                           str(tmp_path / "ckpt"), log, "--epochs", "1"))
    assert out["step"] == 1
    lines = open(log).read().splitlines()
    jlines = _jax_log_lines(monkeypatch, data, tmp_path)
    assert [_shape_of(s) for s in lines] == [_shape_of(s) for s in jlines]
    assert lines[0].startswith("Train epoch 0: [0/2] Loss: ")
    assert lines[1].startswith("Test epoch 0: loss ")


def test_stage2_moves_m2_only(tmp_path):
    data = _folder(str(tmp_path / "data"))
    before = zoo.create_model("hesic-together", seed=0, device="cpu",
                              **TINY["hesic-together"]).model.state_dict()
    out = train.main(_args("hesic-together", data, str(tmp_path / "ckpt"),
                           str(tmp_path / "log.txt"), "--epochs", "1",
                           "--stage2"))
    after = out["codec"].model.state_dict()
    m1 = [k for k in after if k.startswith("m1.")]
    m2 = [k for k in after if k.startswith("m2.")]
    assert m1 and m2
    assert all(torch.equal(after[k], before[k]) for k in m1)
    assert any(not torch.equal(after[k], before[k]) for k in m2)
    names = {n for g in out["optimizer"].param_groups for n in g["params"]}
    assert len(names) == len(m2)


def test_bf16_refused_without_dtype(tmp_path, capsys):
    with pytest.raises(SystemExit) as err:
        train.main(_args("mbt2018", str(tmp_path), str(tmp_path / "c"),
                         str(tmp_path / "l"), "--bf16"))
    assert err.value.code == 2
    assert "--bf16 is not supported by mbt2018" in capsys.readouterr().err


# ---- make_loss_fn against the JAX package's ----

class _Noise:
    """One numpy sequence of U(-0.5, 0.5) draws, taken in call order."""

    def __init__(self, seed=11):
        self.rng = np.random.RandomState(seed)

    def _draw(self, shape):
        return self.rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    def jax(self, x, rng):
        return x + jnp.asarray(self._draw(x.shape)).astype(x.dtype)

    def torch(self, x, generator=None):
        if x.dim() == 4:
            b, c, h, w = x.shape
            n = self._draw((b, h, w, c)).transpose(0, 3, 1, 2)
        else:
            n = self._draw(tuple(x.shape))
        return x + torch.from_numpy(np.ascontiguousarray(n)).to(x.dtype)


def _fixture_tree(name):
    """(JAX param tree, config) of a reference fixture, by the JAX
    package's converter."""
    fixture = {"hesic": "hsic", "dsic": "dsic", "mbt2018": "mbt",
               "hesic-together": "hsic"}[name]
    payload = torch.load(os.path.join(FIXTURES,
                                      f"ref_{fixture}_tiny.pth.tar"),
                         map_location="cpu", weights_only=True)
    arch = "hesic" if name == "hesic-together" else name
    return jconv.convert_state_dict(payload, arch), payload["config"]


def _flax_convs(module):
    """A flax tree of a conv-only port module (kernels HWIO)."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        v = p.detach().numpy()
        node["kernel" if leaf == "weight" else leaf] = (
            v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
    return tree


@pytest.mark.parametrize("name,stage2", [("hesic", False), ("dsic", False),
                                         ("mbt2018", False),
                                         ("hesic-together", True)])
def test_make_loss_fn_matches_jax(monkeypatch, name, stage2):
    """At the reference fixtures' trained weights (HESIC's for m1, m2
    from the port's seed)."""
    monkeypatch.setattr(j_ops, "quantize_noise", _Noise().jax)
    monkeypatch.setattr(t_ops, "quantize_noise", _Noise().torch)
    tree, config = _fixture_tree(name)
    codec = zoo.create_model(name, device="cpu", **config)
    if stage2:
        tree = {"m1": tree, "m2": _flax_convs(codec.model.m2)}
    load_params(codec.model, {"params": tree})
    module = jzoo.model_architectures[name][0](**zoo.config_for(
        type(codec.model), config))
    x1, x2 = smooth_pairs(np.random.RandomState(2), 1, 64)
    h = np.array([[[1.0, 0.02, 1.5], [-0.01, 1.0, -0.5], [0, 0, 1]]],
                 np.float32)
    if zoo.is_stereo(name):
        batch = {"x1": x1, "x2": x2}
        if zoo.uses_homography(name):
            batch["h"] = h
    else:
        batch = {"x": x1}
    j_loss, j_m = jtrain.make_loss_fn(name, 1e-2, stage2)(
        module, jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    t_batch = {k: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous()
               if v.ndim == 4 else torch.from_numpy(v)
               for k, v in batch.items()}
    codec.model.requires_grad_(True)
    loss, m = train.make_loss_fn(name, 1e-2, stage2)(
        codec.model, t_batch, torch.Generator())
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    for k in ("bpp", "mse", "aux"):
        np.testing.assert_allclose(float(m[k].detach()), float(j_m[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    if stage2:
        loss.backward()
        assert all(p.grad is None for p in codec.model.m1.parameters())
        assert any(p.grad is not None and p.grad.abs().sum() > 0
                   for p in codec.model.m2.parameters())


def test_homography_from_a_jax_written_net(tmp_path):
    rng = np.random.RandomState(3)
    batch = {"x1": np.zeros((2, 64, 64, 3), np.float32),
             "homo_img1": rng.randn(2, 128, 128, 1).astype(np.float32),
             "homo_img2": rng.randn(2, 128, 128, 1).astype(np.float32),
             "corners": np.array([[[50, 60], [178, 60], [178, 188],
                                   [50, 188]]] * 2, np.float32)}
    params = jax.jit(JHomographyNet().init)(
        {"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(5)},
        jnp.asarray(batch["homo_img1"]),
        jnp.asarray(batch["homo_img2"]))["params"]
    path = str(tmp_path / "homo_best.pkl")
    write_pickle(path, {"params": jax.tree_util.tree_map(np.asarray, params),
                        "epoch": 0, "loss": 1.0})
    want = jtrain.make_homography_fn(path, (64, 64))(batch)
    got = train.make_homography_fn(path, (64, 64), "cpu")(
        train.to_device(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=H_ATOL)
    ident = train.make_homography_fn(None, (64, 64), "cpu")(
        train.to_device(batch, "cpu"))
    assert torch.equal(ident, torch.eye(3).expand(2, 3, 3))
