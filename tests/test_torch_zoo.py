"""Port: the model zoo (hesic_tpu_torch/zoo) against the JAX package's
(hesic_tpu/zoo): the same twelve names, the same quality configurations,
stereo and homography flags, the same errors for a bad name or quality,
and every name built on the CPU at its lowest quality (widths cut by
overrides) as the registry's model and codec classes, which carry the JAX
classes' names.  ``pretrained=True`` with nothing cached and
``checkpoint=`` of a missing file raise FileNotFoundError, never a
silent fallback to seeded weights (tests/test_torch_checkpoints.py loads
real files).
"""

import inspect

import pytest
import torch

import hesic_tpu.zoo as jzoo
from hesic_tpu_torch import zoo

# small widths for each family (the layers' structure is the published
# one; only N, M, F, C, K shrink)
SMALL = {"bmshj2018-factorized": dict(N=8, M=12),
         "bmshj2018-hyperprior": dict(N=8, M=12),
         "mbt2018-mean": dict(N=8, M=12), "mbt2018": dict(N=8, M=12),
         "cheng2020-anchor": dict(N=16), "cheng2020-attn": dict(N=16),
         "hesic": dict(N=8, M=16, K=2), "hesic-together": dict(N=8, M=16,
                                                               K=2),
         "hesic-plus": dict(N=8, M=16), "hesic-plus-together": dict(N=8,
                                                                    M=16),
         "dsic": dict(N=8, M=16, F=6, C=4, K=2),
         "dsic-plus": dict(N=8, M=16, F=6, C=4, K=2)}


def test_names_and_cfgs_equal_jax():
    assert list(zoo.model_architectures) == list(jzoo.model_architectures)
    assert zoo.cfgs == jzoo.cfgs
    assert set(SMALL) == set(zoo.model_architectures)
    assert zoo.models is zoo.model_architectures


@pytest.mark.parametrize("name", list(jzoo.model_architectures))
def test_registry_mirrors_jax(name):
    (tm, tc), (jm, jc) = (zoo.model_architectures[name],
                          jzoo.model_architectures[name])
    assert (tm.__name__, tc.__name__) == (jm.__name__, jc.__name__)
    assert zoo.is_stereo(name) == jzoo.is_stereo(name)
    assert zoo.uses_homography(name) == jzoo.uses_homography(name)


@pytest.mark.parametrize("name", list(SMALL))
def test_create_model_builds_the_registrys_classes(name):
    q = min(zoo.cfgs[name])
    cdc = zoo.create_model(name, q, seed=3, device="cpu", **SMALL[name])
    model_cls, codec_cls = zoo.model_architectures[name]
    assert type(cdc) is codec_cls and type(cdc.model) is model_cls
    assert all(p.device.type == "cpu" for p in cdc.model.parameters())
    assert not cdc.tables            # update() builds them
    again = zoo.create_model(name, q, seed=3, device="cpu", **SMALL[name])
    for (k, a), b in zip(cdc.model.state_dict().items(),
                         again.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_quality_config_reaches_the_model():
    cdc = zoo.create_model("cheng2020-anchor", 1, device="cpu")
    assert cdc.model.N == 128
    assert cdc.model.entropy_parameters_2.weight.shape[:2] == (341, 426)
    assert inspect.signature(zoo.create_model).parameters[
        "device"].default == "cuda"


def test_bad_name_and_quality_raise_as_jax():
    for kwargs in (dict(name="nonexistent"),
                   dict(name="bmshj2018-factorized", quality=99),
                   dict(name="cheng2020-attn", quality=7)):
        with pytest.raises(ValueError) as want:
            jzoo.create_model(**kwargs)
        with pytest.raises(ValueError) as got:
            zoo.create_model(**kwargs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs", [dict(pretrained=True),
                                    dict(checkpoint="model.pkl")],
                         ids=["pretrained", "checkpoint"])
def test_pretrained_and_checkpoint_raise(kwargs, monkeypatch, tmp_path):
    monkeypatch.setenv("HESIC_ZOO_DIR", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        zoo.create_model("mbt2018", 1, device="cpu", **kwargs)


def test_zoo_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("HESIC_ZOO_DIR", str(tmp_path))
    assert zoo.zoo_cache_dir() == str(tmp_path)
    monkeypatch.delenv("HESIC_ZOO_DIR")
    assert zoo.zoo_cache_dir().endswith("hesic_tpu_torch/zoo")
    assert zoo.zoo_cache_dir() != jzoo.zoo_cache_dir()
