"""Port: calibration runs under the codecs' determinism policy
(hesic_tpu_torch/training/recipe.py, models/base.py
``deterministic_backends``).

Each test starts from PyTorch's defaults (cuDNN non-deterministic and
benchmarking off, TF32 allowed in cuDNN and not in matmuls), restored
after it, runs ``calibrate`` or ``calibrate_single`` for two steps at a
tiny size on the CPU, and records the four flags inside the first
training step: they must be the policy's (deterministic cuDNN, no
benchmarking, no TF32 in convolutions or matmuls).
"""

import numpy as np
import pytest
import torch

from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.priors import (
    JointAutoregressiveHierarchicalPriors)
from hesic_tpu_torch.training import recipe

torch.set_num_threads(2)

FLAGS = (
    (torch.backends.cudnn, "deterministic", False, True),
    (torch.backends.cudnn, "benchmark", False, False),
    (torch.backends.cudnn, "allow_tf32", True, False),
    (torch.backends.cuda.matmul, "allow_tf32", False, False),
)


def _flags():
    return tuple(getattr(mod, name) for mod, name, _, _ in FLAGS)


@pytest.fixture
def defaults():
    """PyTorch's default flags for the test, the previous ones after."""
    before = _flags()
    for mod, name, default, _ in FLAGS:
        setattr(mod, name, default)
    yield
    for (mod, name, _, _), value in zip(FLAGS, before):
        setattr(mod, name, value)


@pytest.fixture
def seen(monkeypatch):
    """The flags as the first training step of a calibration sees them."""
    record = []
    trainer = recipe.trainer

    def recording_trainer(model):
        opt, step, gen = trainer(model)

        def first_step_records(data, generator):
            if not record:
                record.append(_flags())
            return step(data, generator)

        return opt, first_step_records, gen

    monkeypatch.setattr(recipe, "trainer", recording_trainer)
    return record


def _policy():
    return tuple(policy for _, _, _, policy in FLAGS)


def test_calibrate_runs_under_the_policy(defaults, seen):
    assert _flags() != _policy()
    model = HESIC(N=16, M=24, K=2, device="cpu")
    losses, _ = recipe.calibrate(model, np.random.RandomState(0), steps=2,
                                 hw=64, batch=1)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert seen == [_policy()]


def test_calibrate_single_runs_under_the_policy(defaults, seen):
    assert _flags() != _policy()
    model = JointAutoregressiveHierarchicalPriors(N=16, M=24, device="cpu")
    losses, _ = recipe.calibrate_single(model, np.random.RandomState(0),
                                        steps=2, hw=64, batch=1)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert seen == [_policy()]
