"""Model zoo: name -> (model, codec) with the quality configurations.

Counterpart of hesic_tpu/zoo/__init__.py: the same twelve names and the
same ``cfgs`` (CompressAI's zoo/image.py for the single-image models, the
published configuration for the stereo ones), mapped to the port's
classes.  ``create_model`` builds the model at a quality point from a
seed, on the card unless the caller passes another device, and returns
its codec (tables not yet built: call ``update()``).  Pretrained and
checkpoint loading are not carried over yet (ROADMAP A item 2): asking
for them raises.
"""

from __future__ import annotations

import os
from typing import Optional

from ..models.codec import (FactorizedPriorCodec, JointAutoregressiveCodec,
                            MeanScaleHyperpriorCodec, ScaleHyperpriorCodec)
from ..models.dsic import DSIC, DSICPlus
from ..models.dsic_codec import DSICPlusCodec
from ..models.dsic_fast import DSICFastCodec
from ..models.hesic import HESIC, HESICTogether
from ..models.hesic_codec import HESICTogetherCodec
from ..models.hesic_fast import HESICFastCodec
from ..models.hesic_plus import HESICPlus, HESICPlusTogether
from ..models.hesic_plus_codec import HESICPlusCodec, HESICPlusTogetherCodec
from ..models.priors import (FactorizedPrior,
                             JointAutoregressiveHierarchicalPriors,
                             MeanScaleHyperprior, ScaleHyperprior)
from ..models.waseda import Cheng2020Anchor, Cheng2020Attention

model_architectures = {
    "bmshj2018-factorized": (FactorizedPrior, FactorizedPriorCodec),
    "bmshj2018-hyperprior": (ScaleHyperprior, ScaleHyperpriorCodec),
    "mbt2018-mean": (MeanScaleHyperprior, MeanScaleHyperpriorCodec),
    "mbt2018": (JointAutoregressiveHierarchicalPriors,
                JointAutoregressiveCodec),
    "cheng2020-anchor": (Cheng2020Anchor, JointAutoregressiveCodec),
    "cheng2020-attn": (Cheng2020Attention, JointAutoregressiveCodec),
    "hesic": (HESIC, HESICFastCodec),
    "hesic-together": (HESICTogether, HESICTogetherCodec),
    "hesic-plus": (HESICPlus, HESICPlusCodec),
    "hesic-plus-together": (HESICPlusTogether, HESICPlusTogetherCodec),
    "dsic": (DSIC, DSICFastCodec),
    "dsic-plus": (DSICPlus, DSICPlusCodec),
}

# quality -> constructor kwargs (CompressAI zoo/image.py:105-155)
cfgs = {
    "bmshj2018-factorized": {q: {"N": 128, "M": 192} for q in range(1, 6)}
    | {q: {"N": 192, "M": 320} for q in range(6, 9)},
    "bmshj2018-hyperprior": {q: {"N": 128, "M": 192} for q in range(1, 6)}
    | {q: {"N": 192, "M": 320} for q in range(6, 9)},
    "mbt2018-mean": {q: {"N": 128, "M": 192} for q in range(1, 5)}
    | {q: {"N": 192, "M": 320} for q in range(5, 9)},
    "mbt2018": {q: {"N": 192, "M": 192} for q in range(1, 5)}
    | {q: {"N": 192, "M": 320} for q in range(5, 9)},
    "cheng2020-anchor": {q: {"N": 128, "M": 128} for q in range(1, 4)}
    | {q: {"N": 192, "M": 192} for q in range(4, 7)},
    "cheng2020-attn": {q: {"N": 128, "M": 128} for q in range(1, 4)}
    | {q: {"N": 192, "M": 192} for q in range(4, 7)},
    # stereo models use one published configuration
    "hesic": {q: {"N": 128, "M": 192, "K": 5} for q in range(1, 9)},
    "hesic-together": {q: {"N": 128, "M": 192, "K": 5} for q in range(1, 9)},
    "hesic-plus": {q: {"N": 128, "M": 192} for q in range(1, 9)},
    "hesic-plus-together": {q: {"N": 128, "M": 192} for q in range(1, 9)},
    "dsic": {q: {"N": 128, "M": 192, "F": 21, "C": 32, "K": 5}
             for q in range(1, 9)},
    "dsic-plus": {q: {"N": 128, "M": 192, "F": 21, "C": 32, "K": 5}
                  for q in range(1, 9)},
}

_STEREO = {"hesic", "hesic-together", "hesic-plus", "hesic-plus-together",
           "dsic", "dsic-plus"}
_WITH_HOMOGRAPHY = {"hesic", "hesic-together", "hesic-plus",
                    "hesic-plus-together"}

models = model_architectures  # reference-compatible alias

_NOT_YET = ("not carried over to the port yet (ROADMAP A item 2: "
            "checkpoints and convert_torch)")


def zoo_cache_dir() -> str:
    """The local pretrained-checkpoint cache ($HESIC_ZOO_DIR, else the
    port's own directory under ~/.cache)."""
    return os.environ.get(
        "HESIC_ZOO_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "hesic_tpu_torch",
                     "zoo"))


def is_stereo(name: str) -> bool:
    return name in _STEREO


def uses_homography(name: str) -> bool:
    return name in _WITH_HOMOGRAPHY


def create_model(name: str, quality: int = 1, seed: int = 0,
                 device="cuda", pretrained: bool = False,
                 checkpoint: Optional[str] = None, **overrides):
    """The codec of model `name` at `quality`, its weights drawn from
    `seed` on `device`; `overrides` replace constructor arguments (N, M,
    dtype, ...)."""
    if name not in model_architectures:
        raise ValueError(f'Invalid architecture name "{name}" '
                         f"(choose from {sorted(model_architectures)})")
    if quality not in cfgs[name]:
        raise ValueError(f'Invalid quality "{quality}" for "{name}" '
                         f"(valid: {sorted(cfgs[name])})")
    if pretrained:
        raise NotImplementedError(f"pretrained=True is {_NOT_YET}")
    if checkpoint is not None:
        raise NotImplementedError(f"checkpoint= is {_NOT_YET}")
    module_cls, codec_cls = model_architectures[name]
    kwargs = dict(cfgs[name][quality], device=device, seed=seed)
    kwargs.update(overrides)
    return codec_cls(module_cls(**kwargs))
