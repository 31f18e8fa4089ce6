"""Model zoo: name -> (model, codec) with the quality configurations.

Counterpart of hesic_tpu/zoo/__init__.py: the same twelve names and the
same ``cfgs`` (CompressAI's zoo/image.py for the single-image models, the
published configuration for the stereo ones), mapped to the port's
classes.  ``create_model`` builds the model at a quality point from a
seed, on the card unless the caller passes another device, and returns
its codec (tables not yet built: call ``update()``).  ``checkpoint=``
loads a codec file (the port's or the JAX package's,
``CompressionModel.save``); ``pretrained=True`` loads
``{name}-q{quality}-{metric}.pkl`` from ``zoo_cache_dir()``, or converts a
reference ``.pth.tar`` beside it (``utils.convert_torch``) and caches the
result there.  Nothing is fetched.
"""

from __future__ import annotations

import inspect
import os
from typing import Optional

from ..models.codec import (FactorizedPriorCodec, JointAutoregressiveCodec,
                            MeanScaleHyperpriorCodec, ScaleHyperpriorCodec)
from ..models.dsic import DSIC, DSICPlus
from ..models.dsic_codec import DSICCodec, DSICPlusCodec
from ..models.dsic_fast import DSICFastCodec
from ..models.hesic import HESIC, HESICTogether
from ..models.hesic_codec import HESICCodec, HESICTogetherCodec
from ..models.hesic_fast import HESICFastCodec
from ..models.hesic_plus import HESICPlus, HESICPlusTogether
from ..models.hesic_plus_codec import HESICPlusCodec, HESICPlusTogetherCodec
from ..models.priors import (FactorizedPrior,
                             JointAutoregressiveHierarchicalPriors,
                             MeanScaleHyperprior, ScaleHyperprior)
from ..models.waseda import Cheng2020Anchor, Cheng2020Attention
from ..utils.persist import read_pickle, write_pickle

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

# CompressAI's (name, quality, metric) -> URL table.  The port fetches
# nothing: pretrained checkpoints come from the zoo cache only, so the
# table stays empty and no code reads it.
model_urls: dict = {}


def zoo_cache_dir() -> str:
    """The local pretrained-checkpoint cache ($HESIC_ZOO_DIR, else the
    port's own directory under ~/.cache)."""
    return os.environ.get(
        "HESIC_ZOO_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "hesic_tpu_torch",
                     "zoo"))


def config_for(module_cls, config) -> dict:
    """The entries of a checkpoint's config that `module_cls` takes (a
    reference HESIC+ checkpoint names K, which HESIC+ does not take)."""
    params = inspect.signature(module_cls).parameters
    return {k: v for k, v in (config or {}).items() if k in params}


def _pretrained_state(name: str, quality: int, metric: str = "mse") -> dict:
    """The state of a pretrained checkpoint: ``{stem}.pkl`` (the codec
    format) from the zoo cache, else a reference ``{stem}.pth.tar``
    beside it, converted at the checkpoint's widths and cached as
    ``{stem}.pkl``; stem is ``{name}-q{quality}-{metric}``."""
    from ..utils.convert_torch import build_for, read_reference
    d = zoo_cache_dir()
    stem = f"{name}-q{quality}-{metric}"
    pkl = os.path.join(d, stem + ".pkl")
    if os.path.exists(pkl):
        return read_pickle(pkl)
    pth = os.path.join(d, stem + ".pth.tar")
    if not os.path.exists(pth):
        raise FileNotFoundError(
            f"no pretrained checkpoint for {name} q{quality} ({metric}): "
            f"expected {pkl} or {pth}. Put the reference torch checkpoint "
            f"at that path, or convert one with `python -m "
            f"hesic_tpu_torch.utils.convert_torch`.")
    state = build_for(name, read_reference(pth), quality).state_dict()
    write_pickle(pkl, state)
    return state


def is_stereo(name: str) -> bool:
    return name in _STEREO


def uses_homography(name: str) -> bool:
    return name in _WITH_HOMOGRAPHY


def create_model(name: str, quality: int = 1, seed: int = 0,
                 device="cuda", pretrained: bool = False,
                 checkpoint: Optional[str] = None, **overrides):
    """The codec of model `name` at `quality` on `device`, its weights
    drawn from `seed`, or loaded from a pretrained checkpoint (then its
    tables built) or a codec file; `overrides` replace constructor
    arguments (N, M, dtype, ...) after the file's config."""
    if name not in model_architectures:
        raise ValueError(f'Invalid architecture name "{name}" '
                         f"(choose from {sorted(model_architectures)})")
    if quality not in cfgs[name]:
        raise ValueError(f'Invalid quality "{quality}" for "{name}" '
                         f"(valid: {sorted(cfgs[name])})")
    module_cls, codec_cls = model_architectures[name]
    kwargs = dict(cfgs[name][quality], device=device, seed=seed)
    state = None
    if pretrained:
        state = _pretrained_state(name, quality,
                                  overrides.pop("metric", "mse"))
    elif checkpoint is not None:
        state = read_pickle(checkpoint)
    if state is not None:
        kwargs.update(config_for(module_cls, state.get("config")))
    kwargs.update(overrides)
    codec = codec_cls(module_cls(**kwargs))
    if state is None:
        return codec
    codec.load_state_dict(state)
    if pretrained and not codec.tables:
        codec.update()
    return codec
