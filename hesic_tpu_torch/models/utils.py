"""Parameter helpers over the port's flat state-dict names.

Counterpart of hesic_tpu/models/utils.py, whose helpers walk a nested
flax tree by 'a/b/c' paths.  The port's parameters are a flat mapping
of dotted names (``CompressionModel.state_dict()["params"]``, the layout
utils/persist.py reads); here a path joins the dotted name's parts with
'/'.  ``params`` is that mapping, or a module (its state_dict).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _flat(params) -> dict:
    """{'a/b/c': array} of a module, a state_dict or a flat name map."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return {k.replace(".", "/"): v for k, v in params.items()}


def find_param(params, path: str) -> Optional[Any]:
    """A parameter by 'a/b/c' path; None when absent."""
    return _flat(params).get(path)


def param_count(params) -> int:
    return sum(int(np.prod(tuple(v.shape))) for v in _flat(params).values())


def tree_paths(params) -> list[str]:
    """Every parameter's path as 'a/b/c', in the mapping's order."""
    return list(_flat(params))


def merge_params(base: dict, override: dict) -> dict:
    """`override` laid over `base` (a non-strict load: the reference's
    non-strict checkpoint filter); both flat name maps, keyed as given."""
    return {**base, **override}
