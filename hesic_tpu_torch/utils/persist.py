"""The port's persistence format and its safe reader.

One pickle of plain dicts, lists, numbers, strings and numpy arrays: a
model's weights are ``{"params": {dotted state_dict name: array},
"layout": "torch", ...}``.  ``read_pickle`` admits numpy's array, dtype
and scalar constructors and nothing else, so neither a file of the JAX
package (whose codec pickles hold only numpy) nor a hostile file can make
it import a module.  ``load_params`` also takes the JAX package's layout
(a nested flax tree and no ``layout`` key) through ``hesic_from_jax``.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

# (module, name) pairs a pickle of numpy arrays refers to, under numpy 1's
# and numpy 2's module names and pickle protocols 2-5
_ALLOWED = {(f"numpy.{core}.{mod}", name)
            for core in ("core", "_core")
            for mod, name in (("multiarray", "_reconstruct"),
                              ("multiarray", "scalar"),
                              ("numeric", "_frombuffer"))} | {
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


class _NumpyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"refusing {module}.{name}: a checkpoint holds plain data "
                f"and numpy arrays only")
        return super().find_class(module, name)


def read_pickle(path: str):
    """Load a checkpoint written by the port or the JAX package, admitting
    no class but numpy's arrays, dtypes and scalars."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def write_pickle(path: str, payload) -> None:
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=4)


def params_of(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's state_dict (parameters and buffers) as CPU numpy
    arrays under its dotted names."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def load_jax_tree(model: torch.nn.Module, tree: dict) -> None:
    """Load a flax tree of the JAX package's layout (numpy leaves; a
    ``{"params": ..., "batch_stats": ...}`` tree fills the batch norms'
    running statistics too) into `model` through ``hesic_from_jax``:
    every parameter must be carried and nothing else; buffers the tree
    does not carry (the masked convs' masks, the batch norms' counters)
    keep the model's own values."""
    from .from_jax import hesic_from_jax
    state = hesic_from_jax(tree, model)
    own = model.state_dict()
    missing = {k for k, _ in model.named_parameters()} - set(state)
    unknown = set(state) - set(own)
    if missing or unknown:
        raise KeyError(f"the tree does not fill {type(model).__name__}: "
                       f"missing {sorted(missing)[:5]}, unknown "
                       f"{sorted(unknown)[:5]}")
    model.load_state_dict({**own, **state}, strict=True)


def load_params(model: torch.nn.Module, payload: dict) -> None:
    """Copy ``payload["params"]`` into `model` in place, on its device:
    the port's layout (``"layout": "torch"``) strictly, the JAX package's
    nested flax tree through ``load_jax_tree``."""
    params = payload["params"]
    if payload.get("layout") == "torch":
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in params.items()}, strict=True)
    else:
        load_jax_tree(model, {"params": params})
