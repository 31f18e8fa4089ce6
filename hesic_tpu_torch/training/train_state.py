"""The training step: one Adam over two parameter groups, as
hesic_tpu/training/train_state.py does with optax.

Every parameter under a module whose name starts with
``entropy_bottleneck`` (the quantiles and the density's matrices, biases
and factors alike) is in the "aux" group, the rest in "main": the JAX
package's split, which differs from CompressAI's (quantiles only).  One
backward of rd loss + aux loss feeds both groups.  torch's Adam (betas
0.9/0.999, eps 1e-8 added outside the square root) is optax's update
rule.  The model and the optimizer hold the state that the JAX package's
TrainState carries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.persist import load_params, params_of, read_pickle, \
    write_pickle


def is_aux_path(name: str) -> bool:
    """True for parameters owned by the auxiliary group."""
    return any(part.startswith("entropy_bottleneck")
               for part in name.split("."))


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: "aux" or "main"}."""
    return {name: "aux" if is_aux_path(name) else "main"
            for name, _ in model.named_parameters()}


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4,
                   aux_lr: float = 1e-3) -> torch.optim.Adam:
    """Adam with a "main" group (transforms, lr) and an "aux" group
    (entropy bottlenecks, aux_lr).  Turns gradients on for every
    parameter it trains."""
    groups = {"main": [], "aux": []}
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        groups["aux" if is_aux_path(name) else "main"].append(p)
    return torch.optim.Adam(
        [{"params": groups["main"], "lr": lr, "name": "main"},
         {"params": groups["aux"], "lr": aux_lr, "name": "aux"}],
        betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: torch.nn.Module, optimizer, loss_fn):
    """step(batch, generator) -> metrics: one forward and backward of
    loss_fn(model, batch, generator) -> (loss, metrics), which must
    already include the aux loss, then one optimizer step.  The metrics
    (loss included) are detached 0-dim tensors on the model's device;
    reading them is left to the caller, so steps queue without a sync."""

    def step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch, generator)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    return step


def _names(model: torch.nn.Module) -> Dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def save_checkpoint(model: torch.nn.Module, optimizer, path: str,
                    step: int, **extra) -> None:
    """Write the model's weights, the optimizer's state per group and
    parameter name, the step count and `extra` (epoch, loss, ...)."""
    names = _names(model)
    opt_state = {}
    for group in optimizer.param_groups:
        per = opt_state.setdefault(group.get("name", "main"), {})
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st:
                per[names[id(p)]] = {k: v.detach().cpu().numpy().copy()
                                     for k, v in st.items()}
    write_pickle(path, {"params": params_of(model), "layout": "torch",
                        "opt_state": opt_state, "step": int(step), **extra})


def load_checkpoint(path: str, model: torch.nn.Module = None,
                    optimizer=None) -> dict:
    """Read a ``save_checkpoint`` file; load its weights into `model` and
    its Adam state into `optimizer` (built over the same parameter
    names) when given.  Returns the payload (step, epoch, loss, ...).
    The next step then takes the step the saved state would have."""
    payload = read_pickle(path)
    if model is not None:
        load_params(model, payload)
    if optimizer is not None:
        names = _names(model)
        saved = payload.get("opt_state") or {}
        for group in optimizer.param_groups:
            per = saved.get(group.get("name", "main"), {})
            for p in group["params"]:
                st = per.get(names[id(p)])
                if st is None:
                    optimizer.state.pop(p, None)
                    continue
                # Adam keeps `step` as a float32 CPU tensor unless it runs
                # fused or capturable; the moments live beside p
                on_host = not (group.get("fused") or group.get("capturable"))
                optimizer.state[p] = {
                    k: torch.from_numpy(np.array(v)).to(
                        "cpu" if k == "step" and on_host else p.device)
                    for k, v in st.items()}
    return payload
