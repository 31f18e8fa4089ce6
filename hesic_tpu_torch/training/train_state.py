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

import torch


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
