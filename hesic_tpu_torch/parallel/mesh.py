"""(data, model) mesh parallelism over torch.distributed, as
hesic_tpu/parallel/mesh.py.

The JAX module is one SPMD program in which XLA inserts every collective.
Here the same semantics are built by hand over ``torch.distributed``,
one process a rank, on a ``DeviceMesh`` with dims ("data", "model") over
the default process group, which the caller initialises (NCCL on the
card, each rank on ``cuda:<local rank>``; gloo on the CPU):

  * DP: each rank takes the contiguous slice of the batch at its "data"
    coordinate (``shard_batch``, plain local tensors), draws its part of
    the global batch's training noise, and the step averages the
    gradients over the "data" group with one all-reduce before a local
    Adam step.  Its losses are the global ones.  The gradient gate of a
    parameter's bound (GDN's beta and gamma) is not additive over the
    batch: it decides by the cotangent's mean over the "data" group (a
    small all-reduce in the backward; ``ops.data_split``), as the one
    process decides by the whole batch's.
  * TP: the parameters JAX's rule shards (``param_sharding``) keep only
    their rank's contiguous chunk on the "model" axis, and are rebuilt
    whole at each use by an all-gather over the "model" group, whose
    backward keeps the rank's slice of the gradient without a collective
    (every "model" rank runs the same replicated compute on the same data
    slice).  Convolutions see only whole tensors, so the math is the
    one-process step's: this is placement, not split compute.  DTensor's
    convolution rules cannot carry JAX's placement (a conv weight sharded
    on its output channels fails against its bias, a GDN gamma sharded on
    its input channels fails the channel check, and a transposed conv
    with its weight sharded on the output channels silently returns half
    the channels labelled replicated), so no sharded parameter reaches a
    convolution as a DTensor.  Adam is elementwise, so its step on the
    chunks is its step on the whole.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from ..layers import GDN, Conv, Deconv, MaskedConv2d
from ..models.dsic import Conv3D
from ..ops.ops import data_split

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % torch.cuda.device_count()


def make_mesh(shape: Optional[Sequence[int]] = None, device_type=None):
    """A (data, model) ``DeviceMesh`` over the default process group, which
    must be initialised; shape=None puts every rank on "data".  The device
    type is "cuda" (NCCL, this rank on cuda:<local rank>) unless the
    caller asks for "cpu" (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs the default process group: call torch."
            "distributed.init_process_group first (backend nccl on the "
            "card, gloo on the CPU)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    dp, tp = shape
    if dp * tp > world:
        raise ValueError(f"mesh {shape} needs {dp * tp} devices, "
                         f"have {world}")
    device_type = device_type or "cuda"
    backend = str(dist.get_backend())
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device")
        if "nccl" not in backend:
            raise RuntimeError(f"a cuda mesh needs the nccl backend; the "
                               f"default group runs {backend}")
        torch.cuda.set_device(_local_rank())
    elif device_type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"a cpu mesh needs the gloo backend; the "
                               f"default group runs {backend}")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _sizes(mesh) -> tuple:
    """(dp, tp) of a DeviceMesh, or of a mapping of axis sizes (as JAX's
    ``Mesh.shape``)."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.shape)
    return mesh[DATA_AXIS], mesh[MODEL_AXIS]


def _placements(mesh, batch: bool) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0) if batch else Replicate(), Replicate())


def replicated(mesh) -> tuple:
    """The placement of a tensor replicated over the mesh."""
    return _placements(mesh, False)


def batch_sharding(mesh) -> tuple:
    """The placement of a batch: its leading axis split over "data"."""
    return _placements(mesh, True)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh, batch):
    """This rank's part of a host batch (a tensor or array, or a dict,
    list or tuple of them): the contiguous slice [d*B/dp, (d+1)*B/dp) of
    every leaf's leading axis, d the rank's "data" coordinate, as plain
    tensors on the mesh's device."""
    dp = _sizes(mesh)[0]
    d = mesh.get_local_rank(DATA_AXIS)
    device = mesh_device(mesh)

    def part(x):
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if t.shape[0] % dp:
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"{dp} data ranks")
        b = t.shape[0] // dp
        return t[d * b:(d + 1) * b].to(device).contiguous()

    return _tree_map(part, batch)


def _shard_axis(module: nn.Module, name: str) -> Optional[int]:
    """The axis of the port's parameter that JAX's last axis of the leaf
    lands on under utils/from_jax.py, for the leaves JAX's rule looks at
    (a conv's or dense layer's ``kernel``, GDN's ``gamma``); None for the
    rest."""
    if name == "weight":
        if isinstance(module, (Deconv, nn.ConvTranspose2d)):
            return 1           # (in, out, k, k)
        if isinstance(module, (Conv, MaskedConv2d, Conv3D, nn.Conv2d,
                               nn.Conv3d, nn.Linear)):
            return 0           # (out, in, ...)
    if name == "gamma" and isinstance(module, GDN):
        return 1               # carried unchanged: JAX's last axis
    return None


def param_sharding(mesh, model: nn.Module) -> Dict[str, Optional[int]]:
    """{parameter name: the axis sharded over "model", or None}: JAX's
    rule (shard the last axis of a ``kernel`` or ``gamma`` leaf of two or
    more dims when the model axis is above 1 and divides that axis)
    mapped through the port's layouts.  `mesh` may be a DeviceMesh or a
    mapping of axis sizes."""
    tp = _sizes(mesh)[1]
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            axis = _shard_axis(module, pname)
            if not (tp > 1 and axis is not None and p.dim() >= 2
                    and p.shape[axis] % tp == 0):
                axis = None
            out[f"{mname}.{pname}" if mname else pname] = axis
    return out


class _Gather(torch.autograd.Function):
    """chunk -> the whole parameter (all-gather over the "model" group,
    concatenated on `axis`); the gradient of the whole -> this rank's
    slice of it, with no collective."""

    @staticmethod
    def forward(ctx, chunk, axis: int, group, tp: int, index: int):
        parts = [torch.empty_like(chunk) for _ in range(tp)]
        dist.all_gather(parts, chunk.contiguous(), group=group)
        ctx.axis, ctx.index, ctx.size = axis, index, chunk.shape[axis]
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.axis, ctx.index * ctx.size, ctx.size)
        return part.contiguous(), None, None, None, None


class _GatherOnUse(nn.Module):
    """The parametrization of a sharded parameter: holds the rank's chunk
    (``right_inverse``), gives the whole at each use (``forward``)."""

    def __init__(self, axis: int, group, tp: int, index: int):
        super().__init__()
        self.axis, self.group, self.tp, self.index = axis, group, tp, index

    def forward(self, chunk):
        return _Gather.apply(chunk, self.axis, self.group, self.tp,
                             self.index)

    def right_inverse(self, whole):
        return whole.chunk(self.tp, self.axis)[self.index].clone()


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """Place `model`'s parameters by the tensor-parallel rule, in place:
    each parameter ``param_sharding`` names keeps this rank's contiguous
    chunk on its axis (``module.parametrizations.<name>.original``), and
    is rebuilt whole at each use.  Build the optimizer afterwards, over
    the chunks.  Returns the model."""
    tp = _sizes(mesh)[1]
    if tp == 1:
        return model
    group = mesh.get_group(MODEL_AXIS)
    index = mesh.get_local_rank(MODEL_AXIS)
    modules = dict(model.named_modules())
    for name, axis in param_sharding(mesh, model).items():
        if axis is None:
            continue
        mname, _, pname = name.rpartition(".")
        parametrize.register_parametrization(
            modules[mname], pname, _GatherOnUse(axis, group, tp, index),
            unsafe=True)
    return model


def unshard_params(model: nn.Module) -> nn.Module:
    """Undo ``shard_params``: every sharded parameter becomes a plain
    parameter holding the whole tensor (one all-gather each, so every
    rank of a "model" group calls this together).  Returns the model."""
    for module in list(model.modules()):
        if parametrize.is_parametrized(module):
            for pname in list(module.parametrizations):
                parametrize.remove_parametrizations(
                    module, pname, leave_parametrized=True)
    return model


def _batch_size(batch) -> int:
    for leaf in _leaves(batch):
        if torch.is_tensor(leaf) and leaf.dim() > 0:
            return leaf.shape[0]
    raise ValueError("the batch holds no tensor with a batch axis")


def _average_grads(params, group, dp: int) -> None:
    """Each gradient <- its mean over the "data" group, in one all-reduce
    of the flattened gradients."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dp
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def _mean_over(metrics: dict, group, dp: int) -> dict:
    """0-dim metrics -> their means over the "data" group (in float64),
    each detached and in its own dtype."""
    vals = [v.detach() for v in metrics.values()]
    stacked = torch.stack([v.to(torch.float64) for v in vals])
    dist.all_reduce(stacked, group=group)
    stacked /= dp
    return {k: s.to(v.dtype)
            for k, s, v in zip(metrics, stacked.unbind(), vals)}


def make_parallel_train_step(model: nn.Module, optimizer, loss_fn, mesh):
    """step(local_batch, generator) -> metrics, as
    ``training.make_train_step``'s, over the mesh: the forward and
    backward of loss_fn(model, batch, generator) -> (loss, metrics) on
    this rank's slice of the batch (``shard_batch``), with this rank's
    part of the global batch's noise and its parameter gates decided by
    the global cotangents; the gradients averaged over the "data" group;
    one optimizer step on the local parameters (the chunks
    of sharded ones).  The metrics, loss included, are the global batch's:
    each averaged over the "data" group.  Every rank seeds its generator
    alike, so the ranks draw as one process would."""
    dp = _sizes(mesh)[0]
    d = mesh.get_local_rank(DATA_AXIS)
    group = mesh.get_group(DATA_AXIS)
    owned = {id(p) for p in model.parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if any(id(p) not in owned for p in params):
        raise ValueError("the optimizer holds parameters the model no "
                         "longer uses: build it after shard_params")

    def mean(g):
        g = g.clone()
        dist.all_reduce(g, group=group)
        return g / dp

    def step(batch, generator):
        optimizer.zero_grad(set_to_none=True)
        with data_split(d, dp, _batch_size(batch), mean):
            loss, metrics = loss_fn(model, batch, generator)
        loss.backward()
        _average_grads(params, group, dp)
        optimizer.step()
        return _mean_over(dict(metrics, loss=loss), group, dp)

    return step


def _gather_batch(t, group, dp: int):
    """A tensor with a batch axis -> the whole batch's, in "data" order."""
    if not torch.is_tensor(t) or t.dim() == 0:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dp)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def make_parallel_apply(model: nn.Module, mesh, method=None):
    """apply(*local_args, **kwargs): batched inference of `model` (or of
    its `method`, a name or a function of the model and the arguments) on
    this rank's slice of the batch, its outputs all-gathered on the batch
    axis, so every rank returns the whole batch's outputs."""
    dp = _sizes(mesh)[0]
    d = mesh.get_local_rank(DATA_AXIS)
    group = mesh.get_group(DATA_AXIS)
    if method is None:
        fn = model
    elif isinstance(method, str):
        fn = getattr(model, method)
    else:
        fn = functools.partial(method, model)

    @torch.no_grad()
    def apply(*args, **kwargs):
        with data_split(d, dp, _batch_size(args)):
            out = fn(*args, **kwargs)
        return _tree_map(lambda t: _gather_batch(t, group, dp), out)

    return apply
