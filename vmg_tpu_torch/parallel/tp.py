"""Tensor parallelism of the training state over the mesh's ``tensor`` axis
(``vmg_tpu/parallel/tp.py``).

The JAX package shards a parameter over ``tensor`` when the LAST dim of
its flax leaf -- the output features or channels of a kernel -- is at
least ``min_channels`` and divisible by the tensor size, replicates
everything else, and lets GSPMD gather at use.  In the port's layout that
dim is dim 0 of an ``nn.Linear`` / ``nn.Conv2d`` weight (flax's (in, out)
and HWIO kernels are transposed into torch's (out, in) and OIHW, as
``weights.state_dict_from_jax`` maps them) and of the DCN's weight, and the
last dim of every other leaf (biases, norm scales, tables), whose shape is
flax's.

The layout-only port of that sharding: :func:`shard_params` keeps on each
tensor rank only its contiguous slice of every sharded leaf (a
``torch.nn.utils.parametrize`` parametrization holds the slice as
``<module>.parametrizations.<name>.original``); reading the leaf gathers it
over the tensor group in an autograd-aware gather whose backward keeps this
rank's slice of the gradient.  Tensor peers see the same rows, so that
slice is the whole gradient's slice and needs no sum; the data-axis mean
is as before.  The optimizer is built on the slices, so the float32
masters and the AdamW ``m`` and ``v`` of a sharded leaf take 1 / t of their
bytes on each rank.  The numbers are the replicated run's up to the order
of the gradient norm's sums (its sharded part is all-reduced over the
tensor group).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from vmg_tpu_torch.parallel.exchange import all_gather
from vmg_tpu_torch.parallel.mesh import Mesh


def _kernel_leaf(module: nn.Module, name: str) -> bool:
    """Whether ``module.name`` is a flax kernel the port stores transposed
    (its output dim first)."""
    from vmg_tpu_torch.models.vmg import DCNv2PackFlowGuided

    return name == "weight" and (isinstance(module, (nn.Linear, nn.Conv2d))
                                 or isinstance(module, DCNv2PackFlowGuided))


def _leaf_dim(module: nn.Module, name: str, shape) -> int:
    """The port's dim of a leaf that is the last dim of its flax leaf."""
    return 0 if _kernel_leaf(module, name) else len(shape) - 1


def _plain_name(name: str) -> str:
    return name.replace("parametrizations.", "").replace(".original", "")


def _leaves(model: nn.Module):
    """(plain state-dict name, module, attribute, tensor) of every parameter,
    a sharded one as its slice."""
    for mname, module in model.named_modules():
        if "parametrizations" in mname.split("."):
            continue
        originals = getattr(module, "parametrizations", {})
        for pname, p in module.named_parameters(recurse=False):
            yield f"{mname}.{pname}" if mname else pname, module, pname, p
        for pname, plist in originals.items():
            yield (f"{mname}.{pname}" if mname else pname), module, pname, plist.original


def param_shardings(mesh: Mesh, model: nn.Module, min_channels: int = 224
                    ) -> Dict[str, Optional[int]]:
    """State-dict name -> the dim it shards over ``tensor``, or None
    (replicated): the JAX package's rule (see the module docstring) on the
    port's layout.  With a tensor axis of 1 nothing shards."""
    out = {}
    for name, module, pname, p in _leaves(model):
        shape = getattr(module, "_vmg_tp_full", {}).get(pname, tuple(p.shape))
        dim = _leaf_dim(module, pname, shape) if len(shape) else None
        ok = (mesh.tensor > 1 and dim is not None and shape[dim] >= min_channels
              and shape[dim] % mesh.tensor == 0)
        out[name] = dim if ok else None
    return out


class _Gather(torch.autograd.Function):
    """Forward: the tensor group's slices concatenated along ``dim``;
    backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, part, dim, mesh):
        ctx.dim, ctx.index, ctx.size = dim, mesh.tensor_index, part.shape[dim]
        return torch.cat(all_gather(part, mesh.tensor_group, mesh.tensor, "weights"), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None


class ShardedLeaf(nn.Module):
    """The parametrization of a sharded leaf: stores this tensor rank's
    slice along ``dim``, reads as the whole leaf."""

    def __init__(self, dim: int, mesh: Mesh):
        super().__init__()
        self.dim, self.mesh = dim, mesh

    def forward(self, part):
        return _Gather.apply(part, self.dim, self.mesh)

    def right_inverse(self, whole):
        size = whole.shape[self.dim] // self.mesh.tensor
        return whole.narrow(self.dim, self.mesh.tensor_index * size, size).clone()


def shard_params(mesh: Mesh, model: nn.Module, min_channels: int = 224) -> nn.Module:
    """Keep only this tensor rank's slice of every leaf
    :func:`param_shardings` shards (in place; returns ``model``).  Every
    process of the group calls it on the same model; process 0's parameters
    are broadcast first, so the slices are of one model."""
    if mesh.tensor == 1:
        return model
    if dist.is_initialized():
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, src=0)
    rule = param_shardings(mesh, model, min_channels)
    model._vmg_tp_order = list(rule)  # the unsharded parameter order
    for name, module, pname, p in list(_leaves(model)):
        if rule[name] is None:
            continue
        full = getattr(module, "_vmg_tp_full", {})
        full[pname] = tuple(p.shape)
        module._vmg_tp_full = full
        parametrize.register_parametrization(module, pname, ShardedLeaf(rule[name], mesh),
                                             unsafe=True)
    return model


def sharded(model: nn.Module) -> bool:
    return hasattr(model, "_vmg_tp_order")


def _dims(model: nn.Module) -> Dict[str, Optional[int]]:
    """Plain state-dict name -> the dim its slice is cut along, or None:
    how :func:`shard_params` sharded ``model``."""
    return {name: module.parametrizations[pname][0].dim
            if parametrize.is_parametrized(module, pname) else None
            for name, module, pname, _ in _leaves(model)}


def sharded_mask(model: nn.Module) -> List[bool]:
    """Per parameter of ``model.parameters()``: whether it is a slice."""
    ids = {id(m.parametrizations[n].original) for m in model.modules()
           if parametrize.is_parametrized(m) for n in m.parametrizations}
    return [id(p) in ids for p in model.parameters()]


def state_shardings(mesh: Mesh, model: nn.Module, min_channels: int = 224
                    ) -> Dict[str, Optional[int]]:
    """The rule for a whole trainer state (``ckpt.io.trainer_state``'s
    dict): each parameter's, and the same for its AdamW ``m`` and ``v``
    (they mirror the parameters), under ``params.<name>``, ``mu.<name>`` and
    ``nu.<name>``; the step count replicates."""
    rule = param_shardings(mesh, model, min_channels)
    return {f"{part}.{k}": v for part in ("params", "mu", "nu") for k, v in rule.items()}


def _slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    if dim is None:
        return t
    size = t.shape[dim] // mesh.tensor
    return t.narrow(dim, mesh.tensor_index * size, size).clone()


def shard_state(mesh: Mesh, state: dict, model: nn.Module) -> dict:
    """This tensor rank's slices of a whole trainer state (a checkpoint of
    the unsharded trainer, or :func:`gather_state`'s), in the names and
    parameter order of ``model``, which :func:`shard_params` sharded, for
    ``ckpt.io.load_trainer_state``."""
    dims = _dims(model)
    order = model._vmg_tp_order
    by_name = {"mu": dict(zip(order, state["opt"]["mu"])),
               "nu": dict(zip(order, state["opt"]["nu"]))}
    names = [n for n, _ in model.named_parameters()]
    local = [_plain_name(n) for n in names]
    renamed = dict(zip(local, names))
    out = dict(state)
    out["params"] = {renamed.get(k, k): _slice(v, dims.get(k), mesh)
                     for k, v in state["params"].items()}
    out["opt"] = dict(state["opt"])
    for part in ("mu", "nu"):
        out["opt"][part] = [_slice(by_name[part][n], dims[n], mesh) for n in local]
    return out


def gather_state(mesh: Mesh, state: dict, model: nn.Module) -> dict:
    """The whole trainer state from every tensor rank's ``state`` (its
    ``ckpt.io.trainer_state``): plain names and the unsharded parameter
    order, as an unsharded trainer saves it.  Every tensor rank calls it."""
    dims = _dims(model)
    local = [_plain_name(n) for n, _ in model.named_parameters()]

    def whole(t, dim):
        if dim is None:
            return t
        return torch.cat(all_gather(t.contiguous(), mesh.tensor_group, mesh.tensor, "weights"),
                         dim)

    out = dict(state)
    out["params"] = {_plain_name(k): whole(v, dims.get(_plain_name(k)))
                     for k, v in state["params"].items()}
    out["opt"] = dict(state["opt"])
    for part in ("mu", "nu"):
        named = dict(zip(local, state["opt"][part]))
        out["opt"][part] = [whole(named[n], dims[n]) for n in model._vmg_tp_order]
    return out
