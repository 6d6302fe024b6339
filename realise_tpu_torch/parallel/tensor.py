"""Tensor parallelism on ``torch.distributed``: the ``model`` mesh axis (the
port of what the JAX package leaves to GSPMD under
``realise_tpu/parallel/mesh.py``'s ``_TP_RULES``).

A mesh of ``data=D,model=M`` runs D·M processes, rank ``r`` at data index
``r // M`` and model index ``r % M``. :func:`mesh_groups` forms the process
groups: one data group for each model index (the ranks that hold the same
shards and all-reduce the step's sums) and one model group for each data
index (the ranks that split one replica). Every rank creates every group,
in the same order, as ``torch.distributed.new_group`` requires.

:func:`shard_module` replaces each parameter that ``param_shardings`` splits
by this rank's contiguous slice of it: Megatron's column split (dim 0 of the
(out, in) weight, and the bias) of q/k/v and of the FFN's first product,
and its row split (dim 1) of the attention output and of the FFN's second
product. Every rank starts from the same full weights (seeded alike, loaded
from one checkpoint). Each sharded encoder layer then runs its plain
sub-blocks (``ops/bert.py``) between Megatron's two conjugate operators
over the model group:

* :func:`copy_to_model` before a column-parallel product: the identity
  forward, an all-reduce SUM of the input's gradient backward;
* :func:`reduce_from_model` after a row-parallel product: an all-reduce
  SUM forward, the identity backward.

Both reduce in float32. The row-parallel partial products are computed in
float32 from the activation-dtype inputs, summed, and rounded to the
activation dtype once (``ops/bert.row_parallel_dense``): a bf16 layer then
differs from one process's by the order of its sums only, where a bf16
all-reduce of rounded partials would add a rounding for each. The
gradients that :func:`copy_to_model` sums are rounded once after the sum
in the same way.

:func:`gather_state_dict` all-gathers the slices over the model group into
the full, unsplit tensors (checkpoints hold those), and a sharded module
slices full tensors again when it loads them.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from realise_tpu_torch.parallel.mesh import (
    Mesh,
    check_model_axis,
    make_mesh,
    param_shardings,
)

Layout = Tuple[Tuple[int, ...], Tuple[int, ...]]


@dataclass(frozen=True, eq=False)
class MeshGroups:
    """This rank's place in a mesh and the process groups it reduces over.
    ``data_group``: the ranks of this model index (None: nothing to
    reduce, one data rank); ``model_group``: the ranks of this data index
    (None without a ``model`` axis)."""
    mesh: Mesh
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    def rows(self, x: torch.Tensor) -> Layout:
        """(global shape, offsets) of a tensor whose dim 0 is this data
        rank's contiguous rows of the global batch."""
        b = x.shape[0]
        rest = tuple(x.shape[1:])
        return ((self.mesh.data * b,) + rest,
                (self.data_index * b,) + (0,) * len(rest))

    def heads(self, x: torch.Tensor) -> Layout:
        """(global shape, offsets) of (B, heads, S, S) attention
        probabilities: this data rank's rows and this model rank's heads."""
        b, nh = x.shape[:2]
        rest = tuple(x.shape[2:])
        return ((self.mesh.data * b, self.mesh.model * nh) + rest,
                (self.data_index * b, self.model_index * nh)
                + (0,) * len(rest))


# The groups formed under each default process group, by mesh axes: a group
# formed anew (after a shutdown) is a new key, and never finds stale ones.
_GROUPS: "weakref.WeakKeyDictionary[Any, Dict[Tuple, MeshGroups]]" = (
    weakref.WeakKeyDictionary())


def mesh_groups(mesh: Union[Mesh, MeshGroups, None] = None
                ) -> Optional[MeshGroups]:
    """The groups of ``mesh`` on this rank (formed once per mesh and
    process group; a :class:`MeshGroups` comes back as it is). Without a
    process group: None (one process). ``mesh`` None: every rank on
    ``data``. Without a ``model`` axis the data group is the world, as
    data parallelism has it."""
    if isinstance(mesh, MeshGroups):
        return mesh
    if not dist.is_initialized():
        if mesh is not None and mesh.size > 1:
            raise ValueError(f"mesh {mesh} needs a process group of "
                             f"{mesh.size} ranks; none is initialized")
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh is None:
        mesh = make_mesh()
    elif mesh.size != world:
        raise ValueError(f"mesh {mesh} needs {mesh.size} ranks, the process "
                         f"group has {world}")
    d_size, m_size = mesh.data, mesh.model
    if m_size == 1:
        return MeshGroups(mesh, mesh.data_index(rank), 0, dist.group.WORLD)
    formed = _GROUPS.setdefault(dist.group.WORLD, {})
    key = tuple(mesh.axes.items())
    if key in formed:
        return formed[key]
    data_group = model_group = None
    if d_size > 1:
        for m in range(m_size):
            g = dist.new_group([d * m_size + m for d in range(d_size)])
            if mesh.model_index(rank) == m:
                data_group = g
    for d in range(d_size):
        g = dist.new_group([d * m_size + m for m in range(m_size)])
        if mesh.data_index(rank) == d:
            model_group = g
    groups = formed[key] = MeshGroups(mesh, mesh.data_index(rank),
                                      mesh.model_index(rank), data_group,
                                      model_group)
    return groups


# ------------------------------------------------------ conjugate operators
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        total = x.to(torch.float32, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient is the float32 sum over the model
    group (the input of a column-parallel product)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of ``x`` over the model group (the partial products
    of a row-parallel product); the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, group)


# ------------------------------------------------------------- the weights
def shard_tensor(t: torch.Tensor, dim: int, index: int,
                 count: int) -> torch.Tensor:
    """Slice ``index`` of ``count`` equal contiguous slices along ``dim``."""
    size = t.shape[dim] // count
    return t.narrow(dim, index * size, size)


def shard_module(model: nn.Module, groups: MeshGroups) -> Dict[str, int]:
    """Split ``model``'s parameters over the mesh's ``model`` axis in place;
    returns {name: split dim} of the parameters it split ({} when the
    model has nothing to split, or the axis is 1).

    Each split parameter becomes a new ``Parameter`` holding this rank's
    slice (build the optimizer after this). Every module with a ``tp``
    attribute (the BERT stacks and their layers, the model) gets
    ``groups``, which turns on the tensor-parallel forward. From then on
    ``model.load_state_dict`` takes full tensors and slices them (a tensor
    already of the slice's shape loads as it is). A model this rank already
    split over the same mesh stays as it is (a second Trainer over it)."""
    done = getattr(model, "tp", None)
    if done is not None:
        if (done.mesh, done.model_index) != (groups.mesh, groups.model_index):
            raise ValueError(f"the model is split over mesh {done.mesh} at "
                             f"model index {done.model_index} already")
        return dict(model.tp_splits)
    splits = {n: d for n, d in param_shardings(model.named_parameters(),
                                               groups.mesh).items()
              if d is not None}
    if not splits:
        return splits
    check_model_axis(groups.mesh.model, model.cfg)
    index, count = groups.model_index, groups.mesh.model
    with torch.no_grad():
        for name, dim in splits.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            full = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(
                shard_tensor(full.detach(), dim, index, count).clone(),
                requires_grad=full.requires_grad))
    for mod in model.modules():
        if hasattr(mod, "tp"):
            mod.tp = groups
    model.tp_splits = splits

    def slice_full(module, state_dict, prefix, *_):
        for name, dim in splits.items():
            key = prefix + name
            t = state_dict.get(key)
            local = module.get_parameter(name)
            if t is not None and t.shape[dim] == local.shape[dim] * count:
                state_dict[key] = shard_tensor(t, dim, index, count)

    model.register_load_state_dict_pre_hook(slice_full)
    return splits


_BITS = {4: torch.int32, 8: torch.int64}


def gather_tensor(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's slices of ``t`` joined along ``dim``, on every
    rank of the group. Taken as an all-reduce SUM of the slices' bits into
    a zeroed buffer (gloo has no all-gather of CUDA tensors): each element
    is one rank's bits plus zeros, so every value comes back exact."""
    count, index = dist.get_world_size(group), dist.get_rank(group)
    bits = _BITS.get(t.element_size(), torch.uint8)
    local = t.detach().contiguous().reshape(-1).view(bits)
    buf = torch.zeros((count, local.numel()), dtype=bits, device=t.device)
    buf[index] = local
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    parts = [buf[i].view(t.dtype).reshape(t.shape) for i in range(count)]
    return torch.cat(parts, dim=dim)


def gather_state_dict(state: Mapping[str, torch.Tensor],
                      splits: Mapping[str, int],
                      group) -> Dict[str, torch.Tensor]:
    """``state`` with every split entry gathered over the model group into
    its full tensor, in the state's order (every rank of the group must
    call it with the same keys)."""
    return {k: gather_tensor(v, splits[k], group) if k in splits else v
            for k, v in state.items()}
