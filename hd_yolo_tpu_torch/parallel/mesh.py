"""The batch and the parameters across ranks (port of
``hd_yolo_tpu/parallel/mesh.py``).

The JAX package builds a device mesh and lets XLA place the batch and insert
the gradient sum.  With one process a card each rank holds its own rows of the
global batch and its own copy of the model: :func:`auto_mesh` checks that the
global batch splits evenly, :func:`local_slice` cuts a rank's rows and
:func:`replicate` makes every rank's model rank 0's.

:func:`create_mesh` builds the 2-D ``("data", "model")`` ``DeviceMesh`` and
:func:`shard_params_tp` places the parameters on it by JAX's rule: a large
weight's out channels sharded over ``model``, the rest replicated.  XLA then
partitions the products; here DTensor's convolution rule shards only the
batch, and the port's own weight paths (folded BatchNorm, 1x1 convs as
``F.linear``, the ``ctypes`` kernels) take plain tensors.  So the placement
is the parameters' storage between steps — each rank of the model axis holds
its shard of a sharded weight — and :func:`make_mesh_train_step` makes every
weight whole (an all-gather over ``model``) before the step reads it, runs
the global-batch step over the ``data`` axis, and keeps the shards of the
update.  The numbers are the pure data-parallel step's, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .distributed import is_initialized, world_size

Tensor = torch.Tensor

DATA_AXIS = "data"
MODEL_AXIS = "model"


def auto_mesh(batch_size: int, world: Optional[int] = None) -> int:
    """The number of ranks the global batch ``batch_size`` is split over
    (``world``, the group's size by default); raises where it does not
    divide the batch."""
    world = world_size() if world is None else world
    if batch_size % world:
        raise ValueError(f"the global batch {batch_size} does not split over {world} "
                         f"processes; pass a --batch-size that {world} divides")
    return world


def local_slice(batch: Any, rank: int, world: int) -> Any:
    """Rank ``rank``'s contiguous share of every leaf's leading axis (a dict
    tree of tensors or arrays): rows ``[rank·n/world, (rank+1)·n/world)``."""
    if isinstance(batch, dict):
        return {k: local_slice(v, rank, world) for k, v in batch.items()}
    n = batch.shape[0] // world
    return batch[rank * n:(rank + 1) * n]


@torch.no_grad()
def replicate(model: nn.Module, src: int = 0) -> nn.Module:
    """Broadcast every parameter and buffer of ``model`` from rank ``src``, in
    place; returns ``model`` (unchanged without a group)."""
    if not is_initialized():
        return model
    import torch.distributed as dist

    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=src)
    return model


def create_mesh(shape: Optional[Sequence[int]] = None):
    """The 2-D ``(data, model)`` ``DeviceMesh`` over the default group's
    ranks, ``shape`` (world, 1) by default; on CUDA devices for an NCCL
    group, else on the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (world_size(), 1) if shape is None else tuple(shape)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def out_channel_axis(module: nn.Module, name: str, p: Tensor) -> int:
    """The axis of parameter ``name`` of ``module`` that the flax layout puts
    last (its out channels): 0 for a conv or linear weight, 1 for a
    transposed conv's, the last axis for a parameter of its own (a table)."""
    if name == "weight" and isinstance(module, nn.modules.conv._ConvTransposeNd):
        return 1
    if name == "weight" and isinstance(module, (nn.modules.conv._ConvNd, nn.Linear)):
        return 0
    return p.dim() - 1


def tp_placement(model: nn.Module, n_model: int, min_size: int = 1 << 16
                 ) -> Dict[str, Optional[int]]:
    """Parameter name → the axis it is sharded on over a ``model`` axis of
    ``n_model`` ranks, or None (replicated): JAX's rule, a parameter with
    ``ndim`` >= 2, at least ``min_size`` elements and out channels
    (:func:`out_channel_axis`) that ``n_model`` divides."""
    owner = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            owner.setdefault(id(p), (mod, pname))
    place = {}
    for name, p in model.named_parameters():
        mod, pname = owner[id(p)]
        ax = out_channel_axis(mod, pname, p)
        ok = n_model > 1 and p.dim() >= 2 and p.numel() >= min_size and p.shape[ax] % n_model == 0
        place[name] = ax if ok else None
    return place


def shard_params_tp(model: nn.Module, mesh, min_size: int = 1 << 16) -> Dict[str, Any]:
    """Place every parameter of ``model`` on ``mesh`` (:func:`create_mesh`) by
    :func:`tp_placement`: ``[Replicate(), Shard(axis)]`` for a sharded one,
    ``[Replicate(), Replicate()]`` for the rest, the values rank 0's.
    Returns name → ``DTensor``; each sharded parameter of ``model`` then
    holds only this rank's shard (the DTensor's local tensor) until
    :func:`unshard_params` makes it whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    place = tp_placement(model, mesh.size(1), min_size)
    placed = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            ax = place[name]
            placed[name] = distribute_tensor(
                p.detach(), mesh, [Replicate(), Replicate() if ax is None else Shard(ax)])
            p.data = placed[name].to_local()
    return placed


def unshard_params(model: nn.Module, placed: Dict[str, Any]) -> None:
    """Every parameter of ``model`` whole, from its placement (an all-gather
    over ``model`` for a sharded one); raises where ``placed`` does not hold
    exactly ``model``'s parameters, so none is left out."""
    names = dict(model.named_parameters())
    if set(names) != set(placed):
        raise ValueError(f"the placement does not match the model's parameters: "
                         f"{sorted(set(names) ^ set(placed))[:5]}")
    with torch.no_grad():
        for name, p in names.items():
            d = placed[name]
            p.data = d.full_tensor() if d.placements[1].is_shard() else d.to_local()


def reshard_params(model: nn.Module, placed: Dict[str, Any]) -> None:
    """Each whole parameter of ``model`` back to this rank's shard: the
    rank's slice of the out channels written into its DTensor's local
    tensor, which the parameter then holds (a replicated one holds that
    tensor throughout: :func:`unshard_params` hands it over as it is)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            d = placed[name]
            local = d.to_local()
            if d.placements[1].is_shard():
                ax = d.placements[1].dim
                n = local.shape[ax]
                local.copy_(p.data.narrow(ax, d.device_mesh.get_local_rank(MODEL_AXIS) * n, n))
            p.data = local


def make_mesh_train_step(mesh, placed: Dict[str, Any], **kw):
    """``step(state, batch)`` on ``mesh``: ``batch`` is this rank's rows of
    the global batch over the ``data`` axis (the same rows on every rank of
    the ``model`` axis).  The placed parameters are made whole
    (:func:`unshard_params`), ``engines/train_step.make_train_step
    (distributed=True)`` runs over the ``data`` axis's group (``kw`` go to
    it), and each rank keeps its shards of the update
    (:func:`reshard_params`)."""
    from ..engines.train_step import make_train_step

    inner = make_train_step(distributed=True, group=mesh.get_group(DATA_AXIS), **kw)

    def step(state, batch):
        unshard_params(state.model, placed)
        try:
            return inner(state, batch)
        finally:
            reshard_params(state.model, placed)

    return step
