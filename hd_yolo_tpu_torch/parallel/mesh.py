"""The batch across ranks (port of ``hd_yolo_tpu/parallel/mesh.py``).

The JAX package builds a device mesh and lets XLA place the batch and insert
the gradient sum.  With one process a card each rank holds its own rows of the
global batch and its own copy of the model: :func:`auto_mesh` checks that the
global batch splits evenly, :func:`local_slice` cuts a rank's rows and
:func:`replicate` makes every rank's model rank 0's.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from .distributed import is_initialized, world_size


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
