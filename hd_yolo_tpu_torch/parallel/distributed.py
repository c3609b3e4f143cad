"""Several processes, one card each (port of ``hd_yolo_tpu/parallel/distributed.py``).

PyTorch's own way: torchrun (``python -m torch.distributed.run``) starts one
process per card and hands each its place in the environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
:func:`maybe_initialize_distributed` reads it and joins the group.  Rank 0
owns the host-side writes (logs, plots, checkpoints); every rank runs the
same steps and enters the same collectives.

A training step spans the group through :func:`global_batch`: inside it the
trunk's BatchNorm takes its statistics over the global batch
(:func:`all_sum`, autograd-aware, so the backward is global too) and the
losses divide by the global batch's counts (:func:`batch_count`).  Each
rank's loss is then its share of the global loss, and the gradients summed
over the ranks (:func:`all_reduce_grads`) are the global batch's.  Outside a
step (validation, inference) nothing is reduced.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor

_STEP_GROUP: List = []           # the group of the running global-batch step, if any


def maybe_initialize_distributed(device: Union[str, torch.device] = "cuda",
                                 timeout: Optional[float] = None) -> Tuple[int, int]:
    """Join the process group torchrun's environment describes, once.

    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` set: ``init_process_group`` on NCCL for a CUDA
    ``device`` (after ``torch.cuda.set_device(LOCAL_RANK)``) or gloo for the
    CPU, ``timeout`` seconds a collective.  NCCL without a card raises: there
    is no silent fall back to gloo.  Without the environment no group is made.
    A group that already exists is kept.  Returns (rank, world): (0, 1)
    without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return 0, 1
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the environment asks for a process group on CUDA (NCCL), but no "
                               "CUDA device is available; pass --device cpu for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]), **kw)
    return dist.get_rank(), dist.get_world_size()


def local_device(device: Union[str, torch.device]) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA ``device``
    inside a group of more than one rank, else ``device`` as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world_size() > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (as it is without a group)."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# --------------------------------------------------------- the global batch
@contextlib.contextmanager
def global_batch(group=None):
    """Inside the block the batch is the global one over ``group`` (the
    default group where ``group`` is None): BatchNorm statistics, loss
    counts, random draws (:func:`draw_rows`) and the packed mask branch's
    ROI budget span it.  Without a group the block changes nothing."""
    if not is_initialized():
        yield
        return
    _STEP_GROUP.append(group if group is not None else dist.group.WORLD)
    try:
        yield
    finally:
        _STEP_GROUP.pop()


def step_group():
    """The group of the running global-batch step, or None."""
    return _STEP_GROUP[-1] if _STEP_GROUP else None


def all_sum(x: Tensor) -> Tensor:
    """``x`` summed over the step's group, differentiably: the backward sums
    the cotangents over the group too.  ``x`` itself outside a step."""
    group = step_group()
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, op=dist.ReduceOp.SUM, group=group)


@torch.no_grad()
def batch_count(n: Tensor) -> Tensor:
    """A count (or any constant of the batch, outside autograd) summed over
    the step's group: a loss normaliser of the global batch."""
    group = step_group()
    if group is None:
        return n
    n = n.detach().clone()
    dist.all_reduce(n, group=group)
    return n


def global_mean(x: Tensor) -> Tensor:
    """The mean of ``x`` over the global batch: inside a step over several
    processes this rank's sum of ``x`` over the element count summed over
    the group (its share of the global mean); ``x.mean()`` elsewhere."""
    if step_group() is None:
        return x.mean()
    return x.sum() / batch_count(torch.full((), float(x.numel()), dtype=x.dtype,
                                            device=x.device))


def draw_rows(draw, shape: Sequence[int]) -> Tensor:
    """``draw(shape)``, a random draw whose leading axis runs over the
    batch's rows (images, or their windows image by image): inside a step
    over several processes the draw is made for the global batch (world x
    ``shape[0]`` rows, the same bits on every rank, whose generators move in
    step) and this rank's rows are kept, so the global batch draws what one
    process drawing for all of it draws; ``draw(shape)`` elsewhere."""
    group = step_group()
    if group is None:
        return draw(tuple(shape))
    n, r = shape[0], dist.get_rank(group)
    return draw((n * dist.get_world_size(group),) + tuple(shape[1:]))[r * n:(r + 1) * n]


BUCKET_BYTES = 64 << 20


@torch.no_grad()
def all_reduce_grads(grads: Sequence[Optional[Tensor]], params: Sequence[Tensor],
                     group=None) -> List[Tensor]:
    """The gradients summed over ``group``: a missing one (an unused
    parameter) is zeros, so every rank enters the same collectives; then
    buckets of up to ``BUCKET_BYTES`` a dtype, one flat all-reduce each."""
    out = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    buckets: List[List[int]] = []
    sizes: Dict[torch.dtype, Tuple[int, int]] = {}          # dtype → (bucket, bytes)
    for i, g in enumerate(out):
        b, used = sizes.get(g.dtype, (-1, BUCKET_BYTES))
        nbytes = g.numel() * g.element_size()
        if b < 0 or used + nbytes > BUCKET_BYTES:
            buckets.append([])
            b, used = len(buckets) - 1, 0
        buckets[b].append(i)
        sizes[g.dtype] = (b, used + nbytes)
    for idx in buckets:
        ts = [out[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        for i, v in zip(idx, flat.split([t.numel() for t in ts])):
            out[i] = v.view_as(out[i])
    return out


def all_gather_rows(tree, group=None):
    """Every leaf of a batch tree gathered over ``group`` along its leading
    axis, rank by rank (each rank holds rows of the same shape); bool
    leaves travel as uint8."""
    if isinstance(tree, dict):
        return {k: all_gather_rows(v, group) for k, v in tree.items()}
    x = tree.contiguous()
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out

