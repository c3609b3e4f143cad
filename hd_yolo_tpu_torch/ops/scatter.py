"""Segment reductions (port of ``hd_yolo_tpu/ops/scatter.py``): the
per-segment max and the index attaining it, ``torch_scatter.scatter_max``
semantics, which the mask loss uses to pick the best-IoU proposal of each
ground-truth object."""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


def segment_max_with_argmax(values: Tensor, segment_ids: Tensor,
                            num_segments: int) -> Tuple[Tensor, Tensor]:
    """(n,) values and segment ids → per-segment max (num_segments,) and the
    index into ``values`` attaining it (int64).  Ties go to the smallest
    index; an empty segment gets the dtype's lowest value (−inf for floats,
    as ``jax.ops.segment_max``) and the sentinel ``n``; ids outside
    ``[0, num_segments)`` are dropped."""
    n = values.shape[0]
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    seg = torch.where(ok, segment_ids.long(), torch.full_like(segment_ids.long(), num_segments))
    lowest = -math.inf if values.is_floating_point() else torch.iinfo(values.dtype).min
    # one dump slot at num_segments takes the dropped ids
    seg_max = torch.full((num_segments + 1,), lowest, dtype=values.dtype, device=values.device)
    seg_max = seg_max.scatter_reduce(0, seg, values, "amax", include_self=True)[:num_segments]
    is_max = ok & (values >= seg_max[seg.clamp(max=num_segments - 1)])
    idx = torch.arange(n, device=values.device)
    cand = torch.where(is_max, idx, torch.full_like(idx, n))
    seg_arg = torch.full((num_segments + 1,), n, dtype=torch.int64, device=values.device)
    seg_arg = seg_arg.scatter_reduce(0, seg, cand, "amin", include_self=True)[:num_segments]
    return seg_max, seg_arg
