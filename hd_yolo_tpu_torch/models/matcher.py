"""YOLOv5-style anchor/cell target assignment with static shapes (port of
``hd_yolo_tpu/models/matcher.py``).

Per level, every (offset o in 5, anchor a in A, image b in B, target t in T)
candidate keeps a fixed slot with a validity bit: the (anchor, target) pairs
whose wh ratio is within ``anchor_t``, each replicated into the centre cell
and its two nearest neighbours by fractional offset.  Slot order is the JAX
package's: N = 5·A·B·T, flattened (o, a, b, t).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

Tensor = torch.Tensor

# (dx, dy) offsets scaled by g = 0.5: centre, right, down, left, up
_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (-0.5, 0.0), (0.0, -0.5))


@dataclasses.dataclass
class LevelMatches:
    """Per-level matched candidates, flattened to N = 5·A·B·T slots."""

    b: Tensor          # (N,) image index
    a: Tensor          # (N,) anchor index
    gj: Tensor         # (N,) grid row
    gi: Tensor         # (N,) grid col
    tbox: Tensor       # (N, 4) regression target (dx, dy, w, h) in feature cells
    anchor_wh: Tensor  # (N, 2) matched anchor in feature cells
    obj_idx: Tensor    # (N,) flat GT id b·T + t
    valid: Tensor      # (N,) bool


def match_level(boxes_n: Tensor, valid: Tensor, anchors: Tensor, ny: int, nx: int,
                anchor_t: float) -> LevelMatches:
    """boxes_n (B, T, 4) normalized xywh, valid (B, T), anchors (A, 2) in
    feature cells → the level's candidate slots."""
    B, T, _ = boxes_n.shape
    A = anchors.shape[0]
    dev, dt = boxes_n.device, boxes_n.dtype
    scale = torch.tensor([nx, ny], dtype=dt, device=dev)
    gxy = boxes_n[..., :2] * scale                                    # (B, T, 2)
    gwh = boxes_n[..., 2:4] * scale

    r = gwh[None] / anchors[:, None, None, :].clamp(min=1e-9)          # (A, B, T, 2)
    ratio = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(-1)
    keep_anchor = ratio < anchor_t                                    # (A, B, T)

    gx, gy = gxy[..., 0], gxy[..., 1]
    gxi, gyi = nx - gx, ny - gy
    g = 0.5
    flags = torch.stack([
        torch.ones_like(gx, dtype=torch.bool),
        (torch.remainder(gx, 1.0) < g) & (gx > 1.0),
        (torch.remainder(gy, 1.0) < g) & (gy > 1.0),
        (torch.remainder(gxi, 1.0) < g) & (gxi > 1.0),
        (torch.remainder(gyi, 1.0) < g) & (gyi > 1.0),
    ])                                                                # (5, B, T)

    off = torch.tensor(_OFFSETS, dtype=dt, device=dev)
    gij = torch.floor(gxy[None] - off[:, None, None, :]).to(torch.int32)   # (5, B, T, 2)
    gi = gij[..., 0].clamp(0, nx - 1)
    gj = gij[..., 1].clamp(0, ny - 1)
    tx = gxy[None, ..., 0] - gij[..., 0].to(dt)
    ty = gxy[None, ..., 1] - gij[..., 1].to(dt)

    cand_valid = flags[:, None] & keep_anchor[None] & valid[None, None]   # (5, A, B, T)
    shape5 = (5, A, B, T)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    b_idx = ar(B)[None, None, :, None].expand(shape5)
    a_idx = ar(A)[None, :, None, None].expand(shape5)
    t_idx = ar(T)[None, None, None, :].expand(shape5)
    bcast = lambda x: x[:, None].expand(shape5)                       # (5, B, T) → (5, A, B, T)
    tbox = torch.stack([bcast(tx), bcast(ty), gwh[None, None, ..., 0].expand(shape5),
                        gwh[None, None, ..., 1].expand(shape5)], -1)
    anchor_wh = anchors[None, :, None, None, :].expand(shape5 + (2,))
    N = 5 * A * B * T
    return LevelMatches(
        b=b_idx.reshape(N), a=a_idx.reshape(N),
        gj=bcast(gj).reshape(N).long(), gi=bcast(gi).reshape(N).long(),
        tbox=tbox.reshape(N, 4), anchor_wh=anchor_wh.reshape(N, 2),
        obj_idx=(b_idx * T + t_idx).reshape(N), valid=cand_valid.reshape(N))


def match_targets(boxes_n: Tensor, valid: Tensor, anchors_per_level: Sequence[Tensor],
                  level_shapes: Sequence[Tuple[int, int]], anchor_t: float) -> List[LevelMatches]:
    """Assignment for every pyramid level (see ``match_level``)."""
    return [match_level(boxes_n, valid, anchors, ny, nx, anchor_t)
            for anchors, (ny, nx) in zip(anchors_per_level, level_shapes)]
