"""Box geometry used by the inference path (port of ``hd_yolo_tpu/ops/boxes.py``).

Coordinates are float, ``xyxy`` = (x1, y1, x2, y2), ``xywh`` = (cx, cy, w, h).
The arithmetic keeps the JAX package's op order, so the NMS conflict test
(``IoU > thr``) sees the same float32 values on both sides.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

Tensor = torch.Tensor


def xywh2xyxy(x: Tensor) -> Tensor:
    """(..., 4) center-format → corner-format."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x: Tensor) -> Tensor:
    """(..., 4) corner-format → center-format."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def clip_boxes(boxes: Tensor, shape: Tuple[float, float]) -> Tensor:
    """Clip xyxy boxes to image (height, width)."""
    h, w = shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0.0, w), y1.clamp(0.0, h), x2.clamp(0.0, w), y2.clamp(0.0, h)], -1)


def scale_coords(
    img1_shape: Union[int, Tuple[int, int]],
    coords: Tensor,
    img0_shape: Union[int, Tuple[int, int]],
    ratio_pad=None,
) -> Tensor:
    """Rescale xyxy coords from ``img1_shape`` (model input) back to ``img0_shape`` (original).

    Letterbox-aware: undo the center pad, then the gain.
    """
    if isinstance(img1_shape, int):
        img1_shape = (img1_shape, img1_shape)
    if isinstance(img0_shape, int):
        img0_shape = (img0_shape, img0_shape)
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2, (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    x1, y1, x2, y2 = coords[..., :4].unbind(-1)
    out = torch.stack(
        [(x1 - pad[0]) / gain, (y1 - pad[1]) / gain, (x2 - pad[0]) / gain, (y2 - pad[1]) / gain], -1
    )
    return clip_boxes(out, img0_shape)


def box_area(box: Tensor) -> Tensor:
    """(..., 4) xyxy → area."""
    return (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])


def box_iou(box1: Tensor, box2: Tensor) -> Tensor:
    """Pairwise IoU matrix: (N, 4) × (M, 4) xyxy → (N, M)."""
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(box1)[..., :, None] + box_area(box2)[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def remove_small_boxes_mask(boxes: Tensor, min_size: float) -> Tensor:
    """Validity mask for boxes with both sides >= min_size."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)


def make_divisible(x: float, divisor: int) -> int:
    """Round channel count up to the nearest multiple."""
    return int(math.ceil(x / divisor) * divisor)
