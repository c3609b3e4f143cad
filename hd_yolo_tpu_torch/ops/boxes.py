"""Box geometry of the inference and training paths (port of ``hd_yolo_tpu/ops/boxes.py``).

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


def xywhn2xyxy(x: Tensor, w: float = 640.0, h: float = 640.0, padw: float = 0.0,
               padh: float = 0.0) -> Tensor:
    """Normalized center-format → pixel corner-format."""
    cx, cy, bw, bh = x.unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh], -1)


def xyxy2xywhn(x: Tensor, w: float = 640.0, h: float = 640.0, clip: bool = False,
               eps: float = 0.0) -> Tensor:
    """Pixel corner-format → normalized center-format."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h], -1)


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


def paired_box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Row-wise IoU: (N, 4) × (N, 4) xyxy → (N,)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:4], boxes2[..., 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-12)


def wh_iou(wh1: Tensor, wh2: Tensor) -> Tensor:
    """(N, 2) × (M, 2) → (N, M) IoU of width-height pairs anchored at the origin."""
    inter = torch.minimum(wh1[:, None], wh2[None]).prod(2)
    return inter / (wh1.prod(1)[:, None] + wh2.prod(1)[None] - inter)


def bbox_iou(box1: Tensor, box2: Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, eps: float = 1e-7) -> Tensor:
    """Elementwise (broadcasting) IoU / GIoU / DIoU / CIoU of ``box1`` vs
    ``box2``, last dim 4 → (..., 1).  CIoU's ``alpha`` carries no gradient."""
    if xywh:
        x1, y1, w1, h1 = box1.split(1, -1)
        x2, y2, w2, h2 = box2.split(1, -1)
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1 / 2, x1 + w1 / 2, y1 - h1 / 2, y1 + h1 / 2
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2 / 2, x2 + w2 / 2, y2 - h2 / 2, y2 + h2 / 2
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.split(1, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.split(1, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0.0) * \
        (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0.0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if CIoU or DIoU:
            c2 = cw ** 2 + ch ** 2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
                alpha = (v / (v - iou + (1 + eps))).detach()
                return iou - (rho2 / c2 + v * alpha)
            return iou - rho2 / c2
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


def remove_small_boxes_mask(boxes: Tensor, min_size: float) -> Tensor:
    """Validity mask for boxes with both sides >= min_size."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)


def make_divisible(x: float, divisor: int) -> int:
    """Round channel count up to the nearest multiple."""
    return int(math.ceil(x / divisor) * divisor)
