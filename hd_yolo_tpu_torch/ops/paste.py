"""Paste per-ROI masks into full-image frames (port of ``hd_yolo_tpu/ops/paste.py``).

A dense inverse warp: each output pixel samples its ROI mask bilinearly at
the pixel's normalised ROI coordinate (torchvision's ``_do_paste_mask``
math: the mask is read as if padded by one zero pixel on each side).
Plain PyTorch, chunked over the masks to bound the (K, H, W) output work.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _lerp_1d(coord: Tensor, size: int):
    in_range = (coord > -1.0) & (coord < size)
    c = coord.clamp(0.0, size - 1)
    low = torch.floor(c).long()
    high = torch.clamp(low + 1, max=size - 1)
    lw = c - low.to(coord.dtype)
    zero = torch.zeros_like(lw)
    return low, high, torch.where(in_range, 1 - lw, zero), torch.where(in_range, lw, zero)


def _paste(masks: Tensor, boxes: Tensor, im_h: int, im_w: int) -> Tensor:
    """(k, M, M) masks + (k, 4) xyxy boxes → (k, im_h, im_w)."""
    k, M = masks.shape[0], masks.shape[-1]
    x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
    w = torch.clamp(x2 - x1, min=1e-6)
    h = torch.clamp(y2 - y1, min=1e-6)
    ys = (torch.arange(im_h, dtype=masks.dtype, device=masks.device) + 0.5 - y1) / h * M - 0.5
    xs = (torch.arange(im_w, dtype=masks.dtype, device=masks.device) + 0.5 - x1) / w * M - 0.5
    yl, yh, wyl, wyh = _lerp_1d(ys, M)
    xl, xh, wxl, wxh = _lerp_1d(xs, M)
    rows_l = torch.gather(masks, 1, yl[:, :, None].expand(k, im_h, M))
    rows_h = torch.gather(masks, 1, yh[:, :, None].expand(k, im_h, M))
    rows = rows_l * wyl[:, :, None] + rows_h * wyh[:, :, None]
    cols_l = torch.gather(rows, 2, xl[:, None, :].expand(k, im_h, im_w))
    cols_h = torch.gather(rows, 2, xh[:, None, :].expand(k, im_h, im_w))
    return cols_l * wxl[:, None, :] + cols_h * wxh[:, None, :]


def paste_masks_in_image(masks: Tensor, boxes: Tensor, im_h: int, im_w: int,
                         chunk: int = 32) -> Tensor:
    """(K, M, M) mask probabilities + (K, 4) xyxy boxes → (K, im_h, im_w)
    pasted probabilities, ``chunk`` masks at a time.  Threshold at 0.5
    downstream for binary masks."""
    if masks.shape[0] <= chunk:
        return _paste(masks, boxes.to(masks.dtype), im_h, im_w)
    return torch.cat([_paste(masks[i: i + chunk], boxes[i: i + chunk].to(masks.dtype), im_h, im_w)
                      for i in range(0, masks.shape[0], chunk)])
