"""Fixed-shape, padded Non-Maximum Suppression (port of ``hd_yolo_tpu/ops/nms.py``).

Semantics of every function here are the JAX package's, exactly:
  * boxes are ranked by score with a stable descending sort (ties keep the
    lower original index) — or taken as given when ``presorted``;
  * box i suppresses box j when i comes first, both are valid and
    ``box_iou(i, j) > thr`` (strictly greater, float32);
  * the keep mask is the sequential greedy one;
  * the first ``max_det`` survivors are compacted in score order into
    ``(indices, keep)`` of fixed size; unfilled index slots are 0.

Functions take one image (K, ...) or a batch (B, K, ...).  ``nms_padded``
is the plain PyTorch version; ``nms_dispatch`` sends CUDA tensors to the
bitmask kernel (``ops/pallas_nms.py``) and CPU tensors to ``nms_padded``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .boxes import box_iou, remove_small_boxes_mask, xywh2xyxy

Tensor = torch.Tensor


def sort_by_score(scores: Tensor, valid: Tensor) -> Tensor:
    """Stable descending order of scores, invalid slots last (-inf)."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return torch.sort(masked, dim=-1, descending=True, stable=True).indices


def greedy_keep(sboxes: Tensor, svalid: Tensor, iou_threshold: float) -> Tensor:
    """Sequential greedy keep mask over score-sorted boxes (..., K, 4)."""
    K = sboxes.shape[-2]
    iou = box_iou(sboxes, sboxes)
    upper = torch.ones(K, K, dtype=torch.bool, device=sboxes.device).triu(1)
    conflict = (iou > iou_threshold) & upper & svalid[..., :, None] & svalid[..., None, :]
    keep = torch.zeros_like(svalid)
    removed = ~svalid
    for i in range(K):
        k = ~removed[..., i]
        keep[..., i] = k
        removed = removed | (conflict[..., i, :] & k[..., None])
    return keep


def compact(kept_sorted: Tensor, order: Optional[Tensor], max_det: int) -> Tuple[Tensor, Tensor]:
    """First ``max_det`` kept positions, in order → (indices, keep)."""
    lead = kept_sorted.shape[:-1]
    K = kept_sorted.shape[-1]
    pos = torch.cumsum(kept_sorted.to(torch.int64), -1) - 1
    pos = torch.where(kept_sorted & (pos < max_det), pos, torch.full_like(pos, max_det))
    src = torch.arange(K, device=kept_sorted.device).expand_as(pos) if order is None else order
    out = torch.zeros(lead + (max_det + 1,), dtype=torch.int64, device=kept_sorted.device)
    out.scatter_(-1, pos, src.to(torch.int64))
    n_kept = kept_sorted.sum(-1, keepdim=True).clamp(max=max_det)
    keep = torch.arange(max_det, device=kept_sorted.device) < n_kept
    return out[..., :max_det].to(torch.int32), keep


def nms_padded(boxes: Tensor, scores: Tensor, valid: Tensor, iou_threshold: float,
               max_det: int, presorted: bool = False) -> Tuple[Tensor, Tensor]:
    """Greedy NMS over a padded box set — the plain version.

    boxes (..., K, 4) xyxy; scores (..., K); valid (..., K) bool.  Returns
    ``(indices, keep)``, each (..., max_det): indices into the original box
    order (0 in unfilled slots) and their validity.
    """
    if presorted:
        order, sboxes, svalid = None, boxes, valid
    else:
        order = sort_by_score(scores, valid)
        sboxes = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
        svalid = torch.gather(valid, -1, order)
    return compact(greedy_keep(sboxes, svalid, iou_threshold), order, max_det)


def nms_dispatch(boxes: Tensor, scores: Tensor, valid: Tensor, iou_threshold: float,
                 max_det: int, presorted: bool = False) -> Tuple[Tensor, Tensor]:
    """``nms_padded`` semantics: the bitmask kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if boxes.device.type == "cpu":
        return nms_padded(boxes, scores, valid, iou_threshold, max_det, presorted=presorted)
    from .pallas_nms import nms_padded_pallas

    return nms_padded_pallas(boxes, scores, valid, iou_threshold, max_det, presorted=presorted)


def class_offset_boxes(boxes: Tensor, labels: Tensor, valid: Tensor) -> Tensor:
    """Boxes (K, 4) or (B, K, 4) shifted by label x span, so boxes of
    different classes never overlap.  The span is each image's own largest
    valid coordinate + 1, as the JAX package computes it per image under
    ``vmap``."""
    span = torch.where(valid[..., None], boxes, torch.zeros_like(boxes)).amax(
        dim=(-2, -1), keepdim=True) + 1.0
    return boxes + labels.to(boxes.dtype)[..., None] * span


def batched_nms_padded(boxes: Tensor, scores: Tensor, labels: Tensor, valid: Tensor,
                       iou_threshold: float, max_det: int) -> Tuple[Tensor, Tensor]:
    """Class-aware NMS via the coordinate-offset trick, for one image (K, 4)
    or a batch (B, K, 4)."""
    return nms_dispatch(class_offset_boxes(boxes, labels, valid), scores, valid, iou_threshold,
                        max_det)


def nms_per_image(preds: Tensor, nc: int, conf_thres: float = 0.15, iou_thres: float = 0.45,
                  max_det: int = 300, pre_nms_topk: Optional[int] = None,
                  min_box_size: float = 2.0) -> Dict[str, Tensor]:
    """Objectness-driven NMS over concatenated multi-level proposals.

    preds: (K, 5+nc+E) or (B, K, 5+nc+E) rows [cx, cy, w, h, obj, cls..., extra...].
    Ranks and suppresses by objectness (column 4), keeps the full (1+nc)
    score vector and the extra columns (level id).  Returns fixed-shape
    boxes (..., max_det, 4) xyxy, scores (..., max_det, 1+nc), extra
    (..., max_det, E) and valid (..., max_det).
    """
    boxes = xywh2xyxy(preds[..., :4])
    scores = preds[..., 4: 5 + nc]
    extra = preds[..., 5 + nc:]
    obj = scores[..., 0]
    ok = remove_small_boxes_mask(boxes, min_box_size) & (obj > conf_thres)

    K = preds.shape[-2]
    presorted = pre_nms_topk is not None and pre_nms_topk < K
    if presorted:
        # lax.top_k order: descending, ties to the lower index
        masked = torch.where(ok, obj, torch.full_like(obj, float("-inf")))
        obj, sel = torch.sort(masked, dim=-1, descending=True, stable=True)
        obj, sel = obj[..., :pre_nms_topk], sel[..., :pre_nms_topk]
        boxes = torch.gather(boxes, -2, sel[..., None].expand(sel.shape + (4,)))
        scores = torch.gather(scores, -2, sel[..., None].expand(sel.shape + scores.shape[-1:]))
        extra = torch.gather(extra, -2, sel[..., None].expand(sel.shape + extra.shape[-1:]))
        ok = torch.gather(ok, -1, sel)

    idx, keep = nms_dispatch(boxes, obj, ok, iou_thres, max_det, presorted=presorted)
    idx = idx.to(torch.int64)
    kf = keep[..., None].to(boxes.dtype)

    def take(t):
        return torch.gather(t, -2, idx[..., None].expand(idx.shape + t.shape[-1:])) * kf

    return {"boxes": take(boxes), "scores": take(scores), "extra": take(extra), "valid": keep}
