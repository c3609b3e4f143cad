"""Detection and segmentation losses as masked functions (port of
``hd_yolo_tpu/models/losses.py``).

* ``det_loss``: CIoU box loss, IoU-weighted objectness BCE with per-level
  balance, BCE classification on the one-hot label slices (column 0 =
  unlabeled), positive and class weights, optional focal factor, label
  smoothing;
* ``seg_loss``: per-ROI BCE (or soft dice) on the mask channel of each
  ROI's label, skipping empty targets and label −1.

Every matcher candidate keeps its slot and the reductions are
validity-weighted means, so every parameter gets a (possibly zero) gradient.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou
from ..parallel.distributed import batch_count
from .matcher import LevelMatches

Tensor = torch.Tensor

DEFAULT_LOSS_HYP = {
    "box": 0.05, "cls": 0.05, "obj": 1.0,
    "cls_pw": 1.0, "obj_pw": 1.0, "cls_cw": 1.0, "fl_gamma": 0.0,
    "iou_t": 0.20, "anchor_t": 4.0, "label_smoothing": 0.0,
    "mask": 1.0, "mask_type": "bce", "mask_iou_t": 0.8,
}


def get_loss_hyp(hyp: Optional[dict] = None) -> dict:
    out = dict(DEFAULT_LOSS_HYP)
    if hyp:
        out.update({k: v for k, v in dict(hyp).items() if k in out or k == "type"})
        if "type" in out:  # the reference SegLoss names it 'type'
            out["mask_type"] = out.pop("type")
    return out


def smooth_label(x: Tensor, eps: float) -> Tensor:
    return x - (x - 0.5) * eps


def bce_with_logits(logits: Tensor, targets: Tensor, pos_weight: float = 1.0) -> Tensor:
    """Elementwise -[w·t·log σ(x) + (1−t)·log(1−σ(x))], through log-sigmoid."""
    return -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def q_focal_factor(logits: Tensor, targets: Tensor, gamma: float, alpha: float = 0.25) -> Tensor:
    """Quality-focal modulation |t − σ(x)|^γ · α-factor."""
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return alpha_factor * (targets - p).abs() ** gamma


def bce_blur_with_logits(logits: Tensor, targets: Tensor, alpha: float = 0.05) -> Tensor:
    """BCE with confident false positives (σ(x)−t → 1) down-weighted by
    1 − exp((dx − 1)/(α + 1e−4))."""
    loss = bce_with_logits(logits, targets)
    dx = torch.sigmoid(logits) - targets
    return loss * (1.0 - torch.exp((dx - 1.0) / (alpha + 1e-4)))


def autobalance_update(balance, obj_losses, ssi: int = 0, momentum: float = 0.9999) -> Tensor:
    """Per-level objectness auto-balance: balance_i ← m·balance_i +
    (1−m)/obj_i, renormalized by level ``ssi``."""
    b = torch.as_tensor(balance, dtype=torch.float32)
    o = torch.as_tensor(obj_losses, dtype=torch.float32).clamp(min=1e-12)
    b = b * momentum + (1.0 - momentum) / o
    return b / b[ssi]


def focal_factor(logits: Tensor, targets: Tensor, gamma: float, alpha: float = 0.25) -> Tensor:
    """TF-style focal modulation."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_f * (1.0 - p_t) ** gamma


def masked_mean(x: Tensor, mask: Tensor, dim=None) -> Tensor:
    """Mean of ``x`` over ``mask``; the whole-batch form (``dim`` None)
    divides by the global batch's count inside a step over several
    processes (``parallel.global_batch``)."""
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / batch_count(m.sum()).clamp(min=1.0)
    return (x * m).sum(dim) / m.sum(dim).clamp(min=1.0)


def det_loss(dets: Sequence[Tensor], matches: Sequence[LevelMatches], gt_labels_onehot: Tensor,
             active: Tensor, hyp: dict, nc: int) -> Tuple[Tensor, Dict[str, Tensor], List[Tensor]]:
    """YOLOv5 multi-part detection loss, padded and masked.

    dets: per level (B, ny, nx, A, no) raw logits; gt_labels_onehot (B, T,
    nc+1); active (B,) bool, the images that carry this task.  Returns (total
    loss, detached loss items, per-level candidate CIoU for the mask branch)."""
    nl = len(dets)
    balance = {3: [4.0, 1.0, 0.4]}.get(nl, [4.0, 1.0, 0.25, 0.06, 0.02])
    B, T = gt_labels_onehot.shape[:2]
    labels_flat = gt_labels_onehot.reshape(B * T, -1)
    dev = dets[0].device
    f32 = torch.float32
    lbox = torch.zeros((), dtype=f32, device=dev)
    lobj = torch.zeros((), dtype=f32, device=dev)
    lcls = torch.zeros((), dtype=f32, device=dev)
    cand_ious: List[Tensor] = []
    gamma = float(hyp["fl_gamma"])
    cls_cw = torch.as_tensor(hyp["cls_cw"], dtype=f32, device=dev)
    unit_box = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=f32, device=dev)

    for i, (pi, m) in enumerate(zip(dets, matches)):
        pi = pi.float()
        Bp, ny, nx, A, no = pi.shape
        pr = pi[m.b, m.gj, m.gi, m.a]                                  # (N, no)
        mvalid = m.valid & active[m.b]

        pxy = torch.sigmoid(pr[:, 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(pr[:, 2:4]) * 2.0) ** 2 * m.anchor_wh
        pbox = torch.cat([pxy, pwh], -1)
        # padded slots carry zero-wh boxes, whose CIoU arctan(w/h) is NaN:
        # a unit box stands in for them
        tbox = torch.where(mvalid[:, None], m.tbox, unit_box)
        iou = bbox_iou(pbox, tbox, xywh=True, CIoU=True)[:, 0]         # (N,)
        lbox = lbox + masked_mean(1.0 - iou, mvalid)
        cand_ious.append(iou)

        # objectness target: the detached IoU scatter-maxed into the grid,
        # invalid slots into a dump slot past the end
        iou_d = iou.detach().clamp(min=0.0)
        n_cells = Bp * ny * nx * A
        flat_idx = torch.where(mvalid, ((m.b * ny + m.gj) * nx + m.gi) * A + m.a,
                               torch.full_like(m.b, n_cells))
        tobj = torch.zeros(n_cells + 1, dtype=f32, device=dev).scatter_reduce(
            0, flat_idx, iou_d, "amax", include_self=True)[:n_cells].reshape(Bp, ny, nx, A)
        obj_bce = bce_with_logits(pi[..., 4], tobj, pos_weight=float(hyp["obj_pw"]))
        if gamma > 0:
            obj_bce = obj_bce * focal_factor(pi[..., 4], tobj, gamma)
        # images without this task contribute nothing
        obji = masked_mean(obj_bce, active[:, None, None, None].expand(obj_bce.shape))
        lobj = lobj + obji * balance[i]

        if nc > 1:
            tlab = labels_flat[m.obj_idx]                              # (N, nc+1)
            labeled = mvalid & (tlab[:, 1:].sum(-1) > 0)
            target = smooth_label(tlab[:, 1:], float(hyp["label_smoothing"]))
            cls_bce = bce_with_logits(pr[:, 5:], target, pos_weight=float(hyp["cls_pw"]))
            if gamma > 0:
                cls_bce = cls_bce * focal_factor(pr[:, 5:], target, gamma)
            cls_bce = cls_bce * cls_cw
            lcls = lcls + masked_mean(cls_bce, labeled[:, None].expand(cls_bce.shape))

    lbox = lbox * float(hyp["box"])
    lobj = lobj * float(hyp["obj"])
    lcls = lcls * float(hyp["cls"])
    bs = batch_count(active.to(f32).sum())   # the task's (global) batch size, as the reference
    total = (lbox + lobj + lcls) * bs
    items = {"box": lbox.detach(), "obj": lobj.detach(), "cls": lcls.detach()}
    return total, items, cand_ious


def seg_loss(mask_logits: Tensor, mask_targets: Tensor, mask_labels: Tensor,
             roi_valid: Tensor, hyp: dict) -> Tensor:
    """mask_logits (R, Hm, Wm, nc_masks), mask_targets (R, Hm, Wm), mask
    channel per ROI (R,) with −1 = ignore, roi_valid (R,) → the mask loss on
    each ROI's label channel."""
    ch = mask_labels.clamp(0, mask_logits.shape[-1] - 1).long()
    logits = torch.take_along_dim(mask_logits, ch[:, None, None, None], -1)[..., 0].float()
    keep = roi_valid & (mask_labels >= 0) & (mask_targets.sum((1, 2)) > 0)
    tgt = mask_targets.float()
    if hyp.get("mask_type", "bce") == "dice":
        prod = (torch.sigmoid(logits) * tgt).sum((1, 2))
        plus = (torch.sigmoid(logits) + tgt).sum((1, 2))
        per_roi = 1.0 - 2.0 * prod / plus.clamp(min=1e-6)
        loss = masked_mean(per_roi, keep)
    else:
        bce = bce_with_logits(logits, tgt)
        loss = masked_mean(bce, keep[:, None, None].expand(bce.shape))
    return loss * float(hyp["mask"])
