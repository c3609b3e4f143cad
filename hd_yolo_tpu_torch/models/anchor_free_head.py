"""Anchor-free decoupled detection header with SimOTA assignment (port of
``hd_yolo_tpu/models/anchor_free_head.py``).

Per level a 1x1 stem, then a 3x3 class branch and a 3x3 box branch; the
class branch predicts ``nc`` logits, the box branch 4 box offsets and the
objectness.  Decode: ``xy = reg·stride + cell center``, ``wh =
exp(clip(reg, -10, 8))·stride``.  Inference rows ``[x, y, w, h, obj,
cls..., level]`` go through the shared ``nms_per_image``.

``simota_assign`` is the dynamic-k SimOTA of the JAX package, vectorised
over any leading batch dimensions as ``jax.vmap`` maps it over images:
center-prior candidates, a class + IoU cost, per target the ``dyn_k``
lowest-cost candidates of a static top-``topk`` slice, and a cell claimed
by several targets keeps its cheapest one.  ``jax.lax.top_k`` returns tied
entries lowest index first; a stable descending sort does the same here.

Key layout: ``stems.i`` / ``cls_convs.i`` / ``reg_convs.i`` (each
``conv`` + ``bn``) and ``cls_preds.i`` / ``reg_preds.i`` / ``obj_preds.i``
(1x1 convs with bias); ``utils/convert.py`` maps them from flax's
``stem{i}``, ``cls_conv{i}``, ... of ``header_<tag>``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ..ops.boxes import bbox_iou, box_iou, xywh2xyxy, xyxy2xywh
from ..ops.nms import nms_per_image
from ..parallel.distributed import batch_count
from .builder import HeaderSpec
from .detect_head import DEFAULT_NMS_PARAMS
from .layers import ConvBnAct, cached, conv
from .losses import bce_with_logits, masked_mean

Tensor = torch.Tensor


def make_cell_centers(level_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
                      device=None) -> Tuple[Tensor, Tensor]:
    """All cells across levels → centers (N, 2) in pixels and each cell's stride (N,)."""
    centers, strs = [], []
    for (ny, nx), s in zip(level_shapes, strides):
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                                torch.arange(nx, dtype=torch.float32, device=device),
                                indexing="ij")
        centers.append(torch.stack([(gx + 0.5) * s, (gy + 0.5) * s], -1).reshape(-1, 2))
        strs.append(torch.full((ny * nx,), float(s), dtype=torch.float32, device=device))
    return torch.cat(centers), torch.cat(strs)


def simota_assign(pred_boxes: Tensor, cls_logits: Tensor, obj_logits: Tensor, centers: Tensor,
                  strides: Tensor, gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                  center_radius: float = 2.5, topk: int = 10) -> Tuple[Tensor, Tensor, Tensor]:
    """Dynamic-k SimOTA.  pred_boxes (..., N, 4) xyxy px (detached), cls_logits
    (..., N, nc), obj_logits (..., N), centers (N, 2), strides (N,), gt_boxes
    (..., T, 4) xyxy px, gt_labels (..., T) 1..nc, gt_valid (..., T) bool.

    Returns (matched_gt (..., N) int64, fg (..., N) bool, assigned IoU (..., N))."""
    N, T = pred_boxes.shape[-2], gt_boxes.shape[-2]
    cx, cy = centers[:, 0, None], centers[:, 1, None]                     # (N, 1)
    gb = gt_boxes[..., None, :, :]                                          # (..., 1, T, 4)
    in_box = (cx > gb[..., 0]) & (cx < gb[..., 2]) & (cy > gb[..., 1]) & (cy < gb[..., 3])
    gt_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2
    gt_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
    r = center_radius * strides[:, None]
    in_center = ((cx - gt_cx[..., None, :]).abs() < r) & ((cy - gt_cy[..., None, :]).abs() < r)
    candidate = (in_box | in_center) & gt_valid[..., None, :]              # (..., N, T)

    ious = box_iou(pred_boxes, gt_boxes)                                    # (..., N, T)
    nc = cls_logits.shape[-1]
    cls_prob = torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[..., None]
    p = cls_prob.clamp(1e-8, 1 - 1e-8)
    log_p, log_1mp = torch.log(p), torch.log(1 - p)
    onehot = torch.nn.functional.one_hot((gt_labels.long() - 1).clamp(min=0), nc).float()
    # the binary cross-entropy of each (cell, target) pair, summed over the
    # classes in order, one (..., N, T) term at a time
    cls_cost = None
    for c in range(nc):
        oh = onehot[..., None, :, c]
        term = oh * log_p[..., :, None, c] + (1 - oh) * log_1mp[..., :, None, c]
        cls_cost = term if cls_cost is None else cls_cost + term
    cost = -cls_cost + 3.0 * (-torch.log(ious + 1e-8)) + 1e5 * (~candidate)

    # dynamic k per target: clamp(sum of its top-k candidate IoUs, 1, topk),
    # summed in descending order
    k = min(topk, N)
    iou_cand = torch.where(candidate, ious, torch.zeros_like(ious)).transpose(-1, -2)
    top_ious = torch.topk(iou_cand, k, dim=-1, sorted=True).values        # (..., T, k)
    total = top_ious[..., 0]
    for j in range(1, k):
        total = total + top_ious[..., j]
    dyn_k = total.to(torch.int32).clamp(1, topk)

    # per target the k lowest-cost cells (ties to the lower index), keep rank < dyn_k
    cand_idx = torch.sort(-cost.transpose(-1, -2), dim=-1, descending=True,
                          stable=True).indices[..., :k]                     # (..., T, k)
    rank = torch.arange(k, device=cost.device)
    keep = (rank < dyn_k[..., None]) & gt_valid[..., None]
    assign = torch.zeros(cost.shape[:-2] + (T, N), dtype=torch.bool, device=cost.device)
    assign = assign.scatter(-1, cand_idx, keep).transpose(-1, -2) & candidate   # (..., N, T)

    # a cell claimed by several targets keeps the cheapest; argmin of an
    # all-inf row is 0
    fg = assign.any(-1)
    best_gt = torch.argmin(torch.where(assign, cost, torch.full_like(cost, float("inf"))), -1)
    matched = torch.gather(ious, -1, best_gt[..., None])[..., 0]
    return best_gt, fg, torch.where(fg, matched, torch.zeros_like(matched))


class AnchorFreeDetect(nn.Module):
    """Decoupled anchor-free header: per level stem → (class branch, box branch).

    ``forward(features)`` → inference outputs (boxes, scores, labels,
    levels, valid; no masks); ``losses(features, targets)`` → (losses,
    outputs) as ``Detect.losses``: objectness, class and CIoU box losses at
    weights 1 / 1 / 5 times the number of active images, ``mask_loss`` 0."""

    def __init__(self, spec: HeaderSpec, pre_nms_topk: int = 1024, width: int = 128):
        super().__init__()
        self.spec = spec
        self.pre_nms_topk = pre_nms_topk
        w, nl = width, len(spec.strides)
        self.stems = nn.ModuleList(ConvBnAct(c, w, 1) for c in spec.in_channels)
        self.cls_convs = nn.ModuleList(ConvBnAct(w, w, 3) for _ in range(nl))
        self.reg_convs = nn.ModuleList(ConvBnAct(w, w, 3) for _ in range(nl))
        self.cls_preds = nn.ModuleList(nn.Conv2d(w, spec.nc, 1) for _ in range(nl))
        self.reg_preds = nn.ModuleList(nn.Conv2d(w, 4, 1) for _ in range(nl))
        self.obj_preds = nn.ModuleList(nn.Conv2d(w, 1, 1) for _ in range(nl))

    @property
    def nc(self) -> int:
        return self.spec.nc

    @property
    def nl(self) -> int:
        return len(self.spec.strides)

    @property
    def nms_params(self) -> Dict[str, float]:
        return {**DEFAULT_NMS_PARAMS, **dict(self.spec.nms_params)}

    def _pred(self, m: nn.Conv2d, x: Tensor) -> Tensor:
        """A 1x1 prediction conv in ``x``'s dtype → NHWC f32 (B, ny·nx, C)."""
        if self.training:
            w, b = m.weight.to(x.dtype), m.bias.to(x.dtype)
        else:
            w, b = cached(m, f"w_{x.dtype}", (m.weight, m.bias),
                          lambda: (m.weight.to(x.dtype), m.bias.to(x.dtype)))
        y = conv(x, w, b)
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1]).float()

    def _branches(self, features: Sequence[Tensor]):
        cls_l, reg_l, obj_l, shapes = [], [], [], []
        for i, f in enumerate(features):
            t = self.stems[i](f)
            c, r = self.cls_convs[i](t), self.reg_convs[i](t)
            cls_l.append(self._pred(self.cls_preds[i], c))
            reg_l.append(self._pred(self.reg_preds[i], r))
            obj_l.append(self._pred(self.obj_preds[i], r)[..., 0])
            shapes.append((f.shape[2], f.shape[3]))
        return torch.cat(cls_l, 1), torch.cat(reg_l, 1), torch.cat(obj_l, 1), shapes

    @staticmethod
    def decode(reg: Tensor, centers: Tensor, strides: Tensor) -> Tensor:
        """(..., N, 4) raw box offsets → xywh px."""
        xy = reg[..., :2] * strides[..., None] + centers
        wh = torch.exp(reg[..., 2:4].clamp(-10.0, 8.0)) * strides[..., None]
        return torch.cat([xy, wh], -1)

    def forward(self, features: Sequence[Tensor], compute_masks: bool = False) -> Dict[str, Tensor]:
        cls_l, reg_l, obj_l, shapes = self._branches(features)
        return self._outputs(cls_l, reg_l, obj_l, shapes)

    def losses(self, features: Sequence[Tensor], targets: Dict[str, Tensor],
               compute_masks: bool = False):
        cls_l, reg_l, obj_l, shapes = self._branches(features)
        losses = self._loss(cls_l, reg_l, obj_l, shapes, targets)
        outputs = {} if self.training else self._outputs(cls_l, reg_l, obj_l, shapes)
        return losses, outputs

    def _outputs(self, cls_l, reg_l, obj_l, shapes) -> Dict[str, Tensor]:
        dev = cls_l.device
        centers, strides = make_cell_centers(shapes, self.spec.strides, dev)
        boxes_xywh = self.decode(reg_l, centers[None], strides[None])
        lvl = torch.cat([torch.full((ny * nx, 1), float(i), device=dev)
                         for i, (ny, nx) in enumerate(shapes)])
        rows = torch.cat([boxes_xywh, torch.sigmoid(obj_l)[..., None], torch.sigmoid(cls_l),
                          lvl[None].expand(obj_l.shape + (1,))], -1)
        p = self.nms_params
        det = nms_per_image(rows, nc=self.nc, conf_thres=p["conf_thres"],
                            iou_thres=p["iou_thres"], max_det=int(p["max_det"]),
                            pre_nms_topk=self.pre_nms_topk)
        valid = det["valid"]
        cls_scores, labels = det["scores"][..., 1:].max(-1)
        return {
            "boxes": det["boxes"],
            "scores": det["scores"][..., 0] * cls_scores * valid,
            "labels": torch.where(valid, labels + 1, torch.full_like(labels, -100)),
            "levels": det["extra"][..., 0].to(torch.int32),
            "valid": valid,
        }

    def _loss(self, cls_l, reg_l, obj_l, shapes, targets) -> Dict[str, object]:
        dev = cls_l.device
        centers, strides = make_cell_centers(shapes, self.spec.strides, dev)
        img_h = shapes[0][0] * self.spec.strides[0]
        img_w = shapes[0][1] * self.spec.strides[0]
        scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
        gt_boxes = targets["boxes"].float() * scale                            # (B, T, 4)
        gt_valid = targets["valid"].bool()
        gt_labels = targets["labels"].long().clamp(0, self.nc)
        active = targets["active"].bool() if "active" in targets else gt_valid.any(-1)

        boxes_xywh = self.decode(reg_l, centers, strides)                      # (B, N, 4)
        best_gt, fg, m_iou = simota_assign(
            xywh2xyxy(boxes_xywh).detach(), cls_l.detach(), obj_l.detach(), centers, strides,
            gt_boxes, gt_labels, gt_valid)
        fg = fg & active[:, None]
        act_f = active[:, None].expand_as(obj_l)
        # objectness: the assigned IoU as the target quality, over all cells
        tobj = torch.where(fg, m_iou, torch.zeros_like(m_iou))
        l_obj = masked_mean(bce_with_logits(obj_l, tobj), act_f, dim=1)
        # class on the foreground cells
        gl = torch.gather(gt_labels, 1, best_gt)
        onehot = torch.nn.functional.one_hot((gl - 1).clamp(min=0), self.nc).float()
        l_cls = masked_mean(bce_with_logits(cls_l, onehot),
                            fg[..., None].expand_as(cls_l), dim=(1, 2))
        # CIoU on the foreground; a unit box stands in for the other cells so
        # the zero-size padded targets cannot put a NaN into the masked mean
        gt_xywh = torch.gather(xyxy2xywh(gt_boxes), 1, best_gt[..., None].expand(-1, -1, 4))
        unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=gt_xywh.dtype, device=dev)
        gt_xywh = torch.where(fg[..., None], gt_xywh, unit)
        ciou = bbox_iou(boxes_xywh, gt_xywh, xywh=True, CIoU=True)[..., 0]
        l_box = masked_mean(1.0 - ciou, fg, dim=1)

        # means over the (global, across processes) batch
        n_img = batch_count(torch.full((), float(l_obj.shape[0]), device=dev))
        l_obj, l_cls, l_box = (v.sum() / n_img for v in (l_obj, l_cls, l_box))
        bs = batch_count(active.float().sum()).clamp(min=1.0)
        total = (l_obj * 1.0 + l_cls * 1.0 + l_box * 5.0) * bs
        items = {"obj": l_obj.detach(), "cls": l_cls.detach(), "box": l_box.detach()}
        return {"det_loss": total, "mask_loss": torch.zeros((), device=dev),
                "loss_items": items}

