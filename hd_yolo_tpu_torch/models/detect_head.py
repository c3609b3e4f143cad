"""Detect header (port of ``hd_yolo_tpu/models/detect_head.py``).

Inference: per-level 1x1 det convs, sigmoid decode, per-image NMS,
hierarchical label scores, and both mask branches: per image (no
``mask_budget``, the default) and occupancy-packed.

Training (``Detect.losses``): the anchor/cell matcher, ``det_loss``, and the
mask loss on the best-IoU proposal of each object (top ``mask_rois`` an
image by IoU), pooled through the differentiable bounded ROI-align and the
plain mask-head chain (``MaskHead.forward``), as the JAX package trains its
flax mask head.  In training mode it returns losses only; in eval mode with
targets (validation) losses and inference outputs.

Reference key layout: ``m.l`` (det convs), ``seg.k`` (the mask-branch 3x3
ConvBnAct of level ``nl-1-k``: the reference builds its list top-down),
``seg_h.maskrcnn_heads.mask_fcn{1..4}``, ``seg_h.maskrcnn_preds.conv5_mask``
(the deconv) and ``seg_h.maskrcnn_preds.mask_fcn_logits``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import paired_box_iou, xywh2xyxy, xyxy2xywh
from ..ops.nms import nms_per_image
from ..ops.pallas_mask_head import fused_mask_probs
from ..ops.roi_align import multiscale_roi_align_canvas, multiscale_roi_align_packed
from ..ops.scatter import segment_max_with_argmax
from ..parallel.distributed import all_gather_rows, step_group
from .builder import HeaderSpec
from .layers import ConvBnAct, cached, conv
from .losses import det_loss, get_loss_hyp, seg_loss
from .matcher import match_targets

Tensor = torch.Tensor

DEFAULT_NMS_PARAMS = {"conf_thres": 0.15, "iou_thres": 0.45, "max_det": 300}


def one_hot_labels(labels: Tensor, nc: int) -> Tensor:
    """Int labels (1..nc; 0 / −100 = unlabeled) → (..., nc+1) f32 one-hot,
    column 0 = unlabeled."""
    return F.one_hot(labels.long().clamp(0, nc), nc + 1).float()



def _globally_ranked(flat_score: Tensor, budget: int) -> Tensor:
    """This rank's flat slots among the top ``budget`` positive scores of
    the process group's global batch: every rank's scores gathered in rank
    order, ranked as ``lax.top_k`` ranks the global batch's (descending,
    ties to the lower global index); the rest of the branch then ranks the
    rank's own selected slots, whose order is the global one."""
    group = step_group()
    rank, n = torch.distributed.get_rank(group), flat_score.shape[0]
    flat = all_gather_rows(flat_score.contiguous(), group)
    top_s, top_i = torch.sort(flat, descending=True, stable=True)
    K = min(budget, flat.shape[0])
    chosen = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    chosen[top_i[:K]] = top_s[:K] > 0.0
    return chosen[rank * n:(rank + 1) * n]

class _MaskHeads(nn.Module):
    def __init__(self, c: int, c_in: int):
        super().__init__()
        for j in range(1, 5):
            setattr(self, f"mask_fcn{j}", nn.Conv2d(c_in if j == 1 else c, c, 3, 1, 1))


class _MaskPredictor(nn.Module):
    def __init__(self, c: int, nc_masks: int):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(c, c, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(c, nc_masks, 1)


class MaskHead(nn.Module):
    """MaskRCNNHeads(256×4) + MaskRCNNPredictor: 4 × (3x3 conv + ReLU),
    2x2/s2 deconv + ReLU, 1x1 logits.  ``forward`` is the plain PyTorch
    chain on NHWC input, returning NHWC logits; the inference path runs the
    fused kernel through ``ops/pallas_mask_head.fused_mask_probs``.  The
    first conv takes ``in_channels`` (default ``dim_reduced``)."""

    def __init__(self, nc_masks: int, dim_reduced: int = 256, in_channels: Optional[int] = None):
        super().__init__()
        self.maskrcnn_heads = _MaskHeads(dim_reduced, in_channels or dim_reduced)
        self.maskrcnn_preds = _MaskPredictor(dim_reduced, nc_masks)

    @property
    def fcn(self) -> List[nn.Conv2d]:
        return [getattr(self.maskrcnn_heads, f"mask_fcn{j}") for j in range(1, 5)]

    def forward(self, x: Tensor) -> Tensor:
        """(N, M, M, C) → (N, 2M, 2M, nc_masks) logits, weights cast to ``x``'s dtype."""
        y = x.permute(0, 3, 1, 2)
        cast = lambda t: t.to(y.dtype)
        for c in self.fcn:
            y = F.relu(F.conv2d(y, cast(c.weight), cast(c.bias), padding=1))
        d, lg = self.maskrcnn_preds.conv5_mask, self.maskrcnn_preds.mask_fcn_logits
        y = F.relu(F.conv_transpose2d(y, cast(d.weight), cast(d.bias), stride=2))
        return F.conv2d(y, cast(lg.weight), cast(lg.bias)).permute(0, 2, 3, 1)


class Detect(nn.Module):
    def __init__(self, spec: HeaderSpec, pre_nms_topk: int = 1024, max_masks: int = 100,
                 dim_reduced: int = 256, mask_output_size: int = 28,
                 mask_window: Optional[int] = None, mask_budget: Optional[int] = None,
                 mask_rois: int = 64):
        super().__init__()
        self.spec = spec
        self.pre_nms_topk = pre_nms_topk
        self.max_masks = max_masks
        self.mask_rois = mask_rois
        self.dim_reduced = dim_reduced
        self.mask_output_size = mask_output_size
        self.mask_window = mask_window
        self.mask_budget = mask_budget
        self.m = nn.ModuleList(nn.Conv2d(c, self.na * self.no, 1) for c in spec.in_channels)
        if self.nc_masks > 0:
            self.seg = nn.ModuleList(
                ConvBnAct(c, dim_reduced, 3) for c in reversed(spec.in_channels))
            self.seg_h = MaskHead(self.nc_masks, dim_reduced)
        self.init_det_bias()

    # ------------------------------------------------------------ properties
    @property
    def nl(self) -> int:
        return len(self.spec.in_channels)

    @property
    def na(self) -> int:
        return len(self.spec.anchors[0]) // 2

    @property
    def nc(self) -> int:
        return self.spec.nc

    @property
    def no(self) -> int:
        return self.nc + 5

    @property
    def mask_indices_list(self) -> Tuple[int, ...]:
        m = dict(self.spec.masks)
        return tuple(m.get(i, 0) for i in range(self.nc + 1))

    @property
    def nc_masks(self) -> int:
        return (max(self.mask_indices_list) + 1) if self.mask_indices_list else 0

    @property
    def nms_params(self) -> Dict[str, float]:
        p = dict(DEFAULT_NMS_PARAMS)
        p.update(dict(self.spec.nms_params))
        return p

    @property
    def loss_hyp(self) -> dict:
        return get_loss_hyp(dict(self.spec.loss_hyp))

    def anchors_cells(self, device) -> List[Tensor]:
        """Per-level (A, 2) anchors in feature-cell units."""
        return [torch.tensor(row, dtype=torch.float32, device=device).reshape(-1, 2) / s
                for row, s in zip(self.spec.anchors, self.spec.strides)]

    def seg_conv(self, level: int) -> ConvBnAct:
        return self.seg[self.nl - 1 - level]

    @torch.no_grad()
    def init_det_bias(self) -> None:
        """Focal-style prior bias of the det convs."""
        input_size = float(self.spec.default_input_size or 640)
        for conv, s in zip(self.m, self.spec.strides):
            b = torch.zeros(self.na, self.no)
            b[:, 4] += math.log(8.0 / (input_size / s) ** 2)
            b[:, 5:] += math.log(0.6 / (self.nc - 0.999999))
            conv.bias.copy_(b.reshape(-1))

    # --------------------------------------------------------------- forward
    def _heads(self, features: Sequence[Tensor], compute_masks: bool):
        """Per level the det logits (B, ny, nx, A, no) and, with masks, the
        NHWC mask-branch features.  Training reads the det convs' weights
        directly (differentiable), inference their cached casts."""
        dets = []
        for m, f in zip(self.m, features):
            if self.training:
                w, b = m.weight.to(f.dtype), m.bias.to(f.dtype)
            else:
                w, b = cached(m, f"w_{f.dtype}", (m.weight, m.bias),
                              lambda: (m.weight.to(f.dtype), m.bias.to(f.dtype)))
            d = conv(f, w, b)
            B, _, ny, nx = d.shape
            dets.append(d.permute(0, 2, 3, 1).reshape(B, ny, nx, self.na, self.no))
        seg_feats = []
        if compute_masks:
            seg_feats = [self.seg_conv(i)(f).permute(0, 2, 3, 1)
                         for i, f in enumerate(features)]
        return dets, seg_feats

    def forward(self, features: Sequence[Tensor], compute_masks: bool = True) -> Dict[str, Tensor]:
        """features: per level NCHW (channels-last) → inference outputs."""
        compute_masks = compute_masks and self.nc_masks > 0
        dets, seg_feats = self._heads(features, compute_masks)
        return self._compute_outputs(dets, seg_feats, compute_masks)

    def losses(self, features: Sequence[Tensor], targets: Dict[str, Tensor],
               compute_masks: bool = True):
        """(losses, outputs): in training mode the losses and no outputs, in
        eval mode (validation) the losses and the inference outputs.
        ``targets``: boxes (B, T, 4) normalized xyxy, labels (B, T) ints or
        (B, T, nc+1) one-hot, masks (B, T, 28, 28), valid (B, T) and
        optionally active (B,)."""
        compute_masks = compute_masks and self.nc_masks > 0
        dets, seg_feats = self._heads(features, compute_masks)
        losses = self._compute_losses(dets, seg_feats, targets, compute_masks)
        outputs = {} if self.training else self._compute_outputs(dets, seg_feats, compute_masks)
        return losses, outputs

    # -------------------------------------------------------------- training
    def _compute_losses(self, dets, seg_feats, targets: Dict[str, Tensor],
                        compute_masks: bool) -> Dict[str, object]:
        hyp = self.loss_hyp
        tvalid = targets["valid"].bool()
        active = targets["active"].bool() if "active" in targets else tvalid.any(-1)
        labels = targets["labels"]
        labels_oh = one_hot_labels(labels, self.nc) if labels.dim() == 2 else labels.float()
        boxes_n = xyxy2xywh(targets["boxes"].float().clamp(0.0, 1.0))
        level_shapes = [(d.shape[1], d.shape[2]) for d in dets]
        matches = match_targets(boxes_n, tvalid, self.anchors_cells(tvalid.device), level_shapes,
                                hyp["anchor_t"])
        dloss, items, _ = det_loss(dets, matches, labels_oh, active, hyp, self.nc)
        if compute_masks:
            mloss = self._mask_loss(dets, seg_feats, matches, targets, labels_oh, active)
        else:
            mloss = torch.zeros_like(dloss)
        items = dict(items)
        items["mask"] = mloss.detach()
        return {"det_loss": dloss, "mask_loss": mloss, "loss_items": items}

    def _mask_loss(self, dets, seg_feats, matches, targets, labels_oh, active) -> Tensor:
        """Best-IoU-proposal-per-object mask loss: each object's winner is its
        matched candidate whose decoded box has the highest pixel IoU with
        the object's box (>= ``mask_iou_t``); each image pools its top
        ``mask_rois`` winners by IoU on the winner's level."""
        hyp = self.loss_hyp
        tvalid = targets["valid"].bool()
        B, T = tvalid.shape
        dev = tvalid.device
        s0 = self.spec.strides[0]
        input_w, input_h = dets[0].shape[2] * s0, dets[0].shape[1] * s0
        gt_boxes_px = targets["boxes"].float() * torch.tensor(
            [input_w, input_h, input_w, input_h], dtype=torch.float32, device=dev)

        all_iou, all_obj, all_lvl, all_valid = [], [], [], []
        for i, (pi, m) in enumerate(zip(dets, matches)):
            s = self.spec.strides[i]
            pr = pi[m.b, m.gj, m.gi, m.a].float()
            pxy = (torch.sigmoid(pr[:, 0:2]) * 2.0 - 0.5
                   + torch.stack([m.gi.float(), m.gj.float()], -1)) * s
            pwh = (torch.sigmoid(pr[:, 2:4]) * 2.0) ** 2 * m.anchor_wh * s
            pbox = xywh2xyxy(torch.cat([pxy, pwh], -1))
            iou = paired_box_iou(pbox, gt_boxes_px.reshape(B * T, 4)[m.obj_idx])
            mvalid = m.valid & active[m.b]
            all_iou.append(torch.where(mvalid, iou, torch.full_like(iou, -1.0)))
            all_obj.append(m.obj_idx)
            all_lvl.append(torch.full_like(m.obj_idx, i))
            all_valid.append(mvalid)
        iou_cat = torch.cat(all_iou).detach()
        obj_cat, lvl_cat, valid_cat = torch.cat(all_obj), torch.cat(all_lvl), torch.cat(all_valid)
        obj_for_seg = torch.where(valid_cat, obj_cat, torch.full_like(obj_cat, B * T))

        mask_iou_t = float(hyp.get("mask_iou_t", 0.8))
        best_iou, best_arg = segment_max_with_argmax(iou_cat, obj_for_seg, B * T)
        n_cand = iou_cat.shape[0]
        has_winner = (best_arg < n_cand) & (best_iou >= mask_iou_t)
        win_level = torch.where(has_winner, lvl_cat[best_arg.clamp(0, n_cand - 1)],
                                torch.zeros_like(best_arg)).reshape(B, T)
        win_ok = has_winner.reshape(B, T) & tvalid

        # top-R winners of each image by IoU; lax.top_k's order: descending,
        # ties to the lower index (a stable sort)
        R = min(self.mask_rois, T)
        rank_score = torch.where(win_ok, best_iou.reshape(B, T),
                                 torch.full_like(best_iou.reshape(B, T), -math.inf))
        top_iou, top_t = torch.sort(rank_score, dim=1, descending=True, stable=True)
        top_iou, top_t = top_iou[:, :R], top_t[:, :R]
        roi_valid = torch.isfinite(top_iou) & (top_iou >= mask_iou_t)

        roi_boxes = torch.take_along_dim(gt_boxes_px, top_t[..., None], 1)          # (B, R, 4)
        roi_levels = torch.take_along_dim(win_level, top_t, 1)
        roi_masks = torch.take_along_dim(targets["masks"].float(), top_t[..., None, None], 1)
        roi_labels_oh = torch.take_along_dim(labels_oh, top_t[..., None], 1)

        M = self.mask_output_size // 2
        if self.mask_window is None:
            pooled = multiscale_roi_align_canvas(seg_feats, roi_boxes, roi_levels,
                                                 self.spec.strides, M).reshape(B * R, M, M, -1)
        else:
            b_idx = torch.arange(B, device=dev).repeat_interleave(R)
            pooled = multiscale_roi_align_packed(
                seg_feats, roi_boxes.reshape(B * R, 4), roi_levels.reshape(B * R), b_idx,
                self.spec.strides, M, window=int(self.mask_window))
        logits = self.seg_h(pooled)

        # the lowest-level label picks the mask channel
        hier_label = (roi_labels_oh * torch.arange(self.nc + 1, dtype=roi_labels_oh.dtype,
                                                   device=dev)).argmax(-1)
        mask_idx = torch.tensor(self.mask_indices_list, device=dev)
        mask_labels = mask_idx[hier_label].reshape(B * R)
        S = self.mask_output_size
        return seg_loss(logits, roi_masks.reshape(B * R, S, S), mask_labels,
                        roi_valid.reshape(B * R), hyp)

    def decode_proposals(self, dets: Sequence[Tensor]) -> Tensor:
        """(B, ny, nx, A, no) logits per level → (B, ΣK, no+1) decoded rows
        [cx, cy, w, h, obj, cls..., level] in input pixels, f32."""
        rows = []
        for i, (det, s) in enumerate(zip(dets, self.spec.strides)):
            B, ny, nx, A, no = det.shape
            y = det.float().sigmoid()
            gy, gx = torch.meshgrid(
                torch.arange(ny, dtype=torch.float32, device=det.device),
                torch.arange(nx, dtype=torch.float32, device=det.device), indexing="ij")
            grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
            anchors = torch.tensor(self.spec.anchors[i], dtype=torch.float32,
                                   device=det.device).reshape(-1, 2) / s
            anchor_px = (anchors * s)[None, None, None]
            xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * s
            wh = (y[..., 2:4] * 2.0) ** 2 * anchor_px
            lvl = torch.full(y.shape[:-1] + (1,), float(i), dtype=torch.float32, device=det.device)
            rows.append(torch.cat([xy, wh, y[..., 4:], lvl], -1).reshape(B, ny * nx * A, no + 1))
        return torch.cat(rows, 1)

    def hierarchy(self) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
        """Label tree rows (parent, children); default root objectness → classes."""
        if self.spec.hierarchy:
            return self.spec.hierarchy
        return ((0, tuple(range(1, self.nc + 1))),)

    def hierarchical_scores(self, scores: Tensor) -> Tensor:
        """Top-down cascade: each node's direct children are scaled by the
        (already-cascaded) node score; rows list parents before children."""
        scores = scores.clone()
        for node, children in self.hierarchy():
            idx = torch.tensor(children, device=scores.device)
            scores[..., idx] = scores[..., idx] * scores[..., node: node + 1]
        return scores

    def _compute_outputs(self, dets, seg_feats, compute_masks: bool) -> Dict[str, Tensor]:
        p = self.nms_params
        preds = self.decode_proposals(dets)
        det = nms_per_image(preds, nc=self.nc, conf_thres=p["conf_thres"],
                            iou_thres=p["iou_thres"], max_det=int(p["max_det"]),
                            pre_nms_topk=self.pre_nms_topk)
        valid = det["valid"]
        scores = self.hierarchical_scores(det["scores"])          # (B, D, 1+nc)
        obj = scores[..., 0]
        cls_scores, cls_labels = scores[..., 1:].max(-1)
        confident = cls_scores > p["conf_thres"]
        final_scores = torch.where(confident, cls_scores, obj)
        labels = torch.where(confident, cls_labels + 1, torch.full_like(cls_labels, -100))
        labels = torch.where(valid, labels, torch.full_like(labels, -100))
        out = {
            "boxes": det["boxes"],
            "scores": final_scores * valid,
            "score_vector": scores,
            "labels": labels,
            "levels": det["extra"][..., 0].to(torch.int32),
            "valid": valid,
        }
        if self.spec.multi_label:
            out["multi_labels"] = scores > p["conf_thres"]
        if compute_masks:
            R = min(self.max_masks, int(p["max_det"]))
            mask_idx = torch.tensor(self.mask_indices_list, device=labels.device)
            mask_labels = mask_idx[labels[:, :R].clamp(0, self.nc)]     # −100 → 0
            args = (seg_feats, valid, det["boxes"][:, :R], out["levels"][:, :R], mask_labels)
            if self.mask_budget:
                out.update(self._packed_masks(*args, final_scores[:, :R],
                                              self.mask_output_size // 2))
            else:
                out.update(self._per_image_masks(*args, self.mask_output_size // 2))
        return out

    def _per_image_masks(self, seg_feats, valid, boxes_r, levels_r, mask_labels, M):
        """Per-image mask branch: each image's top R detections pooled (the
        exact canvas form without ``mask_window``, the gathered-window form
        with it), the mask head on all B·R ROIs, zeroed where the slot is
        invalid or its label has no mask channel."""
        B, R = levels_r.shape
        if self.mask_window is None:
            pooled = multiscale_roi_align_canvas(seg_feats, boxes_r, levels_r, self.spec.strides,
                                                 M).reshape(B * R, M, M, -1)
        else:
            b_idx = torch.arange(B, device=boxes_r.device).repeat_interleave(R)
            pooled = multiscale_roi_align_packed(
                seg_feats, boxes_r.reshape(B * R, 4), levels_r.reshape(B * R), b_idx,
                self.spec.strides, M, window=int(self.mask_window))
        sel = fused_mask_probs(self.seg_h, pooled, mask_labels.reshape(B * R).clamp(min=0))
        S = self.mask_output_size
        mask_valid = valid[:, :R] & (mask_labels >= 0)
        masks = sel.reshape(B, R, S, S) * mask_valid[..., None, None]
        return {"masks": masks, "mask_valid": mask_valid}

    def _packed_masks(self, seg_feats, valid, boxes_r, levels_r, mask_labels, scores_r, M):
        """Occupancy-packed mask branch: gather the top-K mask-eligible
        detections of the whole batch into one flat ROI list, pool + run the
        head once at size K, scatter back to (B, R).  Inside a forward over
        several processes (``parallel.global_batch``, the sharded slide) the
        batch is the global one: the top K are ranked over every rank's
        scores and each rank pools and runs the head on its own share."""
        B, R = levels_r.shape
        eligible = valid[:, :R] & (mask_labels >= 0)
        K = min(int(self.mask_budget), B * R)
        flat_score = torch.where(eligible, scores_r, torch.zeros_like(scores_r)).reshape(B * R)
        if step_group() is not None:
            flat_score = torch.where(_globally_ranked(flat_score, int(self.mask_budget)),
                                     flat_score, torch.zeros_like(flat_score))
        # lax.top_k order: descending, ties to the lower index (stable sort)
        top_s, top_i = torch.sort(flat_score, descending=True, stable=True)
        top_s, top_i = top_s[:K], top_i[:K]
        sel_ok = top_s > 0.0
        b_idx = torch.div(top_i, R, rounding_mode="floor")
        r_idx = top_i % R
        # top_s is sorted descending, so sel_ok is a prefix: the pooling and
        # the head compute only its slots (the count stays on the device) and
        # write 0 to the rest
        active = sel_ok.sum()
        pooled = multiscale_roi_align_packed(
            seg_feats, boxes_r.reshape(B * R, 4)[top_i], levels_r.reshape(B * R)[top_i],
            b_idx, self.spec.strides, M, window=int(self.mask_window or 16), active=active)
        lab_k = mask_labels.reshape(B * R)[top_i].clamp(min=0)
        sel = fused_mask_probs(self.seg_h, pooled, lab_k, active=active)
        S = self.mask_output_size
        masks = torch.zeros((B, R, S, S), dtype=sel.dtype, device=sel.device)
        masks[b_idx, r_idx] = sel
        mask_valid = torch.zeros((B, R), dtype=torch.bool, device=sel.device)
        mask_valid[b_idx, r_idx] = sel_ok
        return {"masks": masks, "mask_valid": mask_valid & eligible}
