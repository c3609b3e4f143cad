"""Detect header, inference: per-level 1x1 det convs, sigmoid decode, per-image
NMS, hierarchical label scores, and both mask branches: per image (no
``mask_budget``, the default) and occupancy-packed (port of
``hd_yolo_tpu/models/detect_head.py``; training losses are not ported yet).

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

from ..ops.nms import nms_per_image
from ..ops.pallas_mask_head import fused_mask_probs
from ..ops.roi_align import multiscale_roi_align_canvas, multiscale_roi_align_packed
from .builder import HeaderSpec
from .layers import ConvBnAct, cached, conv

Tensor = torch.Tensor

DEFAULT_NMS_PARAMS = {"conf_thres": 0.15, "iou_thres": 0.45, "max_det": 300}


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
        y = x.permute(0, 3, 1, 2)
        for conv in self.fcn:
            y = F.relu(conv(y))
        y = F.relu(self.maskrcnn_preds.conv5_mask(y))
        return self.maskrcnn_preds.mask_fcn_logits(y).permute(0, 2, 3, 1)


class Detect(nn.Module):
    def __init__(self, spec: HeaderSpec, pre_nms_topk: int = 1024, max_masks: int = 100,
                 dim_reduced: int = 256, mask_output_size: int = 28,
                 mask_window: Optional[int] = None, mask_budget: Optional[int] = None):
        super().__init__()
        self.spec = spec
        self.pre_nms_topk = pre_nms_topk
        self.max_masks = max_masks
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
    def forward(self, features: Sequence[Tensor], compute_masks: bool = True) -> Dict[str, Tensor]:
        """features: per level NCHW (channels-last) → inference outputs."""
        compute_masks = compute_masks and self.nc_masks > 0
        dets = []
        for m, f in zip(self.m, features):
            w, b = cached(m, f"w_{f.dtype}", (m.weight, m.bias),
                          lambda: (m.weight.to(f.dtype), m.bias.to(f.dtype)))
            d = conv(f, w, b)
            B, _, ny, nx = d.shape
            dets.append(d.permute(0, 2, 3, 1).reshape(B, ny, nx, self.na, self.no))
        seg_feats = []
        if compute_masks:
            seg_feats = [self.seg_conv(i)(f).permute(0, 2, 3, 1)
                         for i, f in enumerate(features)]
        return self._compute_outputs(dets, seg_feats, compute_masks)

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
        head once at size K, scatter back to (B, R)."""
        B, R = levels_r.shape
        eligible = valid[:, :R] & (mask_labels >= 0)
        K = min(int(self.mask_budget), B * R)
        flat_score = torch.where(eligible, scores_r, torch.zeros_like(scores_r)).reshape(B * R)
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
