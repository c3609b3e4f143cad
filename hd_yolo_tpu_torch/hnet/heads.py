"""hnet dense headers and the cross-header constrain modules (port of
``hd_yolo_tpu/hnet/heads.py``): panoptic segmentation with its soft-IoU
loss, whole-ROI classification with its cross-entropy, and the
hierarchical confliction losses (``ConstrainModule`` box-mean,
``DynamicConstrainModule`` mask-weighted), whose pooling of the seg
probabilities is the single-level ROI-align (``roi_align_single``: the
kernel and its backward on the card).  Each header's ``forward(feats,
targets=None)`` returns ``(losses, outputs)`` as the flax module does.
Parameter names are the flax ones (``connector.*``, ``logits``, ``fc1``,
``fc2``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pallas_roi_align import roi_align_single
from ..parallel.distributed import batch_count, global_mean
from .fpn import PanopticFeatureConnector
from .layers import conv, dense, resize_bilinear

Tensor = torch.Tensor


def soft_iou_loss(probs: Tensor, onehot: Tensor, eps: float = 1e-6) -> Tensor:
    """1 − soft-IoU of (B, H, W, C) maps (sums over axes 1 and 2, as the JAX
    function takes them), averaged over the (image, class) pairs present in
    ``onehot``."""
    inter = (probs * onehot).sum((1, 2))
    union = (probs + onehot).sum((1, 2)) - inter
    present = onehot.sum((1, 2)) > 0
    iou = (inter + eps) / (union + eps)
    num = torch.where(present, 1.0 - iou, torch.zeros_like(iou)).sum()
    return num / batch_count(present.sum()).clamp(min=1)


class PanopticSegHead(nn.Module):
    """Panoptic connector → optional bilinear upsample by ``scale_factor`` →
    1x1 conv → softmax (f32).  With a (B, H, W) integer ``seg_map`` target
    at any stride, ``seg_loss`` is the soft-IoU loss of the probabilities
    resized to the target's size (bilinear, antialiased when shrinking)."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 128,
                 scale_factor: int = 1, num_levels: int = 4):
        super().__init__()
        self.num_classes = num_classes
        self.scale_factor = scale_factor
        self.connector = PanopticFeatureConnector(in_channels, channels, num_levels)
        self.logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[Tensor], targets: Optional[Tensor] = None
                ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        x = self.connector(feats)
        if self.scale_factor and self.scale_factor != 1:
            H, W = x.shape[1:3]
            x = resize_bilinear(x, (H * self.scale_factor, W * self.scale_factor))
        logits = conv(self.logits, x)
        probs = torch.softmax(logits.float(), -1)
        losses: Dict[str, Tensor] = {}
        if targets is not None:
            p = probs
            if tuple(p.shape[1:3]) != tuple(targets.shape[1:3]):
                p = resize_bilinear(p, targets.shape[1:3])
            onehot = F.one_hot(targets.long().clamp(0, self.num_classes - 1), self.num_classes)
            # jax.nn.one_hot gives a zero row to a label outside [0, n)
            onehot = onehot * ((targets >= 0) & (targets < self.num_classes))[..., None]
            losses["seg_loss"] = soft_iou_loss(p, onehot.float())
        return losses, {"probs": probs, "logits": logits}


class ClassificationHead(nn.Module):
    """Global average pool of the coarsest level → fc1 + ReLU → fc2.  With
    (B,) integer ``label`` targets, ``cl_loss`` is the cross-entropy mean
    over the labels >= 0 (the others are ignored)."""

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, feats: Sequence[Tensor], targets: Optional[Tensor] = None
                ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        x = feats[-1].mean((1, 2))
        logits = dense(self.fc2, torch.relu(dense(self.fc1, x))).float()
        losses: Dict[str, Tensor] = {}
        if targets is not None:
            logp = torch.log_softmax(logits, -1)
            ce = -torch.gather(logp, 1, targets.long().clamp(min=0)[:, None])[:, 0]
            valid = (targets >= 0).float()
            losses["cl_loss"] = (ce * valid).sum() / batch_count(valid.sum()).clamp(min=1)
        return losses, {"logits": logits, "probs": torch.softmax(logits, -1)}


def _bce_to_one(p: Tensor, valid: Tensor) -> Tensor:
    """Per image, the mean of −log clip(p) over the valid detections; then
    the mean over images."""
    bce = -torch.log(p.clamp(1e-6, 1.0 - 1e-6))
    v = valid.float()
    return global_mean((bce * v).sum(-1) / v.sum(-1).clamp(min=1))


class ConstrainModule(nn.Module):
    """Cross-header consistency between a seg map and a det header:
    ``edges`` ((seg class, det class), ...) are the consistent pairs.  Each
    detection's box pools the seg probabilities at ``pool_size`` and
    P(consistent) = Σ_edges mean p(seg class) · score(det class) is pushed
    to 1 with BCE."""

    def __init__(self, edges: Sequence[Sequence[int]], pool_size: int = 7):
        super().__init__()
        self.edges = tuple(tuple(e) for e in edges)
        self.pool_size = pool_size

    def forward(self, seg_probs: Tensor, det_boxes: Tensor, det_scores: Tensor,
                det_valid: Tensor, seg_stride: float = 1.0) -> Tensor:
        """seg_probs (B, Hs, Ws, n_seg); det_boxes (B, D, 4) xyxy image px;
        det_scores (B, D, n_det); det_valid (B, D) → 0-d loss."""
        pooled = roi_align_single(seg_probs, det_boxes, self.pool_size, 1.0 / seg_stride)
        p_area = pooled.mean((2, 3))                                   # (B, D, n_seg)
        p = torch.zeros(det_valid.shape, dtype=torch.float32, device=seg_probs.device)
        for seg_c, det_c in self.edges:
            p = p + p_area[..., seg_c] * det_scores[..., det_c]
        return _bce_to_one(p, det_valid)


class DynamicConstrainModule(nn.Module):
    """Mask-weighted cross-header consistency: each detection's in-box
    instance mask weights the seg probabilities pooled on its box at the
    mask's resolution,
    P(det consistent) = Σ_edges v_e · (Σ_px seg_i · mask) / Σ_px mask · score_j,
    pushed to 1 with BCE over the valid detections.  ``values`` are the
    per-edge weights (default 1)."""

    def __init__(self, edges: Sequence[Sequence[int]], values: Sequence[float] = ()):
        super().__init__()
        self.edges = tuple(tuple(e) for e in edges)
        self.values = tuple(values)

    def forward(self, seg_probs: Tensor, det_boxes: Tensor, det_scores: Tensor,
                det_masks: Tensor, det_valid: Tensor, seg_stride: float = 1.0) -> Tensor:
        """det_masks (B, D, m, m) in-box instance mask probabilities; the
        rest as ``ConstrainModule`` → 0-d loss."""
        vals = self.values or (1.0,) * len(self.edges)
        m = det_masks.shape[-1]
        pooled = roi_align_single(seg_probs, det_boxes, m, 1.0 / seg_stride)   # (B, D, m, m, n)
        masks = det_masks.float()
        msum = masks.sum((-1, -2)).clamp(min=1e-6)
        p = torch.zeros(det_valid.shape, dtype=torch.float32, device=seg_probs.device)
        for (seg_c, det_c), v in zip(self.edges, vals):
            area = (pooled[..., seg_c] * masks).sum((-1, -2)) / msum
            p = p + float(v) * area * det_scores[..., det_c]
        return _bce_to_one(p, det_valid)
