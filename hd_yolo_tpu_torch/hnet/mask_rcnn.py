"""Mask R-CNN header (port of ``hd_yolo_tpu/hnet/mask_rcnn.py``): RPN
proposals, the box head with class-aware NMS, the mask head, and the
training losses.

Static shapes as in the JAX package: ``pre_nms_topk`` anchors per image →
NMS → ``num_proposals`` padded proposals → box head → class-aware NMS →
``num_detections`` padded detections, each with a 28x28 mask.  Both NMS
calls go through ``ops/nms.nms_dispatch`` (the NMS kernel on the card), the
ROI pooling through ``multiscale_roi_align_canvas`` (the canvas ROI-align
kernel) and the masks through ``fused_mask_probs`` (the mask-head kernel).
``infer`` runs the stages ``propose`` (``proposals``), ``classify``,
``select``, ``masks`` and, with ``num_keypoints`` > 0, ``keypoints``: the
KeypointRCNN branch on 14x14 ROIs (8 x [3x3 conv 512 + ReLU], a 4x4
stride-2 transposed conv, bilinear x2 to 56² heatmaps; the convs are
cuDNN's, as JAX runs them outside any Pallas kernel), each keypoint at its
heatmap's argmax in the box frame with the softmax maximum as its score.

``compute_losses`` is the JAX package's: RPN objectness and box regression
against the anchors, and the RoI head's classification, box regression and
mask losses on the proposals with the GT boxes added (and the keypoint
heatmap cross-entropy over the visible keypoints), each under the
deterministic expectation of torchvision's random pos/neg sampler
(``sampler_weights``), so the port's losses are JAX's exactly, not in
distribution.  Under autograd both the pooling (``RoiAlignBoundedFn``: the
kernel ``roi_align_bwd`` on the card) and the mask head (the cuDNN chain
of ``MaskHead.forward``, where inference runs the mask-head kernel, which
has no backward) are differentiable in the features, also inside ``infer``
(the detections' scores and masks feed the confliction loss); NMS selects
indices and the gathers carry the gradients.  The pooling gives the boxes
no gradient, as JAX's TPU kernels' vjps give none (XLA's would); the
regression targets of the proposals stay attached to them, as in JAX.

Key layout (``hd_yolo_tpu/utils/import_maskrcnn.py``, torchvision's):
``rpn.head.{conv,cls_logits,bbox_pred}``, ``roi_heads.box_head.{fc6,fc7}``,
``roi_heads.box_predictor.{cls_score,bbox_pred}``; ``fc6`` takes the
reference's (C, 7, 7) flattening.  The mask head is the port's
``MaskHead`` (``roi_heads.mask_head.maskrcnn_heads.mask_fcn{1..4}``,
``...maskrcnn_preds.{conv5_mask,mask_fcn_logits}``); the keypoint branch
torchvision's (``roi_heads.keypoint_head.{0,2,..,14}``,
``roi_heads.keypoint_predictor.kps_score_lowres``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.detect_head import MaskHead
from ..models.layers import cached
from ..ops.boxes import box_iou, clip_boxes, xywh2xyxy, xyxy2xywh
from ..ops.nms import batched_nms_padded, nms_dispatch
from ..ops.pallas_mask_head import fused_mask_probs
from ..ops.roi_align import multiscale_roi_align_canvas
from ..parallel.distributed import batch_count, global_mean
from .layers import cast_params, conv, dense

Tensor = torch.Tensor

BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# the reference RPN's BoxCoder uses unit weights, its RoI head BBOX_REG_WEIGHTS
RPN_BOX_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCORE_THRESH = 0.05
NMS_THRESH = 0.5
RPN_NMS_THRESH = 0.7


def generate_anchors(level_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
                     sizes: Sequence[float], aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                     device=None) -> List[Tensor]:
    """Per-level (H·W·A, 4) xyxy anchors, torchvision's AnchorGenerator
    convention: zero-centred cell anchors with corners rounded half to even,
    shifted by i·stride, all in f32."""
    ar = torch.tensor(aspect_ratios, dtype=torch.float32, device=device)
    out = []
    for (h, w), stride, size in zip(level_shapes, strides, sizes):
        ws, hs = size / torch.sqrt(ar), size * torch.sqrt(ar)
        base = torch.round(torch.stack([-ws, -hs, ws, hs], -1) / 2)          # (A, 4)
        sy, sx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) * stride,
                                torch.arange(w, dtype=torch.float32, device=device) * stride,
                                indexing="ij")
        shifts = torch.stack([sx, sy, sx, sy], -1)[:, :, None]               # (h, w, 1, 4)
        out.append((shifts + base).reshape(-1, 4))
    return out


def decode_deltas(anchors: Tensor, deltas: Tensor, clip: float = 4.135,
                  weights: Tuple[float, ...] = BBOX_REG_WEIGHTS) -> Tensor:
    """(dx, dy, dw, dh)·weights⁻¹ applied to xyxy anchors → xyxy."""
    wx, wy, ww, wh = weights
    a = xyxy2xywh(anchors)
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = a[..., 0] + dx / wx * a[..., 2]
    cy = a[..., 1] + dy / wy * a[..., 3]
    w = a[..., 2] * torch.exp((dw / ww).clamp(-clip, clip))
    h = a[..., 3] * torch.exp((dh / wh).clamp(-clip, clip))
    return xywh2xyxy(torch.stack([cx, cy, w, h], -1))


def encode_deltas(anchors: Tensor, gt: Tensor,
                  weights: Tuple[float, ...] = BBOX_REG_WEIGHTS) -> Tensor:
    """xyxy ``gt`` relative to xyxy ``anchors`` → (dx, dy, dw, dh)·weights."""
    wx, wy, ww, wh = weights
    a, g = xyxy2xywh(anchors), xyxy2xywh(gt)
    eps = 1e-6
    dx = wx * (g[..., 0] - a[..., 0]) / a[..., 2].clamp(min=eps)
    dy = wy * (g[..., 1] - a[..., 1]) / a[..., 3].clamp(min=eps)
    dw = ww * torch.log(g[..., 2].clamp(min=eps) / a[..., 2].clamp(min=eps))
    dh = wh * torch.log(g[..., 3].clamp(min=eps) / a[..., 3].clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], -1)


def smooth_l1(x: Tensor, beta: float = 1.0 / 9) -> Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def assign_targets(anchors: Tensor, gt_boxes: Tensor, gt_valid: Tensor, fg_iou: float,
                   bg_iou: float, anchor_valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per image (leading batch dims shared by all arguments; ``anchors``
    may lack them): (labels 1 fg / 0 bg / −1 ignore, matched GT index).
    The best anchor of every valid GT is promoted to fg as torchvision does;
    ``anchor_valid`` keeps padded rows out of both.  Where GTs share a best
    anchor, the last GT's validity decides, as XLA's scatter applies them."""
    iou = box_iou(anchors, gt_boxes)                                  # (..., N, T)
    neg = torch.full_like(iou, -1.0)
    iou = torch.where(gt_valid[..., None, :], iou, neg)
    if anchor_valid is not None:
        iou = torch.where(anchor_valid[..., :, None], iou, neg)
    best_iou, best_gt = iou.max(-1)
    labels = torch.where(best_iou >= fg_iou, 1, torch.where(best_iou < bg_iou, 0, -1))
    best_anchor = iou.argmax(-2)                                      # (..., T)
    T = gt_boxes.shape[-2]
    order = torch.arange(T, device=iou.device).expand(best_anchor.shape)
    last = torch.full(iou.shape[:-1], -1, dtype=torch.int64, device=iou.device)
    last = last.scatter_reduce(-1, best_anchor, order, reduce="amax")
    promote = (last >= 0) & torch.gather(gt_valid, -1, last.clamp(min=0))
    labels = torch.where(promote, 1, labels)
    if anchor_valid is not None:
        labels = torch.where(anchor_valid, labels, -1)
    return labels, best_gt


def sampler_weights(pos: Tensor, neg: Tensor, budget: float, pos_fraction: float):
    """The expectation of torchvision's BalancedPositiveNegativeSampler over
    the last axis: each positive / negative row weighs the probability that
    the sampler draws it.  Returns (weights, positive draw probability,
    sampled count >= 1), the last two with the last axis reduced."""
    n_pos, n_neg = pos.sum(-1), neg.sum(-1)
    n_pos_s = n_pos.clamp(max=budget * pos_fraction)
    n_neg_s = torch.minimum(n_neg, budget - n_pos_s)
    p_pos = n_pos_s / n_pos.clamp(min=1.0)
    w = pos * p_pos[..., None] + neg * (n_neg_s / n_neg.clamp(min=1.0))[..., None]
    return w, p_pos, (n_pos_s + n_neg_s).clamp(min=1.0)


def balanced_bce(logits: Tensor, labels: Tensor, budget: float = 256.0,
                 pos_fraction: float = 0.5) -> Tensor:
    """Objectness BCE over the last axis under the expectation sampler."""
    pos, neg = (labels == 1).float(), (labels == 0).float()
    w, _, n_sampled = sampler_weights(pos, neg, budget, pos_fraction)
    bce = -(pos * F.logsigmoid(logits) + neg * F.logsigmoid(-logits))
    return (bce * w).sum(-1) / n_sampled


def _wmean(per_image: Tensor, weight: Optional[Tensor]) -> Tensor:
    """The (``weight``-weighted) mean over the images of the global batch
    (``parallel.global_batch``: the counts summed over the processes)."""
    if weight is None:
        return global_mean(per_image)
    w = weight.to(per_image.dtype)
    return (per_image * w).sum() / batch_count(w.sum()).clamp(min=1.0)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, K, ...) gathered along dim 1 by idx (B, D) → (B, D, ...)."""
    idx = idx.to(torch.int64)
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int, channels: int = 256):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, channels, 3, 1, 1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
        """Per level NHWC → objectness (B, ΣHWA) and deltas (B, ΣHWA, 4)."""
        logits, deltas = [], []
        for f in feats:
            t = torch.relu(conv(self.conv, f))
            B = f.shape[0]
            logits.append(conv(self.cls_logits, t).reshape(B, -1))
            deltas.append(conv(self.bbox_pred, t).reshape(B, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class _RPN(nn.Module):
    def __init__(self, head: RPNHead):
        super().__init__()
        self.head = head


class BoxHead(nn.Module):
    """fc6 + ReLU, fc7 + ReLU (1024 wide) on a flattened (R, 7, 7, C) ROI batch."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.fc6 = nn.Linear(in_channels * 7 * 7, 1024)
        self.fc7 = nn.Linear(1024, 1024)

    def fc6_nhwc(self, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """fc6 with its input columns permuted (C, 7, 7) → (7, 7, C), in ``dtype``."""
        def make():
            w = self.fc6.weight
            w = w.reshape(w.shape[0], -1, 7, 7).permute(0, 2, 3, 1).reshape(w.shape[0], -1)
            return w.to(dtype).contiguous(), self.fc6.bias.to(dtype)

        return cached(self, f"fc6_nhwc_{dtype}", (self.fc6.weight, self.fc6.bias), make)

    def forward(self, rois: Tensor) -> Tensor:
        w6, b6 = self.fc6_nhwc(rois.dtype)
        x = torch.relu(torch.nn.functional.linear(rois.reshape(rois.shape[0], -1), w6, b6))
        return torch.relu(dense(self.fc7, x))


class BoxPredictor(nn.Module):
    def __init__(self, hidden: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(hidden, num_classes)
        self.bbox_pred = nn.Linear(hidden, num_classes * 4)


class KeypointHead(nn.Sequential):
    """torchvision's KeypointRCNNHeads: 8 x [3x3 conv 512 + ReLU]."""

    def __init__(self, in_channels: int, width: int = 512, depth: int = 8):
        layers = []
        for i in range(depth):
            layers += [nn.Conv2d(in_channels if i == 0 else width, width, 3, 1, 1), nn.ReLU()]
        super().__init__(*layers)

    def forward(self, x: Tensor) -> Tensor:             # NHWC
        for m in self:
            if isinstance(m, nn.Conv2d):
                x = torch.relu(conv(m, x))
        return x


class KeypointPredictor(nn.Module):
    """The 4x4 stride-2 transposed conv (flax SAME: torch padding 1) to
    ``num_keypoints`` channels, then bilinear x2 in f32: (R, S, S, C) NHWC →
    (R, 4S, 4S, num_keypoints) heatmap logits."""

    def __init__(self, in_channels: int, num_keypoints: int):
        super().__init__()
        self.kps_score_lowres = nn.ConvTranspose2d(in_channels, num_keypoints, 4, 2, 1)

    def forward(self, x: Tensor) -> Tensor:
        m = self.kps_score_lowres
        w, b = cast_params(m, x.dtype)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=2, padding=1)
        y = F.interpolate(y.float(), scale_factor=2, mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)


class _RoIHeads(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, with_masks: bool,
                 num_keypoints: int = 0):
        super().__init__()
        self.box_head = BoxHead(in_channels)
        self.box_predictor = BoxPredictor(1024, num_classes)
        if with_masks:
            self.mask_head = MaskHead(num_classes, 256, in_channels)
        if num_keypoints > 0:
            self.keypoint_head = KeypointHead(in_channels)
            self.keypoint_predictor = KeypointPredictor(512, num_keypoints)

    def heatmaps(self, rois: Tensor) -> Tensor:
        """(R, 14, 14, C) ROIs → (R, 56, 56, num_keypoints) f32 logits."""
        return self.keypoint_predictor(self.keypoint_head(rois))


class MaskRCNN(nn.Module):
    """Per-task Mask R-CNN header over NHWC pyramid levels; with
    ``num_keypoints`` > 0 also the KeypointRCNN branch."""

    def __init__(self, in_channels: int, num_classes: int,
                 strides: Sequence[float] = (4.0, 8.0, 16.0, 32.0),
                 anchor_sizes: Sequence[float] = (32.0, 64.0, 128.0, 256.0),
                 pre_nms_topk: int = 1024, num_proposals: int = 256, num_detections: int = 100,
                 with_masks: bool = True, num_keypoints: int = 0):
        super().__init__()
        self.num_classes = num_classes                  # foreground classes (no bg)
        self.strides = tuple(strides)
        self.anchor_sizes = tuple(anchor_sizes)
        self.pre_nms_topk = pre_nms_topk
        self.num_proposals = num_proposals
        self.num_detections = num_detections
        self.with_masks = with_masks
        self.num_keypoints = num_keypoints
        self.rpn = _RPN(RPNHead(in_channels, len(ASPECT_RATIOS)))
        self.roi_heads = _RoIHeads(in_channels, num_classes + 1, with_masks, num_keypoints)

    def anchors(self, level_shapes: Sequence[Tuple[int, int]], device) -> Tensor:
        """(N, 4) anchors of all levels, made once per level shapes and device."""
        cache = self.__dict__.setdefault("_anchors", {})
        key = (tuple(level_shapes), str(device))
        if key not in cache:
            cache[key] = torch.cat(generate_anchors(level_shapes, self.strides, self.anchor_sizes,
                                                    ASPECT_RATIOS, device))
        return cache[key]

    def rpn_outputs(self, feats: Sequence[Tensor], image_size: Tuple[int, int]):
        """RPN → (anchors (N, 4), objectness (B, N), deltas (B, N, 4) in the
        features' dtype, proposals (B, num_proposals, 4) xyxy, valid)."""
        anchors = self.anchors([tuple(f.shape[1:3]) for f in feats], feats[0].device)
        logits, deltas = self.rpn.head(feats)
        return (anchors, logits, deltas,
                *self.proposals(logits.float(), deltas.float(), anchors, image_size))

    def propose(self, feats: Sequence[Tensor], image_size: Tuple[int, int]):
        """RPN → (proposals (B, num_proposals, 4) xyxy, valid (B, num_proposals))."""
        return self.rpn_outputs(feats, image_size)[3:]

    def proposals(self, logits: Tensor, deltas: Tensor, anchors: Tensor,
                  image_size: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
        """f32 RPN outputs → top ``pre_nms_topk`` anchors, decoded, clipped
        and NMS-ed to ``num_proposals`` padded proposals."""
        k = min(self.pre_nms_topk, logits.shape[1])
        # lax.top_k order: descending, ties to the lower index (stable sort)
        scores, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
        scores, sel = scores[:, :k], sel[:, :k]
        boxes = decode_deltas(anchors[sel], _take(deltas, sel), weights=RPN_BOX_WEIGHTS)
        boxes = clip_boxes(boxes, image_size)
        ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) & (boxes[..., 3] - boxes[..., 1] > 1e-3)
        idx, keep = nms_dispatch(boxes, scores, ok, RPN_NMS_THRESH, self.num_proposals)
        return _take(boxes, idx), keep

    def pool(self, feats: Sequence[Tensor], boxes: Tensor, output_size: int) -> Tensor:
        """FPN level assignment (torchvision's LevelMapper, stride-4 level
        rebased to 0) + multiscale ROI-align → (B, K, M, M, C)."""
        area = torch.sqrt(((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1]))
                          .clamp(min=1e-6))
        lvl = torch.floor(4.0 + torch.log2(area / 224.0) + 1e-6) - 2
        lvl = lvl.clamp(0, len(self.strides) - 1).to(torch.int32)
        return multiscale_roi_align_canvas(feats, boxes, lvl, self.strides, output_size)

    def infer(self, feats: Sequence[Tensor], image_size: Tuple[int, int]) -> Dict[str, Tensor]:
        """Detections: boxes (B, D, 4) xyxy, scores (B, D), labels (B, D) in
        1..num_classes (-100 where invalid), valid (B, D) and, with masks,
        masks (B, D, 28, 28) in-box probabilities (0 where invalid) and,
        with keypoints, keypoints (B, D, num_keypoints, 3): x, y px and score
        (0 where invalid)."""
        proposals, pvalid = self.propose(feats, image_size)
        probs, box_deltas = self.classify(feats, proposals)
        out = self.select(probs, box_deltas, proposals, pvalid, image_size)
        if self.with_masks:
            out["masks"] = self.masks(feats, out["boxes"], out["labels"], out["valid"])
        if self.num_keypoints > 0:
            out["keypoints"] = self.keypoints(feats, out["boxes"], out["valid"])
        return out

    def classify(self, feats: Sequence[Tensor], proposals: Tensor) -> Tuple[Tensor, Tensor]:
        """Box head on 7x7 ROIs → f32 class probabilities (B, R, 1 + nc) and
        box deltas (B, R, 1 + nc, 4)."""
        pooled = self.pool(feats, proposals, 7)
        B, R = proposals.shape[:2]
        x = self.roi_heads.box_head(pooled.reshape((B * R,) + pooled.shape[2:]))
        pred = self.roi_heads.box_predictor
        probs = torch.softmax(dense(pred.cls_score, x).float(), -1).reshape(B, R, -1)
        box_deltas = dense(pred.bbox_pred, x).float().reshape(B, R, self.num_classes + 1, 4)
        return probs, box_deltas

    def select(self, probs: Tensor, box_deltas: Tensor, proposals: Tensor, pvalid: Tensor,
               image_size: Tuple[int, int]) -> Dict[str, Tensor]:
        """Best foreground class per proposal, then class-aware NMS →
        ``num_detections`` padded detections (no masks)."""
        B, R = proposals.shape[:2]
        fg_probs = probs[..., 1:]
        label = fg_probs.argmax(-1)
        score = torch.gather(fg_probs, -1, label[..., None])[..., 0]
        d = torch.gather(box_deltas, 2, (label + 1)[..., None, None].expand(B, R, 1, 4))[:, :, 0]
        boxes = clip_boxes(decode_deltas(proposals, d), image_size)
        ok = pvalid & (score > SCORE_THRESH)
        idx, keep = batched_nms_padded(boxes, score, label, ok, NMS_THRESH, self.num_detections)
        return {
            "boxes": _take(boxes, idx) * keep[..., None],
            "scores": _take(score, idx) * keep,
            "labels": torch.where(keep, _take(label, idx) + 1, torch.full_like(idx, -100,
                                                                               dtype=torch.int64)),
            "valid": keep,
        }

    def masks(self, feats: Sequence[Tensor], boxes: Tensor, labels: Tensor,
              valid: Tensor) -> Tensor:
        """(B, D, 28, 28) in-box mask probabilities of each detection's class
        (the background channel for label -100), zero where not ``valid``."""
        pooled = self.pool(feats, boxes, 14)
        B, K = boxes.shape[:2]
        flat = pooled.reshape((B * K,) + pooled.shape[2:])
        ch = labels.clamp(0, self.num_classes).reshape(-1)
        head = self.roi_heads.mask_head
        if torch.is_grad_enabled() and flat.requires_grad:
            # differentiable: the cuDNN chain (the kernel has no backward)
            logits = torch.gather(head(flat).float(), -1,
                                  ch[:, None, None, None].expand(-1, 28, 28, 1))[..., 0]
            probs = torch.sigmoid(logits)
        else:
            probs = fused_mask_probs(head, flat, ch)
        return probs.reshape(B, K, *probs.shape[1:]) * valid[..., None, None]

    def heatmaps(self, feats: Sequence[Tensor], boxes: Tensor) -> Tensor:
        """(B, K, 4) boxes → their (B, K, nk, 56²) f32 heatmap logits, each
        keypoint's map flattened row-major."""
        pooled = self.pool(feats, boxes, 14)
        B, K = boxes.shape[:2]
        hm = self.roi_heads.heatmaps(pooled.reshape((B * K,) + pooled.shape[2:]))
        S = hm.shape[1]
        return hm.reshape(B, K, S * S, self.num_keypoints).transpose(2, 3)

    def keypoints(self, feats: Sequence[Tensor], boxes: Tensor, valid: Tensor) -> Tensor:
        """(B, D, nk, 3): each keypoint at its heatmap's argmax, the cell
        centre mapped into the box, and its softmax maximum as the score;
        zero where not ``valid``."""
        flat = self.heatmaps(feats, boxes)
        S = math.isqrt(flat.shape[-1])
        prob = torch.softmax(flat, -1)
        idx = flat.argmax(-1)
        u = (idx % S).float() + 0.5
        v = torch.div(idx, S, rounding_mode="floor").float() + 0.5
        w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)[..., None]
        h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)[..., None]
        kx = boxes[..., 0][..., None] + u / S * w
        ky = boxes[..., 1][..., None] + v / S * h
        kp = torch.stack([kx, ky, prob.amax(-1)], -1)
        return kp * valid[..., None, None]

    # ---------------------------------------------------------------- losses
    def compute_losses(self, feats: Sequence[Tensor], image_size: Tuple[int, int],
                       targets: Dict[str, Tensor],
                       image_weight: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """RPN and RoI-head losses (f32 0-d tensors ``rpn_obj_loss``,
        ``rpn_reg_loss``, ``roi_cls_loss``, ``roi_reg_loss`` and, with masks
        and ``targets['masks']``, ``mask_loss``; with keypoints and
        ``targets['keypoints']``, ``keypoint_loss``).  ``targets``: ``boxes``
        (B, T, 4) normalised xyxy, ``labels`` (B, T), ``valid`` (B, T),
        ``masks`` (B, T, 28, 28) in-box, ``keypoints`` (B, T, nk, 3)
        normalised x, y and visibility; ``image_weight`` (B,) weighs each
        image's losses (0 for padded annotation ROIs)."""
        anchors, logits, deltas, proposals, pvalid = self.rpn_outputs(feats, image_size)
        h, w = image_size
        gt_boxes = targets["boxes"].float() * torch.tensor([w, h, w, h], dtype=torch.float32,
                                                           device=proposals.device)
        if self.num_keypoints > 0 and "keypoints" in targets:
            targets = {**targets, "keypoints": targets["keypoints"].float() * torch.tensor(
                [w, h, 1.0], dtype=torch.float32, device=proposals.device)}
        gt_valid = targets["valid"].bool()
        losses = self._rpn_loss(anchors, logits.float(), deltas.float(), gt_boxes, gt_valid,
                                image_weight)
        # the RoI head trains on the proposals with the GT boxes added
        roi_boxes = torch.cat([proposals, gt_boxes], 1)
        roi_valid = torch.cat([pvalid, gt_valid], 1)
        losses.update(self._roi_loss(feats, roi_boxes, roi_valid, gt_boxes, gt_valid, targets,
                                     image_weight))
        return losses

    def _rpn_loss(self, anchors, logits, deltas, gt_boxes, gt_valid, image_weight=None):
        labels, match = assign_targets(anchors, gt_boxes, gt_valid, 0.7, 0.3)
        obj = balanced_bce(logits, labels)
        tgt = encode_deltas(anchors, _take(gt_boxes, match), weights=RPN_BOX_WEIGHTS)
        pos, neg = (labels == 1).float(), (labels == 0).float()
        # torchvision's smooth-L1 sum over the sampled positives / the sampled count
        _, p_pos, n_sampled = sampler_weights(pos, neg, 256.0, 0.5)
        reg = (smooth_l1(deltas - tgt).sum(-1) * pos).sum(-1) * p_pos / n_sampled
        return {"rpn_obj_loss": _wmean(obj, image_weight),
                "rpn_reg_loss": _wmean(reg, image_weight)}

    def _roi_loss(self, feats, roi_boxes, roi_valid, gt_boxes, gt_valid, targets,
                  image_weight=None):
        pooled = self.pool(feats, roi_boxes, 7)
        B, R = roi_boxes.shape[:2]
        nc = self.num_classes
        x = self.roi_heads.box_head(pooled.reshape((B * R,) + pooled.shape[2:]))
        pred = self.roi_heads.box_predictor
        cls_logits = dense(pred.cls_score, x).float().reshape(B, R, -1)
        box_deltas = dense(pred.bbox_pred, x).float().reshape(B, R, nc + 1, 4)

        labels_m, match = assign_targets(roi_boxes, gt_boxes, gt_valid, 0.5, 0.5,
                                         anchor_valid=roi_valid)
        fg = (labels_m == 1) & roi_valid
        bg = (labels_m == 0) & roi_valid
        glabels = targets["labels"].long().clamp(0, nc)
        cls_target = torch.where(fg, torch.gather(glabels, 1, match), 0)   # bg class 0
        ce = -torch.gather(torch.log_softmax(cls_logits, -1), 2, cls_target[..., None])[..., 0]
        # torchvision fastrcnn_loss under the expectation sampler (budget 512,
        # f = 0.25): CE mean over the sample, box smooth-L1 sum over the
        # sampled fg / the sampled count
        wts, p_fg, n_sampled = sampler_weights(fg.float(), bg.float(), 512.0, 0.25)
        cls_l = (ce * wts).sum(-1) / n_sampled
        tgt = encode_deltas(roi_boxes, _take(gt_boxes, match))
        d = torch.gather(box_deltas, 2, cls_target[..., None, None].expand(B, R, 1, 4))[:, :, 0]
        reg_l = (smooth_l1(d - tgt).sum(-1) * fg).sum(-1) * p_fg / n_sampled
        losses = {"roi_cls_loss": _wmean(cls_l, image_weight),
                  "roi_reg_loss": _wmean(reg_l, image_weight)}

        with_masks = self.with_masks and "masks" in targets
        with_kp = self.num_keypoints > 0 and "keypoints" in targets
        if not (with_masks or with_kp):
            return losses
        # the masks and keypoints train on up to num_detections fg ROIs an
        # image; lax.top_k's order: descending, ties to the lower index (a
        # stable sort)
        K = min(self.num_detections, R)
        score = torch.where(fg, 1.0, -math.inf)
        sel = torch.sort(score, dim=1, descending=True, stable=True)[1][:, :K]
        mb = _take(roi_boxes, sel)
        mv = torch.gather(fg, 1, sel)
        if image_weight is not None:
            mv = mv & (image_weight > 0)[:, None]
        mmatch = torch.gather(match, 1, sel)
        if with_masks:
            pooled_m = self.pool(feats, mb, 14)
            head = self.roi_heads.mask_head
            mlogits = head(pooled_m.reshape((B * K,) + pooled_m.shape[2:])).float()
            mlogits = mlogits.reshape(B, K, 28, 28, -1)
            mcls = torch.gather(glabels, 1, mmatch)
            sel_log = torch.gather(mlogits, -1,
                                   mcls[..., None, None, None].expand(B, K, 28, 28, 1))[..., 0]
            gt_m = _take(targets["masks"], mmatch).float()
            bce = sel_log.clamp(min=0) - sel_log * gt_m + torch.log1p(torch.exp(-sel_log.abs()))
            per = bce.mean((-1, -2))
            mvf = mv.float()
            losses["mask_loss"] = (per * mvf).sum() / batch_count(mvf.sum()).clamp(min=1.0)
        if with_kp:
            losses["keypoint_loss"] = self._keypoint_loss(feats, mb, mv, _take(
                targets["keypoints"].float(), mmatch))
        return losses

    def _keypoint_loss(self, feats, kb: Tensor, kv: Tensor, gt_kp: Tensor) -> Tensor:
        """Heatmap cross-entropy of the (B, K) boxes ``kb`` (``kv``: those
        that train) against their GT keypoints (B, K, nk, 3) px: each visible
        keypoint inside its box, discretised into the 56² grid, is the target
        of its map's spatial softmax; the mean over them (0 when none)."""
        flat = self.heatmaps(feats, kb)
        S = math.isqrt(flat.shape[-1])
        w = (kb[..., 2] - kb[..., 0]).clamp(min=1e-6)[..., None]
        h = (kb[..., 3] - kb[..., 1]).clamp(min=1e-6)[..., None]
        u = torch.floor((gt_kp[..., 0] - kb[..., 0][..., None]) / w * S)
        v = torch.floor((gt_kp[..., 1] - kb[..., 1][..., None]) / h * S)
        inside = (u >= 0) & (u < S) & (v >= 0) & (v < S)
        visible = ((gt_kp[..., 2] > 0) & inside & kv[..., None]).float()
        idx = (v.clamp(0, S - 1) * S + u.clamp(0, S - 1)).long()
        ce = -torch.gather(torch.log_softmax(flat, -1), -1, idx[..., None])[..., 0]
        return (ce * visible).sum() / batch_count(visible.sum()).clamp(min=1.0)
