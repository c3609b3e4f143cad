"""FCOS: the anchor-free one-stage detection header (port of
``hd_yolo_tpu/hnet/fcos.py``), on NHWC pyramid levels.

Per level the class and box towers (4 x [3x3 conv 256, GroupNorm(32) with
flax's eps 1e-6, ReLU], cuDNN convolutions as JAX runs them outside any
Pallas kernel), then class logits, ltrb regression (``relu(r) · stride``
with ``norm_reg_targets``, else ``exp(r)``, after a learnable per-level
scale) and centerness (on the box tower with ``centerness_on_reg``).

``compute_losses`` is the JAX package's: per level, every location against
every target (size-of-interest ranges, center sampling of radius 1.5
strides, the smallest box wins), the sigmoid focal loss over all locations
and the centerness BCE over the positives, each over the image's positives
of that level, and the IoU loss weighted by the centerness target; an
image's terms are summed over the levels and averaged over the images,
weighted by ``image_weight``.  ``infer`` keeps the ``pre_nms_topk``
locations of highest √(max p · centerness) over all levels (a stable
descending sort: ``lax.top_k``'s order, ties to the lower index), then
class-aware NMS to ``num_detections`` (the NMS kernel on the card).

Key layout: ``cls_tower`` / ``bbox_tower`` ``conv{i}`` / ``gn{i}``,
``cls_logits``, ``bbox_pred``, ``centerness`` and ``scales.{i}.scale``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import clip_boxes
from ..ops.nms import batched_nms_padded
from ..parallel.distributed import batch_count, global_mean
from .fpn import GN_EPS
from .layers import conv, group_norm

Tensor = torch.Tensor

_INF = 1e8


def _size_ranges(num_levels: int, base: float = 64.0) -> Tuple[Tuple[float, float], ...]:
    """Per level the [lo, hi) range of a target's largest ltrb extent."""
    edges = [0.0] + [base * (2.0 ** i) for i in range(num_levels - 1)] + [_INF]
    return tuple((edges[i], edges[i + 1]) for i in range(num_levels))


class Scale(nn.Module):
    """A learnable scalar multiplier, applied in the input's dtype."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: Tensor) -> Tensor:
        return x * self.scale.to(x.dtype)


class FCOSTower(nn.Module):
    """``num_convs`` x [3x3 conv + GroupNorm(32) + ReLU] on NHWC."""

    def __init__(self, in_channels: int, channels: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(self, f"conv{i}", nn.Conv2d(in_channels if i == 0 else channels, channels,
                                                3, 1, 1))
            setattr(self, f"gn{i}", nn.GroupNorm(32, channels, eps=GN_EPS))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.num_convs):
            x = torch.relu(group_norm(getattr(self, f"gn{i}"), conv(getattr(self, f"conv{i}"), x)))
        return x


class FCOS(nn.Module):
    """FCOS header with the engine interface of ``MaskRCNN`` (``infer``,
    ``compute_losses``), so it drops into HNet's double pass."""

    def __init__(self, in_channels: int, num_classes: int,
                 strides: Sequence[float] = (8.0, 16.0, 32.0, 64.0), num_convs: int = 4,
                 prior_prob: float = 0.01, norm_reg_targets: bool = True,
                 centerness_on_reg: bool = True, center_sample_radius: float = 1.5,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5, pre_nms_topk: int = 512,
                 num_detections: int = 100, size_base: float = 64.0):
        super().__init__()
        self.num_classes = num_classes                 # foreground classes, labels 1..nc
        self.strides = tuple(float(s) for s in strides)
        self.prior_prob = prior_prob
        self.norm_reg_targets = norm_reg_targets
        self.centerness_on_reg = centerness_on_reg
        self.center_sample_radius = center_sample_radius
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.pre_nms_topk = pre_nms_topk
        self.num_detections = num_detections
        self.size_base = size_base
        self.cls_tower = FCOSTower(in_channels, 256, num_convs)
        self.bbox_tower = FCOSTower(in_channels, 256, num_convs)
        self.cls_logits = nn.Conv2d(256, num_classes, 3, 1, 1)
        self.bbox_pred = nn.Conv2d(256, 4, 3, 1, 1)
        self.centerness = nn.Conv2d(256, 1, 3, 1, 1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's init: every conv N(0, 0.01) with a zero bias, the class bias
        at the focal prior −log((1 − p) / p), unit GroupNorms and scales."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * 0.01)
                mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.cls_logits.bias.fill_(-math.log((1 - self.prior_prob) / self.prior_prob))
        for s in self.scales:
            s.scale.fill_(1.0)

    # ------------------------------------------------------------------ head
    def _head(self, feats: Sequence[Tensor]):
        """Per level: (B, H, W, nc) logits, (B, H, W, 4) ltrb px, (B, H, W)
        centerness logits, all f32."""
        logits, regs, ctrs = [], [], []
        for i, f in enumerate(feats):
            ct = self.cls_tower(f)
            bt = self.bbox_tower(f)
            logits.append(conv(self.cls_logits, ct).float())
            ctrs.append(conv(self.centerness, bt if self.centerness_on_reg else ct).float()[..., 0])
            r = self.scales[i](conv(self.bbox_pred, bt)).float()
            regs.append(torch.relu(r) * self.strides[i] if self.norm_reg_targets else torch.exp(r))
        return logits, regs, ctrs

    def _locations(self, shapes: Sequence[Tuple[int, int]], device) -> List[Tensor]:
        """Per level (H·W, 2) x, y pixel centres of its cells."""
        out = []
        for (h, w), s in zip(shapes, self.strides):
            ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) * s + s / 2,
                                    torch.arange(w, dtype=torch.float32, device=device) * s + s / 2,
                                    indexing="ij")
            out.append(torch.stack([xs, ys], -1).reshape(h * w, 2))
        return out

    # ---------------------------------------------------------------- engine
    def forward(self, feats: Sequence[Tensor], image_size: Tuple[int, int],
                targets: Optional[Dict[str, Tensor]] = None,
                image_weight: Optional[Tensor] = None):
        """(losses, outputs): the losses with ``targets``; the detections in
        eval mode."""
        losses = ({} if targets is None
                  else self.compute_losses(feats, image_size, targets, image_weight))
        return losses, ({} if self.training else self.infer(feats, image_size))

    def compute_losses(self, feats: Sequence[Tensor], image_size: Tuple[int, int],
                       targets: Dict[str, Tensor],
                       image_weight: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """``fcos_cls_loss``, ``fcos_reg_loss``, ``fcos_ctr_loss`` (f32 0-d).
        ``targets``: ``boxes`` (B, T, 4) normalised xyxy, ``labels`` (B, T)
        1..nc, ``valid`` (B, T); ``image_weight`` (B,) weighs each image."""
        H, W = image_size
        logits, regs, ctrs = self._head(feats)
        dev = logits[0].device
        locs = self._locations([tuple(f.shape[1:3]) for f in feats], dev)
        ranges = _size_ranges(len(feats), self.size_base)
        gt = targets["boxes"].float() * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
        glabels = targets["labels"].long().clamp(0, self.num_classes)
        gvalid = targets["valid"].bool() & (glabels > 0)
        terms = [self._level_loss(locs[l], logits[l], regs[l], ctrs[l], gt, gvalid, glabels,
                                  ranges[l], self.strides[l]) for l in range(len(feats))]

        def wmean(per_level):
            v = sum(per_level)
            if image_weight is None:
                return global_mean(v)
            w = image_weight.to(v.dtype)
            return (v * w).sum() / batch_count(w.sum()).clamp(min=1.0)

        return {"fcos_cls_loss": wmean([t[0] for t in terms]),
                "fcos_reg_loss": wmean([t[1] for t in terms]),
                "fcos_ctr_loss": wmean([t[2] for t in terms])}

    def _level_loss(self, loc, logits, reg, ctr, gt, gvalid, glabels, rng, stride):
        """One level's per-image (B,) focal, IoU and centerness terms: loc (L,
        2); logits (B, H, W, nc); reg (B, H, W, 4); ctr (B, H, W); gt (B, T,
        4) px."""
        B, nc = logits.shape[0], self.num_classes
        L = loc.shape[0]
        logits, reg, ctr = logits.reshape(B, L, nc), reg.reshape(B, L, 4), ctr.reshape(B, L)
        xs, ys = loc[:, 0][None, :, None], loc[:, 1][None, :, None]
        ltrb = torch.stack([xs - gt[:, None, :, 0], ys - gt[:, None, :, 1],
                            gt[:, None, :, 2] - xs, gt[:, None, :, 3] - ys], -1)   # (B, L, T, 4)
        in_box = ltrb.amin(-1) > 0.0
        if self.center_sample_radius > 0:
            cx = (gt[..., 0] + gt[..., 2]) * 0.5
            cy = (gt[..., 1] + gt[..., 3]) * 0.5
            rr = self.center_sample_radius * stride
            in_box = in_box & ((xs - cx[:, None, :]).abs() < rr) & ((ys - cy[:, None, :]).abs() < rr)
        maxd = ltrb.amax(-1)
        cand = in_box & (maxd >= rng[0]) & (maxd < rng[1]) & gvalid[:, None, :]
        area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
        cand_area = torch.where(cand, area[:, None, :], torch.full_like(maxd, _INF))
        best_t = cand_area.argmin(-1)                                            # the smallest box
        is_fg = cand.any(-1)
        tgt_ltrb = torch.gather(ltrb, 2, best_t[..., None, None].expand(B, L, 1, 4))[:, :, 0]
        tgt_label = torch.gather(glabels, 1, best_t)

        onehot = F.one_hot(torch.where(is_fg, tgt_label - 1, nc), nc + 1)[..., :nc].float()
        p = torch.sigmoid(logits)
        pt = p * onehot + (1 - p) * (1 - onehot)
        af = 0.25 * onehot + 0.75 * (1 - onehot)
        focal = af * (1 - pt) ** 2 * -torch.log(pt.clamp(min=1e-8))
        fgf = is_fg.float()
        n_pos = fgf.sum(-1).clamp(min=1.0)
        cls_loss = focal.sum((-1, -2)) / n_pos

        safe = lambda x: x.clamp(min=1e-6)                                    # noqa: E731
        lr, tb = tgt_ltrb[..., [0, 2]], tgt_ltrb[..., [1, 3]]
        ctr_tgt = torch.sqrt((lr.amin(-1) / safe(lr.amax(-1))) * (tb.amin(-1) / safe(tb.amax(-1))))
        ctr_tgt = torch.where(is_fg, ctr_tgt, torch.zeros_like(ctr_tgt)).clamp(0.0, 1.0)
        inter_w = torch.minimum(reg[..., 0], tgt_ltrb[..., 0]) + torch.minimum(reg[..., 2],
                                                                               tgt_ltrb[..., 2])
        inter_h = torch.minimum(reg[..., 1], tgt_ltrb[..., 1]) + torch.minimum(reg[..., 3],
                                                                               tgt_ltrb[..., 3])
        inter = inter_w.clamp(min=0) * inter_h.clamp(min=0)
        a_pred = (reg[..., 0] + reg[..., 2]) * (reg[..., 1] + reg[..., 3])
        a_tgt = (tgt_ltrb[..., 0] + tgt_ltrb[..., 2]) * (tgt_ltrb[..., 1] + tgt_ltrb[..., 3])
        iou = (inter + 1.0) / (safe(a_pred) + safe(a_tgt) - inter + 1.0)
        w = ctr_tgt * fgf
        reg_loss = (-torch.log(iou.clamp(min=1e-8)) * w).sum(-1) / w.sum(-1).clamp(min=1e-6)

        ctr_bce = ctr.clamp(min=0) - ctr * ctr_tgt + torch.log1p(torch.exp(-ctr.abs()))
        ctr_loss = (ctr_bce * fgf).sum(-1) / n_pos
        return cls_loss, reg_loss, ctr_loss

    def infer(self, feats: Sequence[Tensor], image_size: Tuple[int, int]) -> Dict[str, Tensor]:
        """Detections: boxes (B, D, 4) xyxy px, scores (B, D), labels (B, D)
        1..nc (-100 where invalid), valid (B, D)."""
        logits, regs, ctrs = self._head(feats)
        locs = self._locations([tuple(f.shape[1:3]) for f in feats], logits[0].device)
        B, nc = feats[0].shape[0], self.num_classes
        rows_s, rows_b, rows_l = [], [], []
        for lvl, loc in enumerate(locs):
            L = loc.shape[0]
            p = torch.sigmoid(logits[lvl].reshape(B, L, nc))
            c = torch.sigmoid(ctrs[lvl].reshape(B, L))
            pmax, label = p.max(-1)
            r = regs[lvl].reshape(B, L, 4)
            rows_s.append(torch.sqrt(pmax * c))
            rows_b.append(torch.stack([loc[:, 0] - r[..., 0], loc[:, 1] - r[..., 1],
                                       loc[:, 0] + r[..., 2], loc[:, 1] + r[..., 3]], -1))
            rows_l.append(label)
        score = torch.cat(rows_s, 1)
        boxes = clip_boxes(torch.cat(rows_b, 1), image_size)
        label = torch.cat(rows_l, 1)
        K = min(self.pre_nms_topk, score.shape[1])
        top_s, sel = torch.sort(score, dim=1, descending=True, stable=True)
        top_s, sel = top_s[:, :K], sel[:, :K]
        boxes_k = torch.gather(boxes, 1, sel[..., None].expand(B, K, 4))
        label_k = torch.gather(label, 1, sel)
        idx, keep = batched_nms_padded(boxes_k, top_s, label_k, top_s > self.score_thresh,
                                       self.nms_thresh, self.num_detections)
        idx = idx.long()
        g = lambda x: torch.gather(x, 1, idx)                                 # noqa: E731
        return {
            "boxes": torch.gather(boxes_k, 1, idx[..., None].expand(B, idx.shape[1], 4))
            * keep[..., None],
            "scores": g(top_s) * keep,
            "labels": torch.where(keep, g(label_k) + 1, torch.full_like(idx, -100)),
            "valid": keep,
        }
