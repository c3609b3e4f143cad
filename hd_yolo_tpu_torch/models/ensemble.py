"""Model ensembling (port of ``hd_yolo_tpu/models/ensemble.py``): merge one
task's outputs of several models with score filtering and class-agnostic
NMS.

Members emit padded (B, D_i, ...) outputs; the merge concatenates them
along the detection axis, keeps the valid rows above ``conf_thres`` and
runs ``nms_dispatch`` (the NMS kernel on CUDA tensors, ``nms_padded`` on
the CPU) capped at ``max_det``.  Masks, where every member has them, are
padded up to the detection axis of the boxes when a member capped them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.nms import nms_dispatch
from .detect_head import DEFAULT_NMS_PARAMS

Tensor = torch.Tensor


def _take(t: Tensor, idx: Tensor) -> Tensor:
    """Rows ``idx`` (B, K) of ``t`` (B, D, ...)."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(
        idx.shape + t.shape[2:]))


def merge_outputs(outputs: Sequence[Dict[str, Tensor]], conf_thres: float = 0.15,
                  iou_thres: float = 0.45, max_det: int = 300) -> Dict[str, Tensor]:
    """Merge one task's outputs from N models: (B, D_i, ...) dicts → (B, max_det, ...)."""
    cat = {k: torch.cat([o[k] for o in outputs], 1) for k in ("boxes", "scores", "labels", "valid")}
    has_masks = all("masks" in o for o in outputs)
    if has_masks:
        masks = torch.cat([o["masks"] for o in outputs], 1)
        mvalid = torch.cat([o.get("mask_valid", o["valid"][:, :o["masks"].shape[1]])
                            for o in outputs], 1)
        pad = cat["boxes"].shape[1] - masks.shape[1]
        if pad > 0:            # members capped their masks below their detections
            masks = F.pad(masks, (0, 0, 0, 0, 0, pad))
            mvalid = F.pad(mvalid, (0, pad))

    ok = cat["valid"] & (cat["scores"] > conf_thres)
    idx, keep = nms_dispatch(cat["boxes"], cat["scores"], ok, iou_thres, max_det)
    idx = idx.to(torch.int64)
    out = {
        "boxes": _take(cat["boxes"], idx) * keep[..., None],
        "scores": _take(cat["scores"], idx) * keep,
        "labels": torch.where(keep, _take(cat["labels"], idx),
                              torch.full_like(idx, -100, dtype=cat["labels"].dtype)),
        "valid": keep,
    }
    if has_masks:
        out["masks"] = _take(masks, idx) * keep[..., None, None]
        out["mask_valid"] = _take(mvalid, idx) & keep
    return out


class Ensemble:
    """Callable ensemble over the port's ``Model`` members sharing task ids:
    ``ensemble(images)`` runs every member and merges each task's outputs."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 nms_params: Optional[Dict[str, float]] = None):
        self.members = list(members)
        self.nms_params = {**DEFAULT_NMS_PARAMS,
                           **{k: float(v) for k, v in (nms_params or {}).items()}}

    @torch.no_grad()
    def __call__(self, images: Tensor, compute_masks: bool = True) -> Dict[str, Dict[str, Tensor]]:
        per_member: List[Dict[str, Dict[str, Tensor]]] = [
            model(images, compute_masks=compute_masks) for model in self.members]
        merged = {}
        for t in sorted(set().union(*[set(o) for o in per_member])):
            outs = [o[t] for o in per_member if t in o and o[t]]
            if outs:
                merged[t] = merge_outputs(outs, conf_thres=self.nms_params["conf_thres"],
                                          iou_thres=self.nms_params["iou_thres"],
                                          max_det=int(self.nms_params["max_det"]))
        return merged
