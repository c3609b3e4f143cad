"""The plain reference put in the system's place: the outputs of a tile batch
(``Detector.tiles``' task dict) and of a slide (``Detector.slide``'s
record) computed by the reference at a chosen precision.  The control runs
it in float8 and is judged as the system is; at float32 it judges as exact
against the reference itself."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import postprocess as pp
from .judge import RefSlide, RefTiles, _mask_rule_packed
from .model import F32, Model, Prec

Tensor = torch.Tensor


@torch.no_grad()
def serve_tiles(model: Model, tag: str, x: Tensor, topk: int, max_masks: int,
                mask_budget: Optional[int], window: int, prec: Prec = F32) -> Dict[str, Tensor]:
    r = RefTiles(model, tag, x, topk, prec)
    h = r.h
    a = r.nms["anchor"]
    valid = a >= 0
    ai = a.clamp(min=0)
    take = lambda t: torch.gather(t, 1, ai.reshape(ai.shape + (1,) * (t.dim() - 2)).expand(
        ai.shape + t.shape[2:]))
    zero = lambda t: t * valid.reshape(valid.shape + (1,) * (t.dim() - 2)).to(t.dtype)
    sv = zero(take(r.sv))
    label = torch.where(valid, take(r.label), torch.full_like(ai, -100))
    out = {"boxes": zero(take(r.dense["boxes"])), "scores": zero(take(r.final)),
           "score_vector": sv, "labels": label, "valid": valid,
           "levels": r.dense["level"][ai] * valid}
    if r.seg is not None:
        R = min(max_masks, h["max_det"])
        mask_idx = torch.tensor(h["mask_idx"], device=x.device)
        if mask_budget:
            mv = _mask_rule_packed(valid, out["scores"], label, mask_idx, R, mask_budget)
        else:
            mv = valid[:, :R] & (mask_idx[label[:, :R].clamp(0, h["nc"])] >= 0)
        masks = torch.zeros(mv.shape + (28, 28), device=x.device)
        b, s = mv.nonzero(as_tuple=True)
        ch = mask_idx[label[b, s].clamp(0, h["nc"])].clamp(min=0)
        masks[b, s] = pp.mask_probs(r.det, r.seg, out["boxes"][b, s], out["levels"][b, s], b, ch,
                                    window, prec)
        out.update(masks=masks, mask_valid=mv)
    return out


@torch.no_grad()
def serve_slide(model: Model, tag: str, slide: Tensor, s: dict, topk: int, window: int,
                prec: Prec = F32) -> Dict[str, np.ndarray]:
    r = RefSlide(model, tag, slide, s, topk, prec)
    h = r.h
    fid = r.kept_fid
    lim = torch.tensor([r.W, r.H, r.W, r.H], dtype=torch.float32, device=slide.device)
    out = {"boxes": r.boxes.reshape(-1, 4)[fid], "scores": r.final.reshape(-1)[fid],
           "labels": r.label.reshape(-1)[fid]}
    if r.seg:
        mask_idx = torch.tensor(h["mask_idx"], device=slide.device)
        elig = mask_idx[out["labels"].clamp(0, h["nc"])] >= 0
        prio = torch.where(elig, out["scores"], torch.full_like(out["scores"], -1.0))
        top = torch.sort(prio, descending=True, stable=True).indices[:s["mask_rows"]]
        has = torch.zeros_like(elig)
        has[top] = elig[top]
        masks = torch.zeros((fid.numel(), 28, 28), device=slide.device)
        tiles = fid // r.A
        for t in torch.unique(tiles[has]).tolist():
            sel = (has & (tiles == t)).nonzero(as_tuple=True)[0]
            org = r.origins[t][[1, 0, 1, 0]].float()
            ch = mask_idx[out["labels"][sel].clamp(0, h["nc"])].clamp(min=0)
            masks[sel] = pp.mask_probs(r.det, r.tile_feats(t), out["boxes"][sel] - org,
                                       r.level[fid[sel] % r.A], torch.zeros_like(sel), ch,
                                       window, prec)
        out.update(masks=masks, has_mask=has)
    out["boxes"] = torch.minimum(out["boxes"], lim)          # as Detector.slide clips
    return {k: v.cpu().numpy() for k, v in out.items()}
