"""The comparison that decides ``correct``: the system's served outputs
held against the plain reference on the same weights and inputs.

The reference recomputes every anchor's decoded box and scores in float32
and runs its own per-image NMS (and, for a slide, its own stitch).  Each
served detection is then judged by what it says, teacher-forced on the
reference (a served token's logit gap, read for detections):

* ``box_gap``: 1 − IoU between a served box and the nearest reference
  anchor box: among the anchors of its level for a tile batch, among the
  anchors whose reference objectness is over half the threshold for a
  slide (whose rows name no level or tile; the scores there are judged at
  the anchor, within ``TILE_SLACK`` of that IoU, whose score is nearest);
* ``score_gap``: the largest difference between a served score (the
  objectness and class score vector where served, the final score) and
  the reference's at that anchor, or how much better the reference scores
  its own label than the served one (an anchor served twice reads 1); and
  for each detection the reference keeps and the system does not serve
  (served, as it were, at score 0), its reference score above the best
  excuse the served set gives it: the confidence threshold, the top-k cut
  of its image, a served detection that overlaps it past
  ``iou_thres − IOU_SLACK`` and outranks it (objectness for the per-image
  NMS, final score under any label rounding can give for the stitch), the
  slide's total cap; on a slide only the detections inside their tile's
  core count here, which the band stitch never sees (its decisions at a
  saturated ``max_band`` chain across tiles past what these excuses
  follow);
* ``overlap``: how far the IoU of two served detections that the NMS
  should have kept apart (any two of one tile; two of one label on a
  slide) passes ``iou_thres``;
* ``mask_gap``: the largest difference between a served mask probability
  and the reference head's at the served box, level and label (0 where no
  mask is served: the served value must be 0 there); on a slide, the
  closest of the tiles whose anchor matches the box within ``TILE_SLACK``;
* ``mask_set``: the served detections whose has-a-mask flag differs from
  the branch's rule (packed budget, per-image top slots, the slide's
  ``mask_rows``) applied to the served scores: an exact count.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import postprocess as pp
from .model import F32, Model, Prec

Tensor = torch.Tensor
IOU_SLACK = 0.05       # a suppression within this of the threshold may flip on rounding
NEAR = 0.5             # a slide matches anchors whose objectness is over NEAR x conf_thres
TILE_SLACK = 0.02      # a slide's anchors this close in IoU to the best see the same nucleus
LABEL_SLACK = 0.05     # class scores this close to the best may win on rounding


def _chunks(n: int, size: int):
    for i in range(0, n, size):
        yield slice(i, min(n, i + size))


class RefTiles:
    """The reference's view of one batch of tiles: the dense decode, its
    finals, its mask-branch features."""

    @torch.no_grad()
    def __init__(self, model: Model, tag: str, x: Tensor, topk: int, prec: Prec = F32):
        det = model.headers[tag]
        self.h = h = det.h
        self.det = det
        feats = model.trunk(x, prec)
        lv = [feats[j] for j in h["from"]]
        dense = pp.decode(h, det.det_logits(lv, prec))
        del feats
        self.dense = dense
        self.sv = pp.score_vectors(h, dense["obj"], dense["cls"])
        self.label, self.final = pp.labels_and_scores(h, self.sv)
        self.nms = pp.per_image_nms(h, dense, topk)
        self.seg = det.seg_feats(lv, prec) if h["nc_masks"] > 0 else None


def _match(boxes_p: Tensor, ref_boxes: Tensor, ref_ok: Tensor,
           lvl_p: Optional[Tensor] = None, ref_lvl: Optional[Tensor] = None):
    """Each served box's nearest reference anchor among ``ref_ok``: (anchor,
    IoU); an anchor −1 and IoU 0 where there is none."""
    cand = ref_ok.nonzero(as_tuple=True)[0]
    n = boxes_p.shape[0]
    best = torch.zeros(n, device=boxes_p.device)
    arg = torch.full((n,), -1, dtype=torch.int64, device=boxes_p.device)
    if cand.numel() == 0 or n == 0:
        return arg, best
    cb = ref_boxes[cand]
    for sl in _chunks(n, 64):
        iou = pp.box_iou(boxes_p[sl], cb)
        if lvl_p is not None:
            iou = torch.where(lvl_p[sl, None] == ref_lvl[cand][None, :], iou,
                              torch.zeros_like(iou))
        v, i = iou.max(1)
        best[sl], arg[sl] = v, torch.where(v > 0, cand[i], torch.full_like(i, -1))
    return arg, best


def _match_slide(boxes_p: Tensor, ref_boxes: Tensor, ref_ok: Tensor, fs_p: Tensor,
                 lab_p: Tensor, ref_sv: Tensor):
    """``_match`` for a slide, whose rows name no tile: among the anchors
    within ``TILE_SLACK`` of the best IoU (one nucleus seen by the tiles
    that overlap on it), the one whose reference score behind the served
    label is nearest the served score; and every such copy's anchor."""
    cand = ref_ok.nonzero(as_tuple=True)[0]
    n = boxes_p.shape[0]
    arg = torch.full((n,), -1, dtype=torch.int64, device=boxes_p.device)
    copies = [torch.zeros(0, dtype=torch.int64, device=boxes_p.device)]
    if cand.numel() == 0 or n == 0:
        return arg, copies[0]
    cb, csv = ref_boxes[cand], ref_sv[cand]
    for sl in _chunks(n, 64):
        iou = pp.box_iou(boxes_p[sl], cb)
        near = (iou >= iou.amax(1, keepdim=True) - TILE_SLACK) & (iou > 0.5)
        lab = lab_p[sl]
        val = torch.where(lab[:, None] >= 1, csv[:, lab.clamp(min=0)].T, csv[:, :1].T)
        cost = torch.where(near, (val - fs_p[sl, None]).abs(), torch.full_like(iou, float("inf")))
        i = cost.argmin(1)
        v = iou.gather(1, i[:, None])[:, 0]
        arg[sl] = torch.where(near.any(1), cand[i], torch.full_like(i, -1))
        copies.append(cand[near.nonzero(as_tuple=True)[1]])
    return arg, torch.cat(copies)


def _low_final(h, sv: Tensor) -> Tensor:
    """The lowest final score rounding can give a detection: its score
    under any label rounding can give it (a class within ``LABEL_SLACK`` of
    its best class score and of the threshold or above; −100, which scores
    the objectness, where the best class is within ``LABEL_SLACK`` of the
    threshold or below it)."""
    conf = h["conf_thres"]
    obj, cls = sv[:, 0], sv[:, 1:]
    best = cls.amax(1)
    ok = (cls >= best[:, None] - LABEL_SLACK) & (cls > conf - LABEL_SLACK)
    low = torch.where(ok, cls, torch.full_like(cls, float("inf"))).amin(1)
    return torch.where(best < conf + LABEL_SLACK, torch.minimum(low, obj), low)


def _overlap(boxes: Tensor, labels: Optional[Tensor], thr: float) -> float:
    """How far the largest IoU of two served boxes (of one label, where
    labels are given) passes ``thr`` (0 where none does)."""
    worst = 0.0
    n = boxes.shape[0]
    for sl in _chunks(n, 512):
        iou = pp.box_iou(boxes[sl], boxes)
        rows = torch.arange(sl.start, sl.stop, device=boxes.device)
        iou[torch.arange(iou.shape[0], device=boxes.device), rows] = 0.0
        if labels is not None:
            iou = torch.where(labels[sl, None] == labels[None, :], iou, torch.zeros_like(iou))
        if iou.numel():
            worst = max(worst, float(iou.max()) - thr)
    return max(0.0, worst)


def _label_value(h, sv_row: Tensor, label: Tensor) -> Tensor:
    """The reference score behind a label: its class score, or the
    threshold for −100 (not confident)."""
    cls = sv_row.gather(-1, label.clamp(min=0)[:, None])[:, 0]
    return torch.where(label >= 1, cls, torch.full_like(cls, h["conf_thres"]))


def _score_gaps(h, a: Tensor, ref_sv: Tensor, ref_label: Tensor, ref_final: Tensor,
                fs_p: Tensor, lab_p: Tensor, sv_p: Optional[Tensor], dup: bool = True) -> Tensor:
    ok = a >= 0
    ai = a.clamp(min=0)
    svr = ref_sv[ai]
    gap = torch.zeros_like(fs_p)
    if sv_p is not None:
        gap = torch.maximum(gap, (sv_p - svr).abs().amax(-1))
    served_val = torch.where(lab_p >= 1, svr.gather(-1, lab_p.clamp(min=0)[:, None])[:, 0],
                             svr[:, 0])
    gap = torch.maximum(gap, (fs_p - served_val).abs())
    label_gap = (_label_value(h, svr, ref_label[ai]) - _label_value(h, svr, lab_p)).clamp(min=0)
    gap = torch.maximum(gap, label_gap)
    gap = torch.where(ok, gap, torch.ones_like(gap))
    if dup and ok.any():
        twice = torch.bincount(ai[ok], minlength=ref_sv.shape[0])[ai] > 1
        gap = torch.where(ok & twice, torch.ones_like(gap), gap)
    return gap


def _mask_rule_packed(valid, scores, labels, mask_idx, R, budget):
    """The packed branch's rule: the top ``budget`` mask-eligible slots of
    the batch by final score (ties to the lower flat slot), score > 0."""
    B = valid.shape[0]
    eligible = valid[:, :R] & (mask_idx[labels[:, :R].clamp(0, mask_idx.numel() - 1)] >= 0)
    flat = torch.where(eligible, scores[:, :R], torch.zeros_like(scores[:, :R])).reshape(-1)
    K = min(int(budget), flat.numel())
    top_s, top_i = torch.sort(flat, descending=True, stable=True)
    chosen = torch.zeros_like(flat, dtype=torch.bool)
    chosen[top_i[:K]] = top_s[:K] > 0
    return chosen.reshape(B, R) & eligible


@torch.no_grad()
def judge_tiles(ref: RefTiles, out: Dict[str, Tensor], mask_budget: Optional[int],
                window: int, prec: Prec = F32) -> Dict[str, float]:
    """The served outputs of one batch (``Detector.tiles``' task dict)
    against the reference.  Returns the numbers and a few counts."""
    h = ref.h
    dev = ref.dense["boxes"].device
    out = {k: v.to(dev) for k, v in out.items()}
    valid = out["valid"].bool()
    B = valid.shape[0]
    nums = {"box_gap": 0.0, "score_gap": 0.0, "overlap": 0.0}
    served = 0
    anchors_p = torch.full(valid.shape, -1, dtype=torch.int64, device=dev)
    for b in range(B):
        idx = valid[b].nonzero(as_tuple=True)[0]
        served += idx.numel()
        boxes_r, obj_r = ref.dense["boxes"][b], ref.dense["obj"][b]
        bp = out["boxes"][b, idx].float()
        a, iou = _match(bp, boxes_r, torch.ones_like(obj_r, dtype=torch.bool),
                        out["levels"][b, idx].long(), ref.dense["level"])
        anchors_p[b, idx] = a
        nums["overlap"] = max(nums["overlap"], _overlap(bp, None, h["iou_thres"]))
        if idx.numel():
            nums["box_gap"] = max(nums["box_gap"], float((1 - iou).max()))
            g = _score_gaps(h, a, ref.sv[b], ref.label[b], ref.final[b],
                            out["scores"][b, idx].float(), out["labels"][b, idx].long(),
                            out["score_vector"][b, idx].float())
            nums["score_gap"] = max(nums["score_gap"], float(g.max()))
        # detections the reference keeps and the batch does not serve
        kept = ref.nms["anchor"][b]
        kept = kept[kept >= 0]
        found = torch.zeros(obj_r.shape[0], dtype=torch.bool, device=dev)
        found[a[a >= 0]] = True
        miss = kept[~found[kept]]
        if miss.numel():
            excuse = torch.full((miss.numel(),), max(h["conf_thres"], float(ref.nms["topk_obj"][b])),
                                device=dev)
            if idx.numel() >= h["max_det"]:
                excuse.fill_(max(float(excuse[0]), float(obj_r[a.clamp(min=0)].min())))
            if idx.numel():
                ov = pp.box_iou(boxes_r[miss], boxes_r[a.clamp(min=0)]) > h["iou_thres"] - IOU_SLACK
                sup = torch.where(ov & (a >= 0)[None, :], obj_r[a.clamp(min=0)][None, :],
                                  torch.zeros_like(ov, dtype=obj_r.dtype)).amax(1)
                excuse = torch.maximum(excuse, sup)
            mb = boxes_r[miss]
            small = ((mb[:, 2] - mb[:, 0]).minimum(mb[:, 3] - mb[:, 1])) < pp.MIN_BOX + 0.1
            g = torch.where(small, torch.zeros_like(excuse), obj_r[miss] - excuse)
            nums["score_gap"] = max(nums["score_gap"], float(g.max().clamp(min=0)))
    counts = {"served": served, "reference_kept": int((ref.nms["anchor"] >= 0).sum())}
    if "masks" in out and ref.seg is not None:
        nums.update(_judge_tile_masks(ref, out, valid, mask_budget, window, prec, counts))
    return {**nums, **{f"n_{k}": v for k, v in counts.items()}}


def _judge_tile_masks(ref, out, valid, mask_budget, window, prec, counts):
    h = ref.h
    dev = valid.device
    masks, mv = out["masks"].float(), out["mask_valid"].bool()
    B, R = mv.shape
    mask_idx = torch.tensor(h["mask_idx"], device=dev)
    labels = out["labels"].long()
    if mask_budget:
        rule = _mask_rule_packed(valid, out["scores"].float(), labels, mask_idx, R, mask_budget)
    else:
        rule = valid[:, :R] & (mask_idx[labels[:, :R].clamp(0, h["nc"])] >= 0)
    b_idx, r_idx = mv.nonzero(as_tuple=True)
    ch = mask_idx[labels[b_idx, r_idx].clamp(0, h["nc"])].clamp(min=0)
    want = pp.mask_probs(ref.det, ref.seg, out["boxes"][b_idx, r_idx].float(),
                         out["levels"][b_idx, r_idx].long(), b_idx, ch, window, prec)
    gap = float((masks[b_idx, r_idx] - want).abs().max()) if b_idx.numel() else 0.0
    stray = masks[~mv]
    gap = max(gap, float(stray.abs().max()) if stray.numel() else 0.0)
    counts["masks"] = int(b_idx.numel())
    return {"mask_gap": gap, "mask_set": float((rule != mv).sum())}


# ------------------------------------------------------------------- slide
class RefSlide:
    """The reference's whole slide: the tile grid, each tile's dense decode
    and finals, the stitch with its caps, and the rows that keep a mask."""

    @torch.no_grad()
    def __init__(self, model: Model, tag: str, slide: Tensor, s: dict, topk: int,
                 prec: Prec = F32, block: int = 8):
        tile = s["tile"]
        H, W = slide.shape[:2]
        self.H, self.W = H, W
        dev = slide.device
        origins = pp.tile_grid(H, W, tile, s["overlap"])
        self.origins = torch.as_tensor(origins, device=dev)
        n = len(origins)
        parts: Dict[str, List[Tensor]] = {}
        self.seg: List[List[Tensor]] = []
        for sl in _chunks(n, block):
            ob = self.origins[sl]
            ar = torch.arange(tile, device=dev)
            tiles = slide[(ob[:, 0, None] + ar)[:, :, None], (ob[:, 1, None] + ar)[:, None, :]]
            r = RefTiles(model, tag, tiles, topk, prec)
            shift = ob[:, [1, 0, 1, 0]].float()[:, None, :]
            for k, v in (("boxes", r.dense["boxes"] + shift), ("obj", r.dense["obj"]),
                         ("sv", r.sv), ("label", r.label), ("final", r.final),
                         ("anchor", r.nms["anchor"]), ("topk_obj", r.nms["topk_obj"])):
                parts.setdefault(k, []).append(v)
            if r.seg is not None:
                self.seg.append(r.seg)
            self.det, self.h = r.det, r.h
            self.level = r.dense["level"]
        cat = {k: torch.cat(v) for k, v in parts.items()}
        self.boxes, self.obj, self.sv = cat["boxes"], cat["obj"], cat["sv"]
        self.label, self.final, self.topk_obj = cat["label"], cat["final"], cat["topk_obj"]
        self.A = self.obj.shape[1]
        self.block = block
        h = self.h
        # each tile's finals, in slot (objectness) order, as flat anchor ids
        anchor = cat["anchor"]
        t_idx, slot = (anchor >= 0).nonzero(as_tuple=True)
        fid = t_idx * self.A + anchor[t_idx, slot]
        boxes, scores = self.boxes.reshape(-1, 4)[fid], self.final.reshape(-1)[fid]
        labels = self.label.reshape(-1)[fid]
        b_y, b_x = pp.band_widths(origins, tile, s["overlap"], s["band_margin"])
        band = pp.band_flags(boxes, self.origins[t_idx], H, W, tile, b_y, b_x)
        kb = min(s["max_band"], fid.numel())
        band_score = torch.where(band, scores, torch.full_like(scores, -1.0))
        selb = torch.sort(band_score, descending=True, stable=True).indices[:kb]
        selb = selb[band[selb]]
        keep_b = pp.class_nms(boxes[selb], scores[selb], labels[selb].clamp(min=0),
                              h["iou_thres"])
        kept = ~band
        kept[selb[keep_b]] = True
        self.band_cap = float(band_score[selb].min()) if int(band.sum()) > kb else -1.0
        K = min(s["max_total"], fid.numel())
        order = torch.sort(torch.where(kept, scores, torch.full_like(scores, -1.0)),
                           descending=True, stable=True).indices[:K]
        order = order[kept[order]]
        self.total_cap = float(scores[order].min()) if int(kept.sum()) > K else -1.0
        self.kept_fid = fid[order]
        self.kept_interior = fid[order][~band[order]]
        self.n_band = int(band.sum())
        # mask rows: a tile's first max_masks slots with a mask channel, then
        # the slide's top mask_rows of those by score
        mask_idx = torch.tensor(h["mask_idx"], device=dev)
        mvalid = (slot[order] < s["max_masks"]) & (mask_idx[labels[order].clamp(0, h["nc"])] >= 0)
        self.n_mask_eligible = int(mvalid.sum())

    def tile_feats(self, t: int) -> List[Tensor]:
        blk = self.seg[t // self.block]
        return [f[t % self.block: t % self.block + 1] for f in blk]


@torch.no_grad()
def judge_slide(ref: RefSlide, out: Dict[str, np.ndarray], s: dict, window: int,
                prec: Prec = F32) -> Dict[str, float]:
    """The served slide (``Detector.slide``'s record: boxes, scores, labels,
    masks, has_mask) against the reference."""
    h = ref.h
    dev = ref.boxes.device
    bp = torch.as_tensor(out["boxes"], device=dev).float()
    fs_p = torch.as_tensor(out["scores"], device=dev).float()
    lab_p = torch.as_tensor(out["labels"], device=dev).long()
    flat_boxes = ref.boxes.reshape(-1, 4)
    flat_obj, flat_final = ref.obj.reshape(-1), ref.final.reshape(-1)
    near = flat_obj > NEAR * h["conf_thres"]
    # Detector.slide clips its boxes to the slide: match clipped to clipped,
    # then judge the rest on the box as it was, the reference's coordinate
    # where the served one was clipped
    lim = torch.tensor([ref.W, ref.H, ref.W, ref.H], dtype=torch.float32, device=dev)
    _, iou = _match(bp, torch.minimum(flat_boxes, lim), near)
    a, copies = _match_slide(bp, torch.minimum(flat_boxes, lim), near, fs_p, lab_p,
                             ref.sv.reshape(-1, ref.sv.shape[-1]))
    clipped = (bp >= lim - 1e-3) & (a >= 0)[:, None]
    bp = torch.where(clipped, flat_boxes[a.clamp(min=0)], bp)
    nums = {"box_gap": float((1 - iou).max()) if bp.shape[0] else 0.0,
            "overlap": _overlap(bp, lab_p.clamp(min=0), h["iou_thres"])}
    # (two tiles' copies of one nucleus may match one anchor; a served row
    # twice is caught by ``overlap``)
    flat_sv = ref.sv.reshape(-1, ref.sv.shape[-1])
    g = _score_gaps(h, a, flat_sv, ref.label.reshape(-1), flat_final, fs_p, lab_p, None,
                    dup=False)
    nums["score_gap"] = float(g.max()) if g.numel() else 0.0
    found = torch.zeros(flat_obj.shape[0], dtype=torch.bool, device=dev)
    found[copies] = True              # any tile's copy of a served nucleus
    miss = ref.kept_interior[~found[ref.kept_interior]]
    if miss.numel():
        ai = a.clamp(min=0)
        tile_of = miss // ref.A
        e_obj = torch.clamp(ref.topk_obj[tile_of], min=h["conf_thres"])
        e_fs = torch.full_like(e_obj, max(ref.band_cap, ref.total_cap))
        if a.numel():
            ov = (pp.box_iou(flat_boxes[miss], flat_boxes[ai]) > h["iou_thres"] - IOU_SLACK) \
                & (a >= 0)[None, :]
            zero = torch.zeros_like(ov, dtype=flat_obj.dtype)
            e_obj = torch.maximum(e_obj, torch.where(ov, flat_obj[ai][None, :], zero).amax(1))
            served_val = torch.where(lab_p >= 1, flat_sv[ai].gather(
                1, lab_p.clamp(min=0)[:, None])[:, 0], flat_obj[ai])
            e_fs = torch.maximum(e_fs, torch.where(ov, served_val[None, :], zero).amax(1))
        mb = flat_boxes[miss]
        small = ((mb[:, 2] - mb[:, 0]).minimum(mb[:, 3] - mb[:, 1])) < pp.MIN_BOX + 0.1
        gap = torch.minimum(flat_obj[miss] - e_obj, _low_final(h, flat_sv[miss]) - e_fs)
        gap = torch.where(small, torch.zeros_like(gap), gap)
        nums["score_gap"] = max(nums["score_gap"], float(gap.max().clamp(min=0)))
    counts = {"served": int(bp.shape[0]), "reference_kept": int(ref.kept_fid.numel()),
              "band": ref.n_band, "mask_eligible": ref.n_mask_eligible}
    if "masks" in out and ref.seg:
        has = torch.as_tensor(out["has_mask"], device=dev).bool()
        mask_idx = torch.tensor(h["mask_idx"], device=dev)
        elig = mask_idx[lab_p.clamp(0, h["nc"])] >= 0
        prio = torch.where(elig, fs_p, torch.full_like(fs_p, -1.0))
        top = torch.sort(prio, descending=True, stable=True).indices[:s["mask_rows"]]
        rule = torch.zeros_like(has)
        rule[top] = elig[top]
        nums["mask_set"] = float((rule != has).sum())
        m_p = torch.as_tensor(out["masks"], device=dev).float()
        gap = float(m_p[~has].abs().max()) if (~has).any() else 0.0
        # a nucleus in an overlap band is seen by two or more tiles at near
        # the same box: judge its mask on each such tile and keep the closest
        # (a box clipped to the slide is judged by its box and score only: its
        # mask was pooled at the box as it was, which the row no longer holds)
        rows = (has & ~clipped.any(1)).nonzero(as_tuple=True)[0]
        cand = near.nonzero(as_tuple=True)[0]
        pair_row, pair_anchor = [], []
        for sl in _chunks(rows.numel(), 256):
            iou = pp.box_iou(bp[rows[sl]], flat_boxes[cand])
            r, c = (iou >= iou.amax(1, keepdim=True) - TILE_SLACK).nonzero(as_tuple=True)
            pair_row.append(rows[sl][r])
            pair_anchor.append(cand[c])
        pair_row, pair_anchor = torch.cat(pair_row), torch.cat(pair_anchor)
        pair_gap = torch.full(pair_row.shape, float("inf"), device=dev)
        tiles = pair_anchor // ref.A
        for t in torch.unique(tiles).tolist():
            sel = (tiles == t).nonzero(as_tuple=True)[0]
            rs = pair_row[sel]
            org = ref.origins[t][[1, 0, 1, 0]].float()
            ch = mask_idx[lab_p[rs].clamp(0, h["nc"])].clamp(min=0)
            want = pp.mask_probs(ref.det, ref.tile_feats(t), bp[rs] - org,
                                 ref.level[pair_anchor[sel] % ref.A], torch.zeros_like(rs), ch,
                                 window, prec)
            pair_gap[sel] = (m_p[rs] - want).abs().amax((1, 2))
        best = torch.full((m_p.shape[0],), float("inf"), device=dev).scatter_reduce(
            0, pair_row, pair_gap, "amin")[rows]
        if best.numel():
            gap = max(gap, float(best.max()))
        nums["mask_gap"] = gap
        counts["masks"] = int(rows.numel())
    return {**nums, **{f"n_{k}": v for k, v in counts.items()}}
