"""The plain reference of what follows the trunk: yolov5's sigmoid decode,
the per-image objectness NMS with its caps, hd_yolo's hierarchical scores
and labels, the windowed multi-level ROI-align and the mask head with its
per-ROI channel, and the slide's tile grid and class-aware stitch.  Plain
PyTorch in the caller's dtype (float32), written from the published
semantics; nothing of the system under test is imported.

Semantics (hd_yolo's, as the configurations run them):
  * decode: ``xy = (2σ(t) − 0.5 + cell) · stride``, ``wh = (2σ(t))² · anchor``;
    score columns ``σ``;
  * candidates: objectness ``> conf_thres`` and both box sides ``>= 2`` px;
    the ``pre_nms_topk`` best by objectness (ties to the lower anchor
    index); greedy NMS by objectness, a box suppressed by an earlier kept
    one at IoU ``> iou_thres``; the first ``max_det`` kept;
  * scores: each class score times the objectness (the default hierarchy:
    objectness → classes); the label is the best class where its score
    ``> conf_thres`` (score that class score), else −100 (score the
    objectness);
  * ROI-align: torchvision's ``aligned=False`` sampling (2 x 2 samples a
    bin, bins of a 14 x 14 grid) on the detection's own level, each tap
    outside a ``window x window`` patch of the level-stacked canvas (its
    origin the floor of the first sample, clamped to the canvas) read as 0;
  * masks: the mask head's sigmoid in the channel the label maps to.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .model import F32, Prec

Tensor = torch.Tensor
MIN_BOX = 2.0


def box_iou(a: Tensor, b: Tensor) -> Tensor:
    """(..., N, 4) x (..., M, 4) xyxy → (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter).clamp(min=1e-12)


def decode(h: dict, logits: Sequence[Tensor]) -> Dict[str, Tensor]:
    """Per-level (B, ny, nx, na, 5 + nc) logits → every anchor of every
    level, flattened level by level: boxes (B, A, 4) xyxy, obj (B, A),
    cls (B, A, nc) raw class probabilities, level (A,)."""
    boxes, obj, cls, lvl = [], [], [], []
    for i, (d, s) in enumerate(zip(logits, h["strides"])):
        B, ny, nx, na, _ = d.shape
        y = d.float().sigmoid()
        gy, gx = torch.meshgrid(torch.arange(ny, device=d.device, dtype=torch.float32),
                                torch.arange(nx, device=d.device, dtype=torch.float32),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
        anchor = torch.tensor(h["anchors"][i], dtype=torch.float32,
                              device=d.device).reshape(na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * s
        wh = (y[..., 2:4] * 2.0) ** 2 * anchor
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(B, -1, 4))
        obj.append(y[..., 4].reshape(B, -1))
        cls.append(y[..., 5:].reshape(B, ny * nx * na, -1))
        lvl.append(torch.full((ny * nx * na,), i, dtype=torch.int64, device=d.device))
    return {"boxes": torch.cat(boxes, 1), "obj": torch.cat(obj, 1), "cls": torch.cat(cls, 1),
            "level": torch.cat(lvl)}


def score_vectors(h: dict, obj: Tensor, cls: Tensor) -> Tensor:
    """(..., 1 + nc): the objectness, then each class scaled top-down by
    its parent's (already scaled) score along the header's hierarchy."""
    sv = torch.cat([obj[..., None], cls], -1)
    rows = h["hierarchy"] or [(0, list(range(1, h["nc"] + 1)))]
    for parent, children in rows:
        idx = torch.tensor(children, device=sv.device)
        sv[..., idx] = sv[..., idx] * sv[..., parent:parent + 1]
    return sv


def labels_and_scores(h: dict, sv: Tensor) -> Tuple[Tensor, Tensor]:
    """Final (label, score) of score vectors (..., 1 + nc)."""
    best, arg = sv[..., 1:].max(-1)
    ok = best > h["conf_thres"]
    return torch.where(ok, arg + 1, torch.full_like(arg, -100)), torch.where(ok, best, sv[..., 0])


def candidates(h: dict, dense: Dict[str, Tensor]) -> Tensor:
    """(B, A) bool: anchors that pass the objectness and size tests."""
    b = dense["boxes"]
    big = ((b[..., 2] - b[..., 0]) >= MIN_BOX) & ((b[..., 3] - b[..., 1]) >= MIN_BOX)
    return big & (dense["obj"] > h["conf_thres"])


def greedy_nms(boxes: Tensor, valid: Tensor, thr: float) -> Tensor:
    """Keep mask of greedy NMS over (B, K, 4) boxes already in rank order."""
    K = boxes.shape[1]
    conflict = (box_iou(boxes, boxes) > thr) & valid[:, :, None] & valid[:, None, :]
    conflict &= torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    removed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(K):
        k = ~removed[:, i]
        keep[:, i] = k
        removed = removed | (conflict[:, i, :] & k[:, None])
    return keep


def per_image_nms(h: dict, dense: Dict[str, Tensor], topk: int) -> Dict[str, Tensor]:
    """Each image's kept anchors → ``anchor`` (B, max_det) indices into the
    dense anchors (−1 past the kept ones), ``n_cand`` (B,) candidates, and
    ``topk_obj`` (B,) the lowest objectness the top-k admitted (the
    threshold where the cap did not bind)."""
    ok = candidates(h, dense)
    masked = torch.where(ok, dense["obj"], torch.full_like(dense["obj"], -1.0))
    K = min(topk, masked.shape[1])
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :K]
    sobj = torch.gather(masked, 1, order)
    sval = sobj > 0
    sbox = torch.gather(dense["boxes"], 1, order[..., None].expand(-1, -1, 4))
    keep = greedy_nms(sbox, sval, h["iou_thres"])
    D = h["max_det"]
    rank = torch.cumsum(keep.long(), 1) - 1
    keep &= rank < D
    anchor = torch.full((keep.shape[0], D), -1, dtype=torch.int64, device=keep.device)
    rows, cols = keep.nonzero(as_tuple=True)
    anchor[rows, rank[rows, cols]] = order[rows, cols]
    n_cand = ok.sum(1)
    topk_obj = torch.where(n_cand > K, sobj[:, -1], torch.full_like(sobj[:, -1], h["conf_thres"]))
    return {"anchor": anchor, "n_cand": n_cand, "topk_obj": topk_obj}


# ------------------------------------------------------------------- masks
def roi_align_window(feats: Sequence[Tensor], boxes: Tensor, levels: Tensor, b_idx: Tensor,
                     strides: Sequence[float], window: int, M: int = 14,
                     n: int = 2) -> Tensor:
    """(K,) ROIs → (K, C, M, M) pooled features (see the module docstring).
    ``feats``: per level (B, C, H, W).  Taps read the level maps directly."""
    dev = boxes.device
    Hs = [f.shape[2] for f in feats]
    W0 = feats[0].shape[3]
    offs = np.cumsum([0] + Hs[:-1]).tolist()
    Ht = sum(Hs)
    win = min(window, Ht, W0)
    moff = torch.tensor(offs, dtype=torch.float32, device=dev)[levels]
    mh = torch.tensor(Hs, dtype=torch.float32, device=dev)[levels]
    mw = torch.tensor([f.shape[3] for f in feats], dtype=torch.float32, device=dev)[levels]
    scale = 1.0 / torch.tensor(strides, dtype=torch.float32, device=dev)[levels]
    x1, y1 = boxes[:, 0] * scale, boxes[:, 1] * scale
    rw = (boxes[:, 2] * scale - x1).clamp(min=1.0)
    rh = (boxes[:, 3] * scale - y1).clamp(min=1.0)
    S = M * n
    s = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
    ys = y1[:, None] + s * (rh / S)[:, None] + moff[:, None]        # canvas rows
    xs = x1[:, None] + s * (rw / S)[:, None]
    oy = torch.floor(ys[:, 0]).clamp(0, Ht - win)
    ox = torch.floor(xs[:, 0]).clamp(0, W0 - win)

    def taps(c, lo, hi, origin):
        """(K, S) coords → (K, S, 2) integer taps and weights, zero outside
        [lo − 1, hi), clamped to [lo, hi − 1], zero outside the window."""
        inr = ((c > lo[:, None] - 1.0) & (c < hi[:, None])).float()
        cc = torch.minimum(torch.maximum(c, lo[:, None]), hi[:, None] - 1.0)
        low = torch.floor(cc)
        lw = cc - low
        high = torch.minimum(low + 1.0, hi[:, None] - 1.0)
        idx = torch.stack([low, high], -1)
        w = torch.stack([(1.0 - lw) * inr, lw * inr], -1)
        rel = idx - origin[:, None, None]
        w = torch.where((rel >= 0) & (rel < win), w, torch.zeros_like(w))
        return idx.long(), w

    yi, yw = taps(ys, moff, moff + mh, oy)
    xi, xw = taps(xs, torch.zeros_like(mw), mw, ox)
    C = feats[0].shape[1]
    out = torch.zeros((boxes.shape[0], C, M, M), dtype=feats[0].dtype, device=dev)
    for l, f in enumerate(feats):
        sel = (levels == l).nonzero(as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        k = sel.numel()
        ry = (yi[sel] - offs[l]).clamp(0, f.shape[2] - 1).reshape(k, S * 2)
        rx = xi[sel].clamp(0, f.shape[3] - 1).reshape(k, S * 2)
        nhwc = f.permute(0, 2, 3, 1)
        vals = nhwc[b_idx[sel][:, None, None], ry[:, :, None], rx[:, None, :]]  # (k, 2S, 2S, C)
        v = vals * yw[sel].reshape(k, S * 2, 1, 1) * xw[sel].reshape(k, 1, S * 2, 1)
        v = v.reshape(k, M, n * 2, M, n * 2, C).sum((2, 4)) / (n * n)
        out[sel] = v.permute(0, 3, 1, 2)
    return out


def mask_probs(det, feats: Sequence[Tensor], boxes: Tensor, levels: Tensor, b_idx: Tensor,
               mask_ch: Tensor, window: int, prec: Prec = F32, block: int = 128) -> Tensor:
    """(K,) ROIs → (K, 28, 28) mask probabilities in each ROI's channel,
    computed ``block`` ROIs at a time."""
    out = []
    for i in range(0, boxes.shape[0], block):
        sl = slice(i, i + block)
        pooled = roi_align_window(feats, boxes[sl], levels[sl], b_idx[sl], det.h["strides"],
                                  window)
        logits = det.seg_h(pooled, prec)
        ch = mask_ch[sl]
        out.append(torch.sigmoid(logits[torch.arange(ch.shape[0], device=ch.device), ch]))
    if not out:
        return torch.zeros((0, 28, 28), device=boxes.device)
    return torch.cat(out)


# ------------------------------------------------------------------- slide
def tile_grid(h: int, w: int, tile: int, overlap: int) -> np.ndarray:
    """(N, 2) (y, x) tile origins: stride ``tile − overlap``, the last row
    and column moved inward so that no tile crosses the border."""
    stride = tile - overlap

    def starts(size):
        if size <= tile:
            return [0]
        s = list(range(0, size - tile, stride))
        return s + [size - tile]

    return np.asarray([(y, x) for y in starts(h) for x in starts(w)], np.int64)


def band_flags(boxes: Tensor, origin: Tensor, H: int, W: int, tile: int,
               b_y: float, b_x: float) -> Tensor:
    """(N,) bool: the box reaches into a band shared with a neighbouring
    tile (it is not inside its tile shrunk by the band on every edge that
    has a neighbour)."""
    y0, x0 = origin[:, 0].float(), origin[:, 1].float()
    lo_y = y0 + torch.where(y0 > 0, b_y, 0.0)
    hi_y = y0 + tile - torch.where(y0 + tile < H, b_y, 0.0)
    lo_x = x0 + torch.where(x0 > 0, b_x, 0.0)
    hi_x = x0 + tile - torch.where(x0 + tile < W, b_x, 0.0)
    inside = ((boxes[:, 0] >= lo_x) & (boxes[:, 2] <= hi_x)
              & (boxes[:, 1] >= lo_y) & (boxes[:, 3] <= hi_y))
    return ~inside


def band_widths(origins: np.ndarray, tile: int, overlap: int, margin: int) -> Tuple[float, float]:
    """Per axis ``max(overlap, tile − smallest origin step) + margin``."""
    out = []
    for ax in (0, 1):
        vs = np.unique(origins[:, ax])
        d = int(np.diff(vs).min()) if len(vs) > 1 else tile
        out.append(float(max(overlap, tile - d) + margin))
    return out[0], out[1]


def class_nms(boxes: Tensor, scores: Tensor, labels: Tensor, thr: float) -> Tensor:
    """Keep mask of a class-aware greedy NMS over (K, 4) boxes by score
    (ties to the lower index): only boxes of one label suppress each other."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b, l = boxes[order], labels[order]
    keep_sorted = greedy_nms_same_label(b, l, thr)
    keep = torch.zeros_like(keep_sorted)
    keep[order] = keep_sorted
    return keep


def greedy_nms_same_label(boxes: Tensor, labels: Tensor, thr: float) -> Tensor:
    K = boxes.shape[0]
    keep = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    removed = torch.zeros(K, dtype=torch.bool, device=boxes.device)
    if K == 0:
        return keep
    conflict = (box_iou(boxes, boxes) > thr) & (labels[:, None] == labels[None, :])
    conflict &= torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    for i in range(K):
        k = ~removed[i]
        keep[i] = k
        removed = removed | (conflict[i] & k)
    return keep
