"""Detection metrics — streaming mAP, confusion matrix, NuCLS summaries
(a copy of ``hd_yolo_tpu/models/metrics.py``, numpy only).

Host-side numpy: the model emits padded detection arrays, the meter
consumes the valid slots.  101-point interpolated AP, per-class PR curves
with the max-F1 operating point, an IoU-matched confusion matrix, and the
streaming meter's ignore-class semantics: predictions whose only candidates
are unlabeled (−100) / ignored (−1) GT are excluded from the PR curves.
One greedy one-to-one resolver (``resolve_one_to_one``) serves the meter
and the confusion matrix; the meter keeps per-image records and resolves
at summary time.  ``tests/test_torch_metrics.py`` holds every public
function to exact equality with the JAX package's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- ap
def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP (COCO style).

    The precision envelope is made monotone non-increasing from the right,
    sampled on a 101-point recall grid, and integrated.
    """
    r_env = np.concatenate(([0.0], recall, [1.0]))
    p_env = np.concatenate(([1.0], precision, [0.0]))
    p_env = np.flip(np.maximum.accumulate(np.flip(p_env)))
    grid = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(grid, r_env, p_env), grid)
    return ap, p_env, r_env


_CURVE_POINTS = 1000


def _class_curves(hit: np.ndarray, conf_sorted: np.ndarray, n_gt: int):
    """Precision/recall for ONE class from score-desc-sorted prediction rows.

    hit: (n, n_iouv) bool TP flags.  Returns (p_curve, r_curve) sampled on a
    descending-confidence grid of _CURVE_POINTS plus the raw cumulative
    (recall, precision) columns for AP integration.
    """
    grid = np.linspace(0, 1, _CURVE_POINTS)
    tp_cum = hit.cumsum(0)
    fp_cum = (~hit.astype(bool)).cumsum(0)
    recall = tp_cum / max(n_gt, 1e-16)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-16)
    # sample at descending confidence: np.interp needs ascending x → negate
    r_curve = np.interp(-grid, -conf_sorted, recall[:, 0], left=0)
    p_curve = np.interp(-grid, -conf_sorted, precision[:, 0], left=1)
    return p_curve, r_curve, recall, precision


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16):
    """Per-class AP matrix + the max-mean-F1 operating point.

    tp: (n, n_iouv) bool; conf: (n,); pred_cls: (n,); target_cls: (m,).
    Returns (tp, fp, p, r, f1, ap, unique_classes) at the chosen point.
    """
    order = np.argsort(-conf, kind="stable")
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, n_gt_per_class = np.unique(target_cls, return_counts=True)

    n_iouv = tp.shape[1]
    ap = np.zeros((len(classes), n_iouv))
    p = np.zeros((len(classes), _CURVE_POINTS))
    r = np.zeros((len(classes), _CURVE_POINTS))
    for ci, (c, n_gt) in enumerate(zip(classes, n_gt_per_class)):
        rows = pred_cls == c
        if n_gt == 0 or not rows.any():
            continue
        p[ci], r[ci], recall, precision = _class_curves(tp[rows], conf[rows], n_gt)
        for j in range(n_iouv):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])[0]

    f1 = 2 * p * r / (p + r + eps)
    best = f1.mean(0).argmax()
    p, r, f1 = p[:, best], r[:, best], f1[:, best]
    tp_count = (r * n_gt_per_class).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1, ap, classes.astype("int32")


# ------------------------------------------------------------------- matching
class MatchResult(NamedTuple):
    pred_idx: np.ndarray   # (k,) matched prediction rows
    gt_idx: np.ndarray     # (k,) their GT partners
    iou: np.ndarray        # (k,) pair IoUs


def resolve_one_to_one(
    pair_pred: np.ndarray,
    pair_gt: np.ndarray,
    pair_iou: np.ndarray,
    n_pred: int,
    gt_winner: str = "rank",
) -> MatchResult:
    """Greedy 1:1 resolution of candidate (pred, gt, iou) pairs.

    Stage 1 — every prediction proposes to its highest-IoU candidate GT.
    Stage 2 — every GT accepts one claimant: its lowest-index (= highest
    ranked, for score-sorted predictions) claimant when ``gt_winner='rank'``,
    or its highest-IoU claimant when ``gt_winner='iou'``.
    """
    if len(pair_pred) == 0:
        z = np.zeros(0, np.int64)
        return MatchResult(z, z, np.zeros(0, np.float64))

    # stage 1: per-pred best IoU (ties → the pair listed first, i.e. lowest gt)
    best_iou = np.full(n_pred, -1.0)
    best_gt = np.full(n_pred, -1, np.int64)
    for p, g, v in zip(pair_pred, pair_gt, pair_iou):
        if v > best_iou[p]:
            best_iou[p], best_gt[p] = v, g

    proposers = np.flatnonzero(best_gt >= 0)
    # stage 2: per-gt winner
    winner_for_gt: Dict[int, int] = {}
    if gt_winner == "rank":
        for p in proposers:  # ascending pred index = descending rank
            winner_for_gt.setdefault(int(best_gt[p]), int(p))
    else:
        for p in proposers[np.argsort(-best_iou[proposers], kind="stable")]:
            winner_for_gt.setdefault(int(best_gt[p]), int(p))

    pred_w = np.asarray(sorted(winner_for_gt.values()), np.int64)
    return MatchResult(pred_w, best_gt[pred_w], best_iou[pred_w])


# ------------------------------------------------------------------- iou utils
def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def get_mask_ious(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """(n, h, w) × (m, h, w) mask-IoU matrix (utils_nucls.py:480-490)."""
    if len(y_true) == 0 or len(y_pred) == 0:
        return np.zeros((len(y_true), len(y_pred)))
    t = y_true.reshape(len(y_true), -1).astype(np.float64)
    p = y_pred.reshape(len(y_pred), -1).astype(np.float64)
    inter = t @ p.T
    union = t.sum(1)[:, None] + p.sum(1)[None] - inter + 1e-8
    return inter / union


# --------------------------------------------------------------- ConfusionMatrix
class ConfusionMatrix:
    """IoU-matched detection confusion matrix.

    Rows = predicted class (last row = background / undetected GT), columns =
    GT class (last col = background / unmatched detection).
    """

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections (N, 6): x1,y1,x2,y2,conf,class; labels (M, 5): class,x1,y1,x2,y2."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)

        iou = box_iou_np(detections[:, :4], labels[:, 1:])  # (n_det, n_gt)
        di, gi = np.nonzero(iou > self.iou_thres)
        m = resolve_one_to_one(di, gi, iou[di, gi], len(detections), gt_winner="iou")
        det_of_gt = {int(g): int(p) for p, g in zip(m.pred_idx, m.gt_idx)}

        for g, gc in enumerate(gt_classes):
            if g in det_of_gt:
                self.matrix[det_classes[det_of_gt[g]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1  # undetected GT
        if det_of_gt:
            matched_dets = set(det_of_gt.values())
            for d, dc in enumerate(det_classes):
                if d not in matched_dets:
                    self.matrix[dc, self.nc] += 1  # detection on background

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]


# ------------------------------------------------------------------- APMeter
class _ImageRecord(NamedTuple):
    """One image's raw evaluation material, matching deferred to summary."""

    scores: np.ndarray       # (n_pred,) score-descending
    pred_labels: np.ndarray  # (n_pred,)
    gt_labels: np.ndarray    # (n_gt,)
    pair_pred: np.ndarray    # (k,) candidate pairs with IoU ≥ candidate thresh
    pair_gt: np.ndarray      # (k,)
    pair_iou: np.ndarray     # (k,)


class APMeter:
    """Streaming mAP@[.5:.95] accumulator with ignore-class semantics.

    ``add`` stores one :class:`_ImageRecord` per image: score-sorted
    predictions plus every (pred, gt) candidate pair at IoU ≥ 0.5.
    ``ap_per_class`` resolves matches per image through
    :func:`resolve_one_to_one` (rank-priority GT assignment + label-equality
    filter) and builds per-class PR/AP curves.  A prediction whose candidate
    pairs all point at ignored GT (label −100 unclassified / −1) and that
    ends up unmatched is *excluded* from the curves — the parity-critical
    behavior for NuCLS's unlabeled class.
    """

    def __init__(self, labels_text: Optional[Dict[int, str]] = None):
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.labels_text = labels_text or {}
        self.reset()

    def reset(self):
        self.images: List[_ImageRecord] = []

    # kept as properties for callers/loggers that report meter volume
    @property
    def n_pred(self) -> int:
        return sum(len(im.scores) for im in self.images)

    @property
    def n_true(self) -> int:
        return sum(len(im.gt_labels) for im in self.images)

    def add(self, output: Dict[str, np.ndarray], target: Dict[str, np.ndarray],
            iou_type: str = "boxes"):
        scores = np.asarray(output["scores"], np.float64)
        order = np.argsort(-scores, kind="stable")

        if iou_type == "masks" and "masks" in output and "masks" in target:
            iou = get_mask_ious(
                np.asarray(output["masks"])[order], np.asarray(target["masks"])
            )
        else:
            iou = box_iou_np(
                np.asarray(output["boxes"])[order], np.asarray(target["boxes"])
            )
        pi, gi = np.nonzero(iou >= self.iouv.min())
        self.images.append(_ImageRecord(
            scores=scores[order],
            pred_labels=np.asarray(output["labels"])[order].astype(np.int64),
            gt_labels=np.asarray(target["labels"]).astype(np.int64),
            pair_pred=pi.astype(np.int64),
            pair_gt=gi.astype(np.int64),
            pair_iou=iou[pi, gi].astype(np.float64),
        ))

    def _resolve_image(self, im: _ImageRecord, ignore: Sequence[int], iouv):
        """→ (tp_flags (n_pred, n_iouv), keep_pred (n_pred,) bool)."""
        n_pred = len(im.scores)
        considered = ~(
            np.isin(im.gt_labels[im.pair_gt], ignore)
            | np.isin(im.pred_labels[im.pair_pred], ignore)
        ) if len(ignore) else np.ones(len(im.pair_pred), bool)

        # gt_winner='iou' = the reference meter's resolution (metrics.py:
        # 313-321: pairs sorted by IoU desc, first-occurrence unique per pred
        # then per GT) — golden-tested in test_reference_golden.py
        m = resolve_one_to_one(
            im.pair_pred[considered], im.pair_gt[considered],
            im.pair_iou[considered], n_pred, gt_winner="iou",
        )
        same = im.gt_labels[m.gt_idx] == im.pred_labels[m.pred_idx]
        matched_pred, matched_iou = m.pred_idx[same], m.iou[same]

        tp = np.zeros((n_pred, len(iouv)), bool)
        tp[matched_pred] = matched_iou[:, None] >= iouv
        keep = np.ones(n_pred, bool)
        if len(ignore):
            had_ignored_pair = np.zeros(n_pred, bool)
            had_ignored_pair[im.pair_pred[~considered]] = True
            had_ignored_pair[matched_pred] = False
            keep &= ~had_ignored_pair
        return tp, keep

    def ap_per_class(self, iouv: Optional[np.ndarray] = None,
                     ignore: Sequence[int] = (-100, -1), eps: float = 1e-16):
        if iouv is None:
            iouv = self.iouv
        iouv = np.asarray(iouv)

        tp_rows, score_rows, label_rows, gt_rows = [], [], [], []
        for im in self.images:
            tp, keep = self._resolve_image(im, ignore, iouv)
            tp_rows.append(tp[keep])
            score_rows.append(im.scores[keep])
            label_rows.append(im.pred_labels[keep])
            gt_rows.append(im.gt_labels)

        cat = lambda xs, shape, dt: (
            np.concatenate(xs).astype(dt) if xs else np.zeros(shape, dt)
        )
        tp = cat(tp_rows, (0, len(iouv)), bool)
        scores = cat(score_rows, (0,), np.float64)
        pred_labels = cat(label_rows, (0,), np.int64)
        gt_labels = cat(gt_rows, (0,), np.int64)

        order = np.argsort(-scores, kind="stable")
        tp, scores, pred_labels = tp[order], scores[order], pred_labels[order]

        px = np.linspace(0, 1, _CURVE_POINTS)
        labels, counts = [], []
        curves = {"ap": [], "p": [], "r": [], "py": []}
        for c, n_gt in zip(*np.unique(gt_labels, return_counts=True)):
            if c in ignore:
                continue
            labels.append(int(c))
            counts.append(int(n_gt))
            rows = pred_labels == c
            if n_gt == 0 or not rows.any():
                curves["ap"].append(np.zeros(len(iouv)))
                for k in ("p", "r", "py"):
                    curves[k].append(np.zeros(len(px)))
                continue
            p_curve, r_curve, recall, precision = _class_curves(
                tp[rows], scores[rows], int(n_gt)
            )
            curves["p"].append(p_curve)
            curves["r"].append(r_curve)
            ap_c = np.zeros(len(iouv))
            for j in range(len(iouv)):
                ap_c[j], p_env, r_env = compute_ap(recall[:, j], precision[:, j])
                if j == 0:
                    curves["py"].append(np.interp(px, r_env, p_env))
            curves["ap"].append(ap_c)

        stats = {
            "labels": labels, "counts": counts, "px": px,
            **{
                k: np.stack(v) if v else np.zeros((0, len(iouv) if k == "ap" else len(px)))
                for k, v in curves.items()
            },
        }
        stats["f1"] = 2 * stats["p"] * stats["r"] / (stats["p"] + stats["r"] + eps)
        return stats


# ---------------------------------------------------------------- NuCLS extras
def evaluate_detection(target, output, classes, iou_threshold: float = 0.5,
                       iou_type: str = "boxes"):
    """Best-match P/R + per-class (n_matched, n_true, n_pred, mIoU)
    (metrics.py:411-474)."""
    if iou_type == "masks" and "masks" in output and "masks" in target:
        ious = get_mask_ious(np.asarray(target["masks"]), np.asarray(output["masks"]))
    else:
        ious = box_iou_np(np.asarray(target["boxes"]), np.asarray(output["boxes"]))
    n_true, n_pred = ious.shape
    true_label = np.asarray(target["labels"])
    pred_label = np.asarray(output["labels"])

    if n_true > 0 and n_pred > 0:
        mi, mx = ious.max(1), ious.argmax(1)
        pr = pred_label[mx].copy()
        pr[mi < iou_threshold] = -1
        recall = {"y_true": true_label, "y_pred": pr, "ious": mi}
        mi0, mx0 = ious.max(0), ious.argmax(0)
        tl = true_label[mx0].copy()
        tl[mi0 < iou_threshold] = -1
        precision = {"y_true": tl, "y_pred": pred_label, "ious": mi0}
    else:
        recall = {"y_true": true_label, "y_pred": -np.ones_like(true_label),
                  "ious": np.zeros(len(true_label))}
        precision = {"y_true": -np.ones_like(pred_label), "y_pred": pred_label,
                     "ious": np.zeros(len(pred_label))}

    stats_per_class = {}
    for c in classes:
        t_idx, o_idx = true_label == c, pred_label == c
        n1, n2 = int(t_idx.sum()), int(o_idx.sum())
        m_iou, n_matched = 0.0, 0
        if n1 > 0 and n2 > 0:
            ious_c = ious[t_idx][:, o_idx]
            mi = ious_c.max(1)
            keep = mi >= iou_threshold
            n_matched = int(keep.sum())
            if n_matched:
                m_iou = float(mi[keep].mean())
        stats_per_class[c] = [n_matched, n1, n2, m_iou]
    return precision, recall, stats_per_class


def summarize_precision_recall(stats_list, labels_text):
    """Aggregate per-image evaluate_detection stats (metrics.py:601-616)."""
    stat_sum = defaultdict(list)
    for stat in stats_list:
        for k, v in stat.items():
            stat_sum[k].append(v)
    res = {}
    for k, v in stat_sum.items():
        tmp = np.array(v)
        n_matched, n_true, n_pred = tmp[:, 0].sum(), tmp[:, 1].sum(), tmp[:, 2].sum()
        m_iou = tmp[:, 3].mean()
        precision = n_matched / n_pred if n_pred > 0 else np.nan
        recall = n_matched / n_true if n_true > 0 else np.nan
        f = 2 * precision * recall / (precision + recall) if (precision + recall) else np.nan
        res[labels_text.get(k, k)] = {
            "precision": precision, "recall": recall, "f1": f, "miou": m_iou
        }
    return res


def weighted_accuracy(y_pred, y_true, weight=None):
    """metrics.py:522-535."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    if len(y_pred) == 0:
        return 0.0
    if weight is not None:
        w = np.asarray(weight)[y_true]
        return float((w * (y_true == y_pred)).sum() / max(w.sum(), 1e-12))
    return float((y_true == y_pred).mean())


def coverage_accuracy_miou(y_true, y_pred, ious, num_classes: int = 6):
    """NuCLS coverage / class-weighted accuracy / mean IoU (metrics.py:538-557)."""
    y_true, y_pred, ious = map(np.asarray, (y_true, y_pred, ious))
    counts = [(y_true == c).sum() for c in range(1, num_classes + 1)]
    class_weights = [1.0 / c if c > 0 else 0.0 for c in counts]
    matched = y_pred != -1
    mean_iou = float(ious[matched].mean()) if matched.any() else 0.0
    coverage = float(matched.mean()) if len(y_true) else 0.0
    accuracy = weighted_accuracy(
        y_pred[matched], np.clip(y_true[matched], 0, None), [0.0] + class_weights
    )
    return coverage, accuracy, mean_iou


def matthews_corrcoef(y_true, y_pred) -> float:
    """Multi-class MCC (sklearn-compatible), implemented directly."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    idx = {c: i for i, c in enumerate(classes)}
    k = len(classes)
    C = np.zeros((k, k), np.float64)
    for t, p in zip(y_true, y_pred):
        C[idx[t], idx[p]] += 1
    t_sum = C.sum(1)
    p_sum = C.sum(0)
    n = C.sum()
    cov_tp = np.trace(C) * n - t_sum @ p_sum
    cov_tt = n * n - t_sum @ t_sum
    cov_pp = n * n - p_sum @ p_sum
    denom = np.sqrt(cov_tt * cov_pp)
    return float(cov_tp / denom) if denom else 0.0


def summarize_mcc(y_true, y_pred, core_labels=("tumor", "stromal", "sTILs")):
    """NuCLS-paper MCC table (metrics.py:619-632)."""
    res = {}
    idx = [t in core_labels for t in y_true]
    yt = [v for m, v in zip(idx, y_true) if m]
    yp = [v for m, v in zip(idx, y_pred) if m]
    res["mcc"] = matthews_corrcoef(yt, yp)
    for c in core_labels:
        res[("mcc", c)] = matthews_corrcoef([t == c for t in yt], [p == c for p in yp])
    return res


def reduce_confusion_matrix(cm, labels):
    """Fold every row/col outside ``labels`` into an 'others' bucket
    (utils_nucls.py:627-638)."""
    import pandas as pd

    if not isinstance(labels, dict):
        label_x = label_y = list(labels)
    else:
        label_x, label_y = list(labels["x"]), list(labels["y"])
    res = np.zeros([len(label_x) + 1, len(label_y) + 1])
    res[:-1, :-1] = cm.loc[label_x, label_y].values
    res[:-1, -1] = cm.drop(label_y, axis=1).loc[label_x, :].values.sum(1)
    res[-1, :-1] = cm.drop(label_x, axis=0)[label_y].sum(axis=0)
    res[-1, -1] = cm.drop(label_y, axis=1).drop(label_x, axis=0).values.sum()
    return pd.DataFrame(res, index=label_x + ["others"],
                        columns=label_y + ["others"])


def summarize_confusion_matrix(cm, labels, core_labels=("tumor", "stromal", "sTILs")):
    """NuCLS coverage/accuracy/per-class P-R-F from a labeled confusion
    matrix — the reference's exact math (utils_nucls.py:653-676,
    golden-tested): full-matrix coverage; core reduction folds everything
    outside core+missing into 'others', then drops the missing/others ROWS
    (their columns stay in the accuracy denominator)."""
    import pandas as pd

    core_labels = list(core_labels)
    cm = pd.DataFrame(cm, index=list(labels), columns=list(labels))
    coverage = 1 - cm["missing"].values.sum() / cm.values.sum()
    cm_core = reduce_confusion_matrix(cm, core_labels + ["missing"])
    cm_core = cm_core.drop("missing", axis=0).drop("others", axis=0)
    K = len(np.diag(cm_core))
    accuracy = np.diag(cm_core.values).sum() / cm_core.values.sum()
    accuracy_c = np.diag(cm_core.values).sum() / cm_core.values[:K, :K].sum()
    precision = np.diag(cm_core.values) / cm_core.values.sum(0)[:K]
    recall = np.diag(cm_core.values) / cm_core.values.sum(1)[:K]
    f = 2 * precision * recall / (precision + recall)
    return {
        "coverage": coverage, "accuracy_c": accuracy_c, "accuracy": accuracy,
        "cm": cm, "cm_core": cm_core,
        **{("precision", n): v for n, v in zip(core_labels, precision)},
        **{("recall", n): v for n, v in zip(core_labels, recall)},
        **{("f1", n): v for n, v in zip(core_labels, f)},
    }
