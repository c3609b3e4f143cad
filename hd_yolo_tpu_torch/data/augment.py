"""Host-side training augmentations on (image, per-task annotation) pairs
(port of ``hd_yolo_tpu/data/augment.py``): HSV / colour-jitter / colour-dodge
colour ops, a random projective warp of the image and its polygon masks with
the boxes recomputed and filtered, the Albumentations-style photometric
extras, flips and the diagonal transpose, mixup and copy-paste.

Annotations are dicts {'boxes': (N, 4) xyxy px float, 'labels': (N,) int,
'masks': [Mask | None] * N}.  Every random draw comes from an ``AugRng``
the caller owns — ``rng.py`` (a ``random.Random``) where the JAX package
draws from the global ``random``, ``rng.np`` (a ``np.random.RandomState``)
where it draws from the global ``np.random`` — in the same order, so the
same seed gives the same samples.  OpenCV is imported inside the functions
that use it.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mask import Mask

Ann = Dict[str, object]


class AugRng:
    """The augmentations' generators: ``py`` (``random.Random``) and ``np``
    (``np.random.RandomState``), both seeded with ``seed``."""

    def __init__(self, seed: Optional[int] = None):
        self.py = random.Random(seed)
        self.np = np.random.RandomState(seed)


def random_hsv(img: np.ndarray, rng: AugRng, hgain=0.015, sgain=0.7, vgain=0.4,
               p=1.0) -> np.ndarray:
    """uint8 HSV jitter: a per-channel gain in HSV space, hue wrapping mod 180."""
    import cv2

    if rng.py.random() >= p:
        return img
    gain = 1.0 + rng.np.uniform(-1, 1, 3) * [hgain, sgain, vgain]
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.float64)
    hsv[..., 0] = np.trunc(hsv[..., 0] * gain[0]) % 180
    hsv[..., 1:] = np.clip(np.trunc(hsv[..., 1:] * gain[1:]), 0, 255)
    return cv2.cvtColor(hsv.astype(img.dtype), cv2.COLOR_HSV2RGB)


def _luma(img: np.ndarray, keepdims: bool = False) -> np.ndarray:
    g = img[..., :3].astype(np.float32) @ np.asarray([0.2125, 0.7154, 0.0721], np.float32)
    return g[..., None] if keepdims else g


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(img.astype(np.float32) * factor, 0, 255).astype(img.dtype)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    degenerate = float(np.mean(_luma(img)))
    return np.clip(degenerate * (1 - factor) + img * factor, 0, 255).astype(img.dtype)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    degenerate = _luma(img, keepdims=True)
    return np.clip(degenerate * (1 - factor) + img * factor, 0, 255).astype(img.dtype)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Multiplicative hue scale ``h *= 1+factor`` with HSV clipping."""
    import cv2

    if not -0.5 <= factor <= 0.5:
        raise ValueError("hue factor must be in [-0.5, 0.5]")
    hsv = cv2.cvtColor(img.astype(np.float32) / 255.0, cv2.COLOR_RGB2HSV)
    hsv[..., 0] *= 1.0 + factor
    hsv[..., 0] = np.clip(hsv[..., 0], 0.0, 360.0)
    hsv[..., 1:] = np.clip(hsv[..., 1:], 0.0, 1.0)
    rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return np.clip(np.rint(rgb * 255.0), 0, 255).astype(img.dtype)


def color_jitter(img: np.ndarray, rng: AugRng, brightness=0.3, contrast=0.3, saturation=0.3,
                 hue=(-0.15, 0.1), p=1.0) -> np.ndarray:
    """Random-order brightness / contrast / saturation / hue jitter."""
    if rng.py.random() >= p:
        return img
    span = lambda v, lo: (max(lo, 1 - v), 1 + v) if np.isscalar(v) else tuple(v)
    pars = [("brightness", rng.np.uniform(*span(brightness, 0))),
            ("contrast", rng.np.uniform(*span(contrast, 0))),
            ("saturation", rng.np.uniform(*span(saturation, 0))),
            ("hue", rng.np.uniform(*(hue if not np.isscalar(hue) else (-hue, hue))))]
    rng.np.shuffle(pars)
    fns = {"brightness": adjust_brightness, "contrast": adjust_contrast,
           "saturation": adjust_saturation, "hue": adjust_hue}
    for key, val in pars:
        img = fns[key](img, float(val))
    return img


def color_dodge(img: np.ndarray, rng: AugRng, global_mean=0.01, channel_mean=0.01,
                channel_sigma=0.2, p=1.0) -> np.ndarray:
    """Stain jitter: a global brightness shift plus per-channel gain and offset noise."""
    if rng.py.random() >= p:
        return img
    x = img.astype(np.float32) / 255.0
    g = rng.np.normal(0, global_mean)
    mu = rng.np.normal(0, channel_mean, 3)
    sigma = rng.np.normal(1.0, channel_sigma, 3).clip(0.5, 1.5)
    x = (x * sigma + mu + g).clip(0, 1)
    return (x * 255).astype(np.uint8)


def projective_matrix(size: Tuple[int, int], rng: AugRng, degrees=10.0, translate=0.1,
                      scale=0.5, shear=2.0, perspective=0.0) -> np.ndarray:
    """Random 3x3 projective matrix centred on the image."""
    import cv2

    h, w = size
    C = np.eye(3)
    C[0, 2], C[1, 2] = -w / 2, -h / 2
    P = np.eye(3)
    P[2, 0] = rng.py.uniform(-perspective, perspective)
    P[2, 1] = rng.py.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.py.uniform(-degrees, degrees)
    s = rng.py.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.py.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.py.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.py.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.py.uniform(0.5 - translate, 0.5 + translate) * h
    return T @ S @ R @ P @ C


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr=2, ar_thr=20, area_thr=0.1,
                   eps=1e-16) -> np.ndarray:
    """Keep the boxes that survived the warp."""
    w1, h1 = box1[:, 2] - box1[:, 0], box1[:, 3] - box1[:, 1]
    w2, h2 = box2[:, 2] - box2[:, 0], box2[:, 3] - box2[:, 1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def warp_boxes(boxes: np.ndarray, M: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Warp xyxy boxes through M by their 4 corners, clipped to size."""
    n = len(boxes)
    if n == 0:
        return boxes
    corners = np.ones((n * 4, 3))
    corners[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
    pts = corners @ M.T
    pts = (pts[:, :2] / np.maximum(pts[:, 2:3], 1e-9)).reshape(n, 8)
    x = pts[:, [0, 2, 4, 6]]
    y = pts[:, [1, 3, 5, 7]]
    out = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, size[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, size[0])
    return out.astype(np.float32)


def apply_projective(img: np.ndarray, ann: Ann, M: np.ndarray) -> Tuple[np.ndarray, Ann]:
    """Apply a given 3x3 matrix to the image and one task's annotations; a
    warped mask's polygon-accurate box replaces its warped box."""
    import cv2

    size = img.shape[:2]
    warped = cv2.warpPerspective(img, M, (size[1], size[0]), borderValue=(114, 114, 114))
    boxes = np.asarray(ann["boxes"], np.float32).reshape(-1, 4)
    masks: List[Optional[Mask]] = list(ann.get("masks", [None] * len(boxes)))
    new_boxes = warp_boxes(boxes, M, size)
    new_masks = []
    for i, m in enumerate(masks):
        if m is None:
            new_masks.append(None)
            continue
        wm = m.warp(M, size)
        new_masks.append(wm)
        b = wm.box()
        if b[2] > b[0] and b[3] > b[1]:
            new_boxes[i] = np.clip(b, [0, 0, 0, 0], [size[1], size[0], size[1], size[0]])
    keep = box_candidates(boxes, new_boxes)
    return warped, {"boxes": new_boxes[keep], "labels": np.asarray(ann["labels"])[keep],
                    "masks": [m for m, k in zip(new_masks, keep) if k]}


def _projective_hyp(img: np.ndarray, hyp: Dict, rng: AugRng) -> np.ndarray:
    return projective_matrix(img.shape[:2], rng, degrees=hyp.get("degrees", 0.0),
                             translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
                             shear=hyp.get("shear", 0.0),
                             perspective=hyp.get("perspective", 0.0))


def random_projective(img: np.ndarray, ann: Ann, hyp: Dict, rng: AugRng) -> Tuple[np.ndarray, Ann]:
    """Warp the image and one task's masks by a random projective matrix."""
    return apply_projective(img, ann, _projective_hyp(img, hyp, rng))


def apply_flips(img: np.ndarray, ann: Ann, do_lr: bool, do_ud: bool) -> Tuple[np.ndarray, Ann]:
    h, w = img.shape[:2]
    boxes = np.asarray(ann["boxes"], np.float32).reshape(-1, 4).copy()
    masks = list(ann.get("masks", [None] * len(boxes)))
    if do_lr:
        img = np.ascontiguousarray(img[:, ::-1])
        if len(boxes):
            boxes = np.stack([w - boxes[:, 2], boxes[:, 1], w - boxes[:, 0], boxes[:, 3]], 1)
        masks = [m.flip(horizontal=True) if m is not None else None for m in masks]
    if do_ud:
        img = np.ascontiguousarray(img[::-1])
        if len(boxes):
            boxes = np.stack([boxes[:, 0], h - boxes[:, 3], boxes[:, 2], h - boxes[:, 1]], 1)
        masks = [m.flip(vertical=True) if m is not None else None for m in masks]
    return img, {"boxes": boxes, "labels": np.asarray(ann["labels"]), "masks": masks}


def random_flips(img: np.ndarray, ann: Ann, rng: AugRng, p_ud=0.5,
                 p_lr=0.5) -> Tuple[np.ndarray, Ann]:
    do_lr = rng.py.random() < p_lr
    do_ud = rng.py.random() < p_ud
    return apply_flips(img, ann, do_lr, do_ud)


def apply_transpose(img: np.ndarray, ann: Ann) -> Tuple[np.ndarray, Ann]:
    """Diagonal flip (x ↔ y) of image, boxes and masks."""
    img = np.ascontiguousarray(np.swapaxes(img, 0, 1))
    boxes = np.asarray(ann["boxes"], np.float32).reshape(-1, 4)
    boxes = boxes[:, [1, 0, 3, 2]] if len(boxes) else boxes
    masks = [m.transpose() if m is not None else None
             for m in ann.get("masks", [None] * len(boxes))]
    return img, {"boxes": boxes, "labels": np.asarray(ann["labels"]), "masks": masks}


def mixup(img1: np.ndarray, anns1: Dict[str, Ann], img2: np.ndarray, anns2: Dict[str, Ann],
          rng: AugRng) -> Tuple[np.ndarray, Dict[str, Ann]]:
    """Beta(32, 32) image blend and the union of the targets."""
    lam = rng.np.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * lam + img2.astype(np.float32) * (1 - lam)).astype(img1.dtype)
    empty = {"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros((0,), np.int64), "masks": []}
    merged: Dict[str, Ann] = {}
    for task in set(anns1) | set(anns2):
        a, b = anns1.get(task, empty), anns2.get(task, empty)
        merged[task] = {
            "boxes": np.concatenate([np.asarray(a["boxes"]).reshape(-1, 4),
                                     np.asarray(b["boxes"]).reshape(-1, 4)]),
            "labels": np.concatenate([np.asarray(a["labels"]), np.asarray(b["labels"])]),
            "masks": list(a.get("masks", [])) + list(b.get("masks", [])),
        }
    return img, merged


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros(0)
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


def copy_paste(img: np.ndarray, ann: Ann, rng: AugRng, p: float = 0.5) -> Tuple[np.ndarray, Ann]:
    """Horizontally mirrored copy-paste of masked objects whose mirror spot
    does not overlap an existing box (IoU <= 0.3)."""
    if p <= 0 or rng.py.random() >= p:
        return img, ann
    h, w = img.shape[:2]
    boxes = np.asarray(ann["boxes"], np.float32).reshape(-1, 4)
    labels = list(np.asarray(ann["labels"]))
    masks = list(ann.get("masks", [None] * len(boxes)))
    new_boxes, new_labels, new_masks = list(boxes), list(labels), list(masks)
    out = img.copy()
    for i, m in enumerate(masks):
        if m is None:
            continue
        b = boxes[i]
        mb = np.array([w - b[2], b[1], w - b[0], b[3]], np.float32)
        if len(boxes) and (_iou_one_to_many(mb, np.asarray(new_boxes)) > 0.30).any():
            continue
        binm = m.mask().m.astype(bool)[:, ::-1]
        out[binm] = img[:, ::-1][binm]
        new_boxes.append(mb)
        new_labels.append(labels[i])
        new_masks.append(masks[i].flip(horizontal=True))
    return out, {"boxes": np.asarray(new_boxes, np.float32).reshape(-1, 4),
                 "labels": np.asarray(new_labels), "masks": new_masks}


def random_photometric(img: np.ndarray, hyp: Dict, rng: AugRng) -> np.ndarray:
    """Blur / median blur / grey / CLAHE, each with probability ``photometric``."""
    import cv2

    p = float(hyp.get("photometric", 0.01))
    if p <= 0:
        return img
    if rng.py.random() < p:
        img = cv2.blur(img, (3, 3))
    if rng.py.random() < p:
        img = cv2.medianBlur(img, 3)
    if rng.py.random() < p:
        g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        img = cv2.cvtColor(g, cv2.COLOR_GRAY2RGB)
    if rng.py.random() < p:
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    return img


def train_proc(img: np.ndarray, ann: Ann, hyp: Dict, rng: AugRng) -> Tuple[np.ndarray, Ann]:
    """The per-tile chain for one task (see ``train_proc_multi``)."""
    img, anns = train_proc_multi(img, {"_": ann}, hyp, rng)
    return img, anns["_"]


def train_proc_multi(img: np.ndarray, anns: Dict[str, Ann], hyp: Dict,
                     rng: AugRng) -> Tuple[np.ndarray, Dict[str, Ann]]:
    """The per-tile training chain: colour → copy-paste → projective warp →
    photometric extras → flips and transpose, one set of draws applied to the
    image and every task's annotations."""
    color_aug = hyp.get("color_aug", "hsv")
    if color_aug == "hsv":
        # the reference fires its HSV jitter with probability 0.5
        img = random_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                         hyp.get("hsv_v", 0.4), p=hyp.get("hsv_p", 0.5))
    elif color_aug == "jitter":
        img = color_jitter(img, rng)
    elif color_aug == "dodge":
        img = color_dodge(img, rng)

    cp = hyp.get("copy_paste", 0.0)
    if cp > 0:
        out_anns = {}
        for task, a in anns.items():
            img, out_anns[task] = copy_paste(img, a, rng, cp)
        anns = out_anns

    M = _projective_hyp(img, hyp, rng)
    warped, out = None, {}
    for task, a in anns.items():
        warped, out[task] = apply_projective(img, a, M)
    img = warped if warped is not None else img

    img = random_photometric(img, hyp, rng)

    do_lr = rng.py.random() < hyp.get("fliplr", 0.5)
    do_ud = rng.py.random() < hyp.get("flipud", 0.5)
    do_tr = img.shape[0] == img.shape[1] and rng.py.random() < hyp.get("transpose", 0.0)
    flipped, out2 = None, {}
    for task, a in out.items():
        f_img, a2 = apply_flips(img, a, do_lr, do_ud)
        if do_tr:                          # square tiles only: the shape stays
            f_img, a2 = apply_transpose(f_img, a2)
        out2[task] = a2
        flipped = f_img
    return (flipped if flipped is not None else img), out2
