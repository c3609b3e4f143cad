"""Misc training utilities (port of ``hd_yolo_tpu/utils/general.py``):
class and image weights from the labels, the grid-size check of the image
size and a version check."""

from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np

from .. import LOGGER


def labels_to_class_weights(labels: Sequence[np.ndarray], nc: int) -> np.ndarray:
    """Inverse-frequency class weights over per-image label arrays: negative
    (unlabeled) ids ignored, 1/count for a present class, 0 for an absent one,
    normalized to sum to the number of present classes.  (nc,) float32."""
    if not len(labels) or labels[0] is None:
        return np.zeros(0, np.float32)
    classes = np.concatenate([np.asarray(lb).reshape(-1) for lb in labels]).astype(np.int64)
    classes = classes[classes >= 0]
    counts = np.bincount(classes, minlength=nc)[:nc]
    weights = np.where(counts > 0, 1.0 / np.maximum(counts, 1), 0.0)
    total = weights.sum()
    if total > 0:
        weights = weights / total * int((counts > 0).sum())
    return weights.astype(np.float32)


def labels_to_image_weights(labels: Sequence[np.ndarray], nc: int,
                            class_weights: np.ndarray) -> np.ndarray:
    """Per-image sampling weights Σ_class class_weight · count (a weighted
    sampler's input for class-balanced epochs).  (N,) float64."""
    out = np.zeros(len(labels), np.float64)
    cw = np.asarray(class_weights, np.float64).reshape(-1)[:nc]
    for i, lb in enumerate(labels):
        cls = np.asarray(lb).reshape(-1).astype(np.int64)
        counts = np.bincount(cls[cls >= 0], minlength=nc)[:nc]
        out[i] = float((cw * counts).sum())
    return out


def check_img_size(img_size: int, stride: int = 32, floor: int = 0) -> int:
    """Round the image size up to a multiple of the max stride (warn and adjust)."""
    new = max(int(math.ceil(img_size / stride) * stride), floor)
    if new != img_size:
        LOGGER.warning(f"img_size {img_size} is not a multiple of stride {stride}; using {new}")
    return new


def check_version(current: str, minimum: str, name: str = "version",
                  hard: bool = False) -> bool:
    """``current`` >= ``minimum`` on the first three dotted numbers; with
    ``hard`` a lower version raises ``AssertionError``."""

    def parse(v: str):
        return tuple(int(x) for x in re.findall(r"\d+", v)[:3])

    ok = parse(current) >= parse(minimum)
    if not ok and hard:
        raise AssertionError(f"{name} {minimum} required, found {current}")
    return ok
