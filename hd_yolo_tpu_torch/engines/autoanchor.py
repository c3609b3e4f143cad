"""AutoAnchor: anchor-fit checking and k-means/GA anchor evolution (port
of ``hd_yolo_tpu/engines/autoanchor.py``, numpy and scipy on the host).

* ``check_anchors``: the best possible recall (BPR) of the dataset's box
  sizes under the current anchors and the anchor_t ratio metric;
* ``kmean_anchors``: whitened k-means seeding, then mutation-based
  evolution maximizing the above-threshold fitness.

``train --autoanchor`` reports the fit and changes no anchor.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import LOGGER


def _metric(wh: np.ndarray, anchors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ratio metric: x[i,j] = min(r, 1/r).min over wh dims; best per box."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1.0 / r).min(2)
    return x, x.max(1)


def anchor_fitness(anchors: np.ndarray, wh: np.ndarray, thr: float) -> float:
    _, best = _metric(wh, anchors)
    return float((best * (best > thr)).mean())


def check_anchors(dataset_wh: np.ndarray, anchors: Sequence[Sequence[float]],
                  strides: Sequence[float], anchor_t: float = 4.0,
                  imgsz: int = 640) -> Tuple[float, float]:
    """(BPR, anchors-above-threshold per box) for the dataset wh (pixels)."""
    thr = 1.0 / anchor_t
    a = np.concatenate([np.asarray(row, np.float64).reshape(-1, 2) for row in anchors])
    x, best = _metric(dataset_wh.astype(np.float64), a)
    aat = float((x > thr).sum(1).mean())
    bpr = float((best > thr).mean())
    LOGGER.info(f"autoanchor: BPR={bpr:.4f}, anchors>thr={aat:.2f}")
    return bpr, aat


def kmean_anchors(wh: np.ndarray, n: int = 12, img_size: int = 640, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0, verbose: bool = False) -> np.ndarray:
    """Evolve n anchors for the given box wh set (pixels).

    k-means on whitened wh, then GA mutation.
    """
    from scipy.cluster.vq import kmeans

    rng = np.random.default_rng(seed)
    thr = 1.0 / thr
    wh = wh[(wh >= 2.0).all(1)].astype(np.float64)  # filter tiny boxes
    s = wh.std(0)
    try:
        k, _ = kmeans(wh / s, n, iter=30, seed=seed)
        assert len(k) == n
        k *= s
    except Exception:
        k = np.sort(rng.uniform(size=(n, 2))) * img_size  # random fallback

    def fitness(k):
        _, best = _metric(wh, k)
        return (best * (best > thr)).mean()

    f, sh, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.uniform(size=sh) < mp) * rng.random() * rng.normal(size=sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    k = k[np.argsort(k.prod(1))]
    if verbose:
        LOGGER.info(f"autoanchor: evolved fitness={f:.4f}")
    return k


def dataset_wh(dataset, img_size: int = 640, max_images: Optional[int] = None) -> np.ndarray:
    """Collect normalized→pixel box wh from a DetectionDataset (val mode)."""
    whs: List[np.ndarray] = []
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    for i in range(n):
        sample = dataset[i]
        for t in sample["targets"].values():
            v = t["valid"]
            b = t["boxes"][v] * img_size
            if len(b):
                whs.append(np.stack([b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1))
    return np.concatenate(whs) if whs else np.zeros((0, 2))
