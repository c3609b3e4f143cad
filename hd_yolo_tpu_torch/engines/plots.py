"""Visualization: detection overlays, PR / metric curves and the training
plots (port of ``hd_yolo_tpu/engines/plots.py``).

Host-side: OpenCV draws the overlays and matplotlib the curves and the
training plots (``feature_visualization``, ``plot_labels``,
``plot_evolve``, ``plot_results``), each imported inside the function that
needs it, so that the inference path runs where matplotlib is absent.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_COLORS = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (26, 147, 52), (61, 219, 134),
    (0, 212, 187), (44, 153, 168), (0, 194, 255), (52, 69, 147),
    (100, 115, 255), (0, 24, 236), (132, 56, 255), (82, 0, 133),
]


def color_for(label: int, colors: Optional[Dict[int, Sequence[int]]] = None):
    if colors and label in colors:
        return tuple(int(c) for c in colors[label])
    return DEFAULT_COLORS[int(label) % len(DEFAULT_COLORS)]


def overlay_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    labels_text: Optional[Dict[int, str]] = None,
    labels_color: Optional[Dict[int, Sequence[int]]] = None,
    line: int = 2,
    mask_alpha: float = 0.4,
) -> np.ndarray:
    """Draw boxes (+in-box masks) onto an RGB uint8 image (image_utils.py:797-911).

    masks: (N, M, M) in-box probability masks, pasted into each box.
    """
    import cv2

    img = np.ascontiguousarray(image).copy()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    boxes = np.asarray(boxes)
    for i, b in enumerate(boxes):
        x1, y1, x2, y2 = [int(round(float(v))) for v in b[:4]]
        lab = int(labels[i]) if labels is not None else 0
        col = color_for(lab, labels_color)
        cv2.rectangle(img, (x1, y1), (x2, y2), col, line)
        if masks is not None and i < len(masks):
            bw, bh = max(x2 - x1, 1), max(y2 - y1, 1)
            m = cv2.resize(np.asarray(masks[i], np.float32), (bw, bh)) > 0.5
            xs, ys = max(x1, 0), max(y1, 0)
            xe, ye = min(x2, w), min(y2, h)
            if xe > xs and ye > ys:
                sub = img[ys:ye, xs:xe]
                mm = m[ys - y1 : ye - y1, xs - x1 : xe - x1]
                sub[mm] = (sub[mm] * (1 - mask_alpha) + np.array(col) * mask_alpha).astype(np.uint8)
        text = ""
        if labels_text and lab in labels_text:
            text = str(labels_text[lab])
        elif labels is not None:
            text = str(lab)
        if scores is not None:
            text = f"{text} {float(scores[i]):.2f}".strip()
        if text:
            cv2.putText(img, text, (x1, max(y1 - 3, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.4, col, 1, cv2.LINE_AA)
    return img


def save_detection_overlay(path: str, image, output: Dict[str, np.ndarray],
                           target: Optional[Dict[str, np.ndarray]] = None,
                           meta: Optional[Dict] = None):
    """Side-by-side GT | prediction dump (val_nuclei.py:162-195)."""
    import cv2

    meta = meta or {}
    pred = overlay_detections(
        image, output["boxes"], output.get("labels"), output.get("scores"),
        output.get("masks"), meta.get("labels_text"), meta.get("labels_color"),
    )
    panels = [pred]
    if target is not None:
        gt = overlay_detections(
            image, target["boxes"], target.get("labels"), None,
            target.get("masks"), meta.get("labels_text"), meta.get("labels_color"),
        )
        panels = [gt, pred]
    out = np.concatenate(panels, axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
    return out


def plot_pr_curve(px, py, ap, save_path: str, names: Sequence[str] = ()):
    """metrics.py:207-225."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.asarray(py)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names[i]} {ap[i]:.3f}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    ax.plot(px, py.mean(0), linewidth=3, color="blue",
            label=f"all classes {np.mean(ap):.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_mc_curve(px, py, save_path: str, names: Sequence[str] = (),
                  xlabel="Confidence", ylabel="Metric"):
    """metrics.py:228-246."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.asarray(py)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=names[i])
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_apmeter_stats(stats: Dict, save_dir: str, prefix: str = "",
                       labels_text: Optional[Dict[int, str]] = None):
    """PR/F1/P/R curve dump from APMeter.ap_per_class output (metrics.py:397-408)."""
    names = [
        (labels_text or {}).get(c, str(c)) for c in stats["labels"]
    ]
    j = os.path.join
    plot_pr_curve(stats["px"], stats["py"], stats["ap"][:, 0], j(save_dir, f"{prefix}PR_curve.png"), names)
    plot_mc_curve(stats["px"], stats["f1"], j(save_dir, f"{prefix}F1_curve.png"), names, ylabel="F1")
    plot_mc_curve(stats["px"], stats["p"], j(save_dir, f"{prefix}P_curve.png"), names, ylabel="Precision")
    plot_mc_curve(stats["px"], stats["r"], j(save_dir, f"{prefix}R_curve.png"), names, ylabel="Recall")


def feature_visualization(fmap: np.ndarray, save_path: str, n_max: int = 32):
    """Per-stage channel grid: fmap (H, W, C), the first ``n_max`` channels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = min(fmap.shape[-1], n_max)
    cols = 8
    rows = int(np.ceil(c / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 1.5, rows * 1.5), tight_layout=True)
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        ax.axis("off")
        if i < c:
            ax.imshow(fmap[..., i], cmap="viridis")
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_labels(labels: np.ndarray, names: Sequence[str] = (),
                save_dir: str = "."):
    """Dataset label statistics → labels.jpg:
    class histogram, xy / wh 2-D densities, first-1000 box rectangles.
    Matplotlib-only (the reference's seaborn correlogram is a styling layer
    over the same marginals)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.asarray(labels, np.float64)
    c, b = labels[:, 0].astype(int), labels[:, 1:5]
    nc = int(c.max()) + 1 if len(c) else 1
    fig, ax = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = ax.ravel()
    ax[0].hist(c, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    ax[0].set_ylabel("instances")
    if 0 < len(names) < 30:
        ax[0].set_xticks(range(len(names)))
        ax[0].set_xticklabels(list(names), rotation=90, fontsize=10)
    else:
        ax[0].set_xlabel("classes")
    # first-1000 rectangles centred on a unit canvas
    ax[1].set_xlim(0, 1); ax[1].set_ylim(0, 1); ax[1].axis("off")
    for cls, x, y, w, h in labels[:1000, :5]:
        ax[1].add_patch(plt.Rectangle((0.5 - w / 2, 0.5 - h / 2), w, h,
                                      fill=False, linewidth=0.5))
    if len(b):
        ax[2].hist2d(b[:, 0], b[:, 1], bins=50, cmap="viridis")
        ax[2].set_xlabel("x"); ax[2].set_ylabel("y")
        ax[3].hist2d(b[:, 2], b[:, 3], bins=50, cmap="viridis")
        ax[3].set_xlabel("width"); ax[3].set_ylabel("height")
    os.makedirs(save_dir, exist_ok=True)
    fig.savefig(os.path.join(save_dir, "labels.jpg"), dpi=200)
    plt.close(fig)
    return os.path.join(save_dir, "labels.jpg")


def plot_evolve(evolve_csv: str):
    """Hyp-evolution scatter grid → evolve.png:
    one panel per evolved hyp, fitness on y, best generation marked."""
    import csv as _csv

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(evolve_csv) as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        return None
    fit = np.asarray([float(r["fitness"]) for r in rows])
    keys = [k for k in rows[0] if k not in ("generation", "fitness")]
    j = int(np.argmax(fit))
    ncol = 5
    nrow = max((len(keys) + ncol - 1) // ncol, 1)
    fig = plt.figure(figsize=(10, 2.2 * nrow), tight_layout=True)
    for i, k in enumerate(keys):
        v = np.asarray([float(r[k]) if r[k] not in ("", None) else np.nan
                        for r in rows])
        axp = fig.add_subplot(nrow, ncol, i + 1)
        axp.scatter(v, fit, c=fit, cmap="viridis", alpha=0.8,
                    edgecolors="none")
        axp.plot(v[j], fit[j], "k+", markersize=15)
        axp.set_title(f"{k} = {v[j]:.3g}", fontdict={"size": 9})
        if i % ncol != 0:
            axp.set_yticks([])
    out = os.path.splitext(evolve_csv)[0] + ".png"
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def plot_results(results_json: str):
    """Per-epoch training curves → results.png from the json-lines results
    file the loggers write."""
    import json as _json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [_json.loads(ln) for ln in open(results_json) if ln.strip()]
    if not rows:
        return None
    cols = [k for k in rows[0] if k != "epoch"
            and isinstance(rows[0][k], (int, float))]
    x = [r.get("epoch", i) for i, r in enumerate(rows)]
    ncol = 4
    nrow = max((len(cols) + ncol - 1) // ncol, 1)
    fig, ax = plt.subplots(nrow, ncol, figsize=(ncol * 4, nrow * 3),
                           tight_layout=True, squeeze=False)
    ax = ax.ravel()
    for i, k in enumerate(cols):
        y = [r.get(k, np.nan) for r in rows]
        ax[i].plot(x, y, marker=".", linewidth=2, markersize=6)
        ax[i].set_title(k, fontsize=11)
    for a in ax[len(cols):]:
        a.axis("off")
    out = os.path.join(os.path.dirname(os.path.abspath(results_json)),
                       "results.png")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out
