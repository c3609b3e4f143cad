"""Per-ROI multi-level feature extraction and the feature-space mosaic (port
of ``hd_yolo_tpu/hnet/feature_mosaic.py``).

``extract_roi_feature_maps`` pools each annotation ROI from every pyramid
level in one launch of the single-level ROI-align; under autograd it is
differentiable in the maps (the backward kernel on the card; the boxes get
no gradient).  ``mosaic_roi_feature_maps`` tiles k x k images' pooled ROIs
into one mosaic map a level and ``mosaic_targets`` projects their boxes
into the mosaic's pixel frame (a training-time augmentation of the JAX
package's; its training step does not call them)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.pallas_roi_align import roi_align_levels, roi_align_single

Tensor = torch.Tensor


def mosaic_roi_feature_maps(features: Sequence[Tensor], rois: Tensor, strides: Sequence[float],
                            k: int = 2, cell_size: int = 32) -> List[Tensor]:
    """features: per level (N, H_l, W_l, C) for N = k² source images; rois
    (N, 4) xyxy image px (one ROI an image) → per level a (1, k·S_l, k·S_l,
    C) mosaic, S_l = max(cell_size >> l, 1), image i in cell (i // k, i % k)."""
    N = rois.shape[0]
    if N != k * k:
        raise ValueError(f"need k²={k * k} source images, got {N}")
    out = []
    for lvl, (fmap, stride) in enumerate(zip(features, strides)):
        S = max(cell_size >> lvl, 1)
        pooled = roi_align_single(fmap, rois[:, None], S, 1.0 / float(stride))[:, 0]
        C = pooled.shape[-1]
        grid = pooled.reshape(k, k, S, S, C).permute(0, 2, 1, 3, 4)
        out.append(grid.reshape(1, k * S, k * S, C))
    return out


def extract_roi_feature_maps(features: Sequence[Tensor], rois: Tensor, strides: Sequence[float],
                             roi_size: int = 32, amplification: float = 1.0) -> List[Tensor]:
    """features: per level (B, H_l, W_l, C); rois (B, R, 4) xyxy image px →
    per level (B, R, S_l, S_l, C) with S_l = max(round(roi_size·amp) >> l, 1):
    each ROI pooled from every level at a resolution that halves with the
    level: one launch of the single-level ROI-align for every level."""
    base = int(round(roi_size * amplification))
    return roi_align_levels(features, rois, [max(base >> lvl, 1) for lvl in range(len(features))],
                            [1.0 / float(s) for s in strides])


def mosaic_targets(boxes_list: Sequence[np.ndarray], labels_list: Sequence[np.ndarray],
                   rois: np.ndarray, strides: Sequence[float], k: int = 2,
                   cell_size: int = 32) -> Dict[str, np.ndarray]:
    """Per-image (n_i, 4) xyxy px boxes and labels → the level-0 mosaic's
    frame: each box of image i scaled by cell_px / its ROI's extent, shifted
    to its cell's origin, clipped to the cell and kept when wider and taller
    than 1 px.  Returns {boxes, labels, size (k·cell_px, k·cell_px)}."""
    cell_px = cell_size * float(strides[0])
    out_boxes, out_labels = [], []
    for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
        r, c = i // k, i % k
        x1, y1, x2, y2 = [float(v) for v in rois[i]]
        sx = cell_px / max(x2 - x1, 1e-6)
        sy = cell_px / max(y2 - y1, 1e-6)
        bx = np.asarray(bx, np.float64).reshape(-1, 4)
        proj = np.stack([(bx[:, 0] - x1) * sx + c * cell_px, (bx[:, 1] - y1) * sy + r * cell_px,
                         (bx[:, 2] - x1) * sx + c * cell_px, (bx[:, 3] - y1) * sy + r * cell_px],
                        -1)
        lo = np.array([c, r, c, r]) * cell_px
        proj = np.clip(proj, lo, lo + cell_px)
        keep = (proj[:, 2] - proj[:, 0] > 1) & (proj[:, 3] - proj[:, 1] > 1)
        out_boxes.append(proj[keep])
        out_labels.append(np.asarray(lb)[keep])
    return {
        "boxes": np.concatenate(out_boxes) if out_boxes else np.zeros((0, 4)),
        "labels": np.concatenate(out_labels) if out_labels else np.zeros((0,), np.int64),
        "size": (int(k * cell_px), int(k * cell_px)),
    }
