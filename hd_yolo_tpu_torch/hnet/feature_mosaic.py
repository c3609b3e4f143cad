"""Per-ROI multi-level feature extraction (port of
``hd_yolo_tpu/hnet/feature_mosaic.py`` ``extract_roi_feature_maps``; the
mosaic augmentation is training-only and not ported yet)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.pallas_roi_align import roi_align_levels

Tensor = torch.Tensor


def extract_roi_feature_maps(features: Sequence[Tensor], rois: Tensor, strides: Sequence[float],
                             roi_size: int = 32, amplification: float = 1.0) -> List[Tensor]:
    """features: per level (B, H_l, W_l, C); rois (B, R, 4) xyxy image px →
    per level (B, R, S_l, S_l, C) with S_l = max(round(roi_size·amp) >> l, 1):
    each ROI pooled from every level at a resolution that halves with the
    level: one launch of the single-level ROI-align for every level."""
    base = int(round(roi_size * amplification))
    return roi_align_levels(features, rois, [max(base >> lvl, 1) for lvl in range(len(features))],
                            [1.0 / float(s) for s in strides])
