"""Feature pyramid network (full-map and per-ROI) and the panoptic connector
(port of ``hd_yolo_tpu/hnet/fpn.py``), on NHWC tensors.  Both FPN forms are
differentiable: ``forward_rois`` pools the raw levels through
``extract_roi_feature_maps`` (the single-level ROI-align and its backward
kernel on the card).

``FeaturePyramidNetwork`` uses torchvision's FPN key layout, as
``hd_yolo_tpu/utils/import_maskrcnn.py`` ``import_fpn_state_dict`` reads it:
``inner_blocks.{i}`` (lateral 1x1), ``layer_blocks.{i}`` (output 3x3),
``extra_blocks.p6``/``p7``.  ``PanopticFeatureConnector`` keeps the flax
names ``conv{level}_{hop}`` / ``gn{level}_{hop}``; flax ``GroupNorm``'s eps is
1e-6.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .feature_mosaic import extract_roi_feature_maps
from .layers import conv, group_norm, upsample2x

Tensor = torch.Tensor

GN_EPS = 1e-6


class _P6P7(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.p6 = nn.Conv2d(c, c, 3, 2, 1)
        self.p7 = nn.Conv2d(c, c, 3, 2, 1)


class FeaturePyramidNetwork(nn.Module):
    """Lateral 1x1 + top-down sum + 3x3 output convs; ``extra_blocks`` 1 adds
    a stride-2 subsample of the last level (P6), 2 adds the P6/P7 convs.

    ``forward`` fuses full maps; ``forward_rois`` fuses per-ROI crops of the
    raw backbone levels with the same parameters (the dynamic FPN)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 extra_blocks: int = 0):
        super().__init__()
        self.extra = extra_blocks
        self.num_outputs = len(in_channels) + min(extra_blocks, 2)
        self.inner_blocks = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, 1, 1) for _ in in_channels)
        if extra_blocks >= 2:
            self.extra_blocks = _P6P7(out_channels)

    def _fuse(self, feats: Sequence[Tensor]) -> List[Tensor]:
        laterals = [conv(m, f) for m, f in zip(self.inner_blocks, feats)]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[1:3]
            laterals[i] = laterals[i] + upsample2x(laterals[i + 1])[:, :h, :w]
        outs = [conv(m, l) for m, l in zip(self.layer_blocks, laterals)]
        if self.extra == 1:
            outs.append(outs[-1][:, ::2, ::2])
        elif self.extra >= 2:
            p6 = conv(self.extra_blocks.p6, outs[-1])
            outs.extend([p6, conv(self.extra_blocks.p7, torch.relu(p6))])
        return outs

    def forward(self, feats: Sequence[Tensor]) -> List[Tensor]:
        if len(feats) != len(self.inner_blocks):
            raise ValueError(f"FPN built for {len(self.inner_blocks)} levels, got {len(feats)}")
        return self._fuse(feats)

    def forward_rois(self, feats: Sequence[Tensor], rois_px: Tensor, strides: Sequence[float],
                     roi_size: int) -> List[Tensor]:
        """Crop every raw level to its ladder size ``roi_size >> l`` around
        each of the (B, R) ROIs, then fuse the (B·R) crop batch → per level
        (B·R, S_l, S_l, out_channels)."""
        if len(feats) != len(self.inner_blocks):
            raise ValueError(f"FPN built for {len(self.inner_blocks)} levels, got {len(feats)}")
        crops = extract_roi_feature_maps(feats, rois_px, strides, roi_size=roi_size)
        B, R = rois_px.shape[:2]
        return self._fuse([c.reshape((B * R,) + c.shape[2:]) for c in crops])


class PanopticFeatureConnector(nn.Module):
    """Upsample every level to the finest one — per ×2 hop a 3x3 conv, GN(32),
    ReLU and a nearest ×2 — and sum (Panoptic-FPN fusion).

    The flax module creates its convs as the input shapes call for them; this
    one is built for ``num_levels`` levels that halve per level (level i takes
    i hops; level 0, with no hop, gets one conv), which is what the FPN of a
    Swin backbone gives at any input size whose level 0 is 2^(L-1)-divisible."""

    def __init__(self, in_channels: int, out_channels: int = 128, num_levels: int = 4):
        super().__init__()
        self.out_channels = out_channels
        for i in range(num_levels):
            for hop in range(max(i, 1)):
                c_in = in_channels if hop == 0 else out_channels
                setattr(self, f"conv{i}_{hop}", nn.Conv2d(c_in, out_channels, 3, 1, 1))
                setattr(self, f"gn{i}_{hop}", nn.GroupNorm(32, out_channels, eps=GN_EPS))

    def _hop(self, i: int, hop: int, x: Tensor) -> Tensor:
        if not hasattr(self, f"conv{i}_{hop}"):
            raise ValueError(f"panoptic connector: level {i} of shape {tuple(x.shape)} needs "
                             f"hop {hop}, but the connector was built for levels that halve")
        x = conv(getattr(self, f"conv{i}_{hop}"), x)
        return torch.relu(group_norm(getattr(self, f"gn{i}_{hop}"), x))

    def forward(self, feats: Sequence[Tensor]) -> Tensor:
        target_h, target_w = feats[0].shape[1:3]
        acc = None
        for i, x in enumerate(feats):
            hop = 0
            while x.shape[1] < target_h:
                x = upsample2x(self._hop(i, hop, x))
                hop += 1
            if x.shape[-1] != self.out_channels or hop == 0:
                x = self._hop(i, hop, x)
            x = x[:, :target_h, :target_w]
            acc = x if acc is None else acc + x
        return acc
