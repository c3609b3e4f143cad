"""hnet dense headers, inference (port of ``hd_yolo_tpu/hnet/heads.py``):
panoptic segmentation and whole-ROI classification.  Their losses and the
cross-header constrain modules are training-only and not ported yet.
Parameter names are the flax ones (``connector.*``, ``logits``, ``fc1``,
``fc2``)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .fpn import PanopticFeatureConnector
from .layers import conv, dense, resize_bilinear

Tensor = torch.Tensor


class PanopticSegHead(nn.Module):
    """Panoptic connector → optional bilinear upsample by ``scale_factor`` →
    1x1 conv → softmax (f32)."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 128,
                 scale_factor: int = 1, num_levels: int = 4):
        super().__init__()
        self.scale_factor = scale_factor
        self.connector = PanopticFeatureConnector(in_channels, channels, num_levels)
        self.logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats: Sequence[Tensor]) -> Dict[str, Tensor]:
        x = self.connector(feats)
        if self.scale_factor and self.scale_factor != 1:
            H, W = x.shape[1:3]
            x = resize_bilinear(x, (H * self.scale_factor, W * self.scale_factor))
        logits = conv(self.logits, x)
        return {"probs": torch.softmax(logits.float(), -1), "logits": logits}


class ClassificationHead(nn.Module):
    """Global average pool of the coarsest level → fc1 + ReLU → fc2."""

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, hidden)
        self.fc2 = nn.Linear(hidden, num_classes)

    def forward(self, feats: Sequence[Tensor]) -> Dict[str, Tensor]:
        x = feats[-1].mean((1, 2))
        logits = dense(self.fc2, torch.relu(dense(self.fc1, x))).float()
        return {"logits": logits, "probs": torch.softmax(logits, -1)}
