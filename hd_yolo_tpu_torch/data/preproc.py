"""Batched preprocessing (port of ``hd_yolo_tpu/data/preproc.py``: the
inference part).  NHWC batches, on whatever device they lie on."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def normalize(images: Tensor, scale: float = 1.0 / 255.0,
              mean: Optional[Sequence[float]] = None,
              std: Optional[Sequence[float]] = None) -> Tensor:
    """uint8/float → float32 in [0, 1] (optionally standardized)."""
    x = images.to(torch.float32) * scale
    if mean is not None:
        x = x - torch.tensor(mean, dtype=torch.float32, device=x.device)
    if std is not None:
        x = x / torch.tensor(std, dtype=torch.float32, device=x.device)
    return x


def letterbox_batch(images: Tensor, size: Tuple[int, int], fill: float = 114 / 255.0):
    """Aspect-preserving resize + center pad.

    Returns ``(padded, gain, (pad_x, pad_y))``; the inverse transform feeds
    ``scale_coords``.  The resize is bilinear with half-pixel centers and,
    when it shrinks, an antialiasing (triangle) filter — what
    ``jax.image.resize(method='bilinear')`` does.
    """
    B, h, w, C = images.shape
    th, tw = size
    gain = min(th / h, tw / w)
    nh, nw = int(round(h * gain)), int(round(w * gain))
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=nh < h or nw < w)
    pad_y, pad_x = (th - nh) / 2, (tw - nw) / 2
    top, left = int(round(pad_y - 0.1)), int(round(pad_x - 0.1))
    out = torch.full((B, th, tw, C), fill, dtype=torch.float32, device=images.device)
    out[:, top: top + nh, left: left + nw] = x.permute(0, 2, 3, 1)
    return out, gain, (pad_x, pad_y)


def model_input(images, size: Optional[int], device) -> Tensor:
    """A loader batch (B, H, W, C), uint8 or float, as the model's float32
    input on ``device``: an integer batch divided by 255, then resized to
    ``size`` x ``size`` (``None``: kept) bilinearly with half-pixel centers,
    antialiased along an axis it shrinks — ``jax.image.resize(...,
    'bilinear')``, as the JAX package's validation and evaluation resize."""
    x = torch.as_tensor(images).to(device)
    x = x.float() / 255.0 if not x.is_floating_point() else x.float()
    B, H, W, C = x.shape
    if size is None or (H, W) == (size, size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=size < H or size < W)
    return y.permute(0, 2, 3, 1).contiguous()
