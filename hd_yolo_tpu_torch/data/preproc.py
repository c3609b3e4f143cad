"""Batched preprocessing (port of ``hd_yolo_tpu/data/preproc.py``: the
inference part and the HSV jitter of the device recipe).  NHWC batches, on
whatever device they lie on."""

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


def _rgb2hsv(x: Tensor) -> Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(-1)
    mn = x.amin(-1)
    df = mx - mn
    dfs = torch.where(df == 0, 1.0, df)
    h = torch.where(mx == r, torch.remainder((g - b) / dfs, 6.0),
                    torch.where(mx == g, (b - r) / dfs + 2.0, (r - g) / dfs + 4.0))
    h = torch.where(df == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, df / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], -1)


def _hsv2rgb(x: Tensor) -> Tensor:
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    r = pick(v, q, p, p, t, v)
    g = pick(t, v, v, q, p, p)
    b = pick(p, p, t, v, v, q)
    return torch.stack([r, g, b], -1)


def hsv_jitter(images: Tensor, rh: Tensor, rs: Tensor, rv: Tensor) -> Tensor:
    """Per-image HSV gains on a (B, H, W, 3) float batch in [0, 1]: hue
    shifted by ``rh`` (mod 1), saturation and value scaled by ``rs`` and
    ``rv`` and clipped.  The (B,) gains are drawn by the caller (JAX's
    ``hsv_jitter`` draws them from its key: rh in ±h_gain, rs and rv in
    1 ± their gains)."""
    hsv = _rgb2hsv(images.clamp(0.0, 1.0))
    rh, rs, rv = (g.to(images.dtype)[:, None, None] for g in (rh, rs, rv))
    h = torch.remainder(hsv[..., 0] + rh, 1.0)      # a floor modulo: rh may be negative
    s = (hsv[..., 1] * rs).clamp(0.0, 1.0)
    v = (hsv[..., 2] * rv).clamp(0.0, 1.0)
    return _hsv2rgb(torch.stack([h, s, v], -1))
