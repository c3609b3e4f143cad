"""Building blocks of the hnet modules, on NHWC activations.

Parameters stay float32 masters in ``nn.Linear`` / ``nn.Conv2d`` /
``nn.LayerNorm`` / ``nn.GroupNorm`` modules (reference key layout); each call
casts them to the activation dtype once per weight state
(``models.layers.cached``), so a bf16 activation runs bf16 GEMMs with f32
accumulation, as the JAX modules with ``dtype=bfloat16`` do.  Convolutions
take and return NHWC tensors (a 1x1 conv is one matmul over the channels);
``resize_bilinear`` is ``jax.image.resize(..., "bilinear")``, antialiased
when it shrinks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import cached

Tensor = torch.Tensor


def cast_params(mod: nn.Module, dtype: torch.dtype) -> Tuple:
    """(weight, bias) of ``mod`` in ``dtype`` (bias None when absent)."""
    srcs = tuple(t for t in (mod.weight, mod.bias) if t is not None)

    def make():
        w = mod.weight.to(dtype)
        return w, (mod.bias.to(dtype) if mod.bias is not None else None)

    return cached(mod, f"cast_{dtype}", srcs, make)


def dense(mod: nn.Linear, x: Tensor) -> Tensor:
    w, b = cast_params(mod, x.dtype)
    return F.linear(x, w, b)


def conv(mod: nn.Conv2d, x: Tensor) -> Tensor:
    """NHWC conv with the module's stride and padding."""
    w, b = cast_params(mod, x.dtype)
    if mod.kernel_size == (1, 1) and mod.stride == (1, 1) and mod.padding == (0, 0):
        return F.linear(x, w[:, :, 0, 0], b)
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, mod.stride, mod.padding).permute(0, 2, 3, 1)


def layer_norm(mod: nn.LayerNorm, x: Tensor) -> Tensor:
    w, b = cast_params(mod, x.dtype)
    return F.layer_norm(x, mod.normalized_shape, w, b, mod.eps)


def group_norm(mod: nn.GroupNorm, x: Tensor) -> Tensor:
    w, b = cast_params(mod, x.dtype)
    y = F.group_norm(x.permute(0, 3, 1, 2), mod.num_groups, w, b, mod.eps)
    return y.permute(0, 2, 3, 1)


def upsample2x(x: Tensor) -> Tensor:
    """NHWC nearest ×2: each pixel repeated twice along H and W."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)


def resize_bilinear(x: Tensor, size: Sequence[int]) -> Tensor:
    """NHWC → (B, *size, C), half-pixel bilinear, antialiased when
    shrinking (``jax.image.resize(..., "bilinear")``), computed in f32."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
