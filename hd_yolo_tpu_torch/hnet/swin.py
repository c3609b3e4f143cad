"""Swin Transformer backbone (port of ``hd_yolo_tpu/hnet/swin.py``).

NHWC in, four NHWC pyramid levels out at strides 4, 8, 16, 32.  Module and
parameter names follow the upstream (Microsoft / timm) key layout that
``hd_yolo_tpu/utils/import_swin.py`` reads: ``patch_embed.proj``/``norm``,
``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.downsample.{norm,reduction}`` and the output norms ``norm{i}``.

What the JAX module fixes and this one keeps: LayerNorm eps 1e-6 (flax's
default, not torch's 1e-5); the MLP's GELU is the tanh approximation
(``jax.nn.gelu``'s default); window padding happens inside each block on
the normed tensor and is cropped before the residual add, with the shift
mask built on the padded grid; the attention softmax runs in f32 and is
cast back.

In training mode (``module.training``) the block's residual branches take
stochastic depth (``DropPath``, the rate ramped linearly over the blocks,
``dpr = drop_path_rate · i / (total − 1)``), its projection and MLP
dropouts ``drop_rate`` and its attention dropout ``attn_drop_rate``, as
flax's ``Dropout``: kept with probability 1 − rate, survivors divided by
it.  Every mask draws from the ``torch.Generator`` handed to ``forward``
(none: torch's default generator); the JAX package draws its own bits from
a ``dropout`` key, so the two agree in distribution, not bit for bit.  In
eval mode, or at rate 0, they are the identity.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import cached
from ..parallel.distributed import draw_rows
from .layers import conv, dense, layer_norm

Tensor = torch.Tensor

LN_EPS = 1e-6
MLP_RATIO = 4
PATCH_SIZE = 4


def dropout(x: Tensor, rate: float, training: bool, generator=None, shape=None) -> Tensor:
    """flax ``Dropout``: each element (or each of ``shape``, broadcast) kept
    with probability 1 − ``rate`` and divided by it, else 0; the identity in
    eval mode or at rate 0."""
    if rate <= 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = draw_rows(lambda s: torch.bernoulli(torch.full(s, keep, device=x.device),
                                               generator=generator),
                     x.shape if shape is None else shape).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(nn.Module):
    """Stochastic depth: a per-sample Bernoulli mask (keep 1 − ``rate``)
    zeroes a residual branch, survivors divided by the keep probability."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: Tensor, generator=None) -> Tensor:
        return dropout(x, self.rate, self.training, generator,
                       (x.shape[0],) + (1,) * (x.dim() - 1))


def window_partition(x: Tensor, ws: int) -> Tensor:
    """(B, H, W, C) → (B·nW, ws, ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows: Tensor, ws: int, H: int, W: int) -> Tensor:
    """(B·nW, ws, ws, C) → (B, H, W, C)."""
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws−1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + [ws - 1, ws - 1]
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask for SW-MSA on an H×W (padded) grid."""
    img_mask = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, H // ws, ws, W // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size)),
                             persistent=False)

    def bias(self, dtype: torch.dtype) -> Tensor:
        """(h, N, N) relative-position bias in ``dtype``."""
        N = self.window_size ** 2

        def make():
            idx = self.relative_position_index.reshape(-1)
            b = self.relative_position_bias_table[idx].reshape(N, N, self.num_heads)
            return b.permute(2, 0, 1).to(dtype).contiguous()

        return cached(self, f"bias_{dtype}", (self.relative_position_bias_table,), make)

    def forward(self, x: Tensor, mask: Tensor = None, generator=None) -> Tensor:
        """x: (B·nW, N=ws², C); mask: (nW, N, N) additive, or None."""
        Bn, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = dense(self.qkv, x).reshape(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]             # (Bn, h, N, hd)
        attn = q @ k.transpose(-2, -1)
        attn = attn + self.bias(attn.dtype)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(Bn // nW, nW, h, N, N) + mask[None, :, None].to(attn.dtype)
            attn = attn.view(Bn, h, N, N)
        attn = torch.softmax(attn.float(), -1).to(x.dtype)
        attn = dropout(attn, self.attn_drop, self.training, generator)
        out = (attn @ v).transpose(1, 2).reshape(Bn, N, C)
        return dropout(dense(self.proj, out), self.proj_drop, self.training, generator)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = drop

    def forward(self, x: Tensor, generator=None) -> Tensor:
        y = dropout(F.gelu(dense(self.fc1, x), approximate="tanh"), self.drop, self.training,
                    generator)
        return dropout(dense(self.fc2, y), self.drop, self.training, generator)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 drop_path: float = 0.0, drop_rate: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads, attn_drop, drop_rate)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * MLP_RATIO, drop_rate)
        self.drop_path = DropPath(drop_path)

    def shift_mask(self, Hp: int, Wp: int, device) -> Tensor:
        """The padded grid's shift mask, made once per grid size and device."""
        masks = self.__dict__.setdefault("_shift_masks", {})
        key = (Hp, Wp, str(device))
        if key not in masks:
            masks[key] = torch.from_numpy(
                shifted_window_mask(Hp, Wp, self.window_size, self.shift_size)).to(device)
        return masks[key]

    def forward(self, x: Tensor, generator=None) -> Tensor:
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        ph, pw = (-H) % ws, (-W) % ws
        Hp, Wp = H + ph, W + pw
        shortcut = x
        x = layer_norm(self.norm1, x)
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = self.shift_mask(Hp, Wp, x.device)
        windows = window_partition(x, ws).reshape(-1, ws * ws, C)
        x = window_reverse(self.attn(windows, mask, generator).reshape(-1, ws, ws, C), ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        if ph or pw:
            x = x[:, :H, :W]
        x = shortcut + self.drop_path(x, generator)
        return x + self.drop_path(self.mlp(layer_norm(self.norm2, x), generator), generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return dense(self.reduction, layer_norm(self.norm, x))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, PATCH_SIZE, PATCH_SIZE)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: Tensor) -> Tensor:
        # flax "SAME" padding of a k = s conv: total (-size) % s, half before
        ph, pw = (-x.shape[1]) % PATCH_SIZE, (-x.shape[2]) % PATCH_SIZE
        if ph or pw:
            x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return layer_norm(self.norm, conv(self.proj, x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int, downsample: bool,
                 drop_paths: Sequence[float] = (), drop_rate: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        drop_paths = tuple(drop_paths) or (0.0,) * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if j % 2 == 0 else window_size // 2,
                      drop_paths[j], drop_rate, attn_drop)
            for j in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinTransformer(nn.Module):
    """Swin-T/S/B family backbone; ``forward`` returns the pyramid levels of
    ``out_indices`` (strides 4-32), each through its output LayerNorm.  The
    drop rates act in training mode only (module docstring)."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_indices: Sequence[int] = (0, 1, 2, 3), drop_path_rate: float = 0.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList()
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            first = sum(depths[:i])
            self.layers.append(BasicLayer(dim, depth, heads, window_size,
                                          downsample=i < len(depths) - 1,
                                          drop_paths=dpr[first:first + depth],
                                          drop_rate=drop_rate, attn_drop=attn_drop_rate))
            if i in self.out_indices:
                setattr(self, f"norm{i}", nn.LayerNorm(dim, eps=LN_EPS))
            dim *= 2

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(getattr(self, f"norm{i}").normalized_shape[0] for i in self.out_indices)

    def forward(self, x: Tensor, generator=None) -> List[Tensor]:
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, generator)
            if i in self.out_indices:
                outs.append(layer_norm(getattr(self, f"norm{i}"), x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs
