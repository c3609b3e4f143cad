"""SRGAN amplification upsampling aux (port of ``hd_yolo_tpu/hnet/srgan.py``):
the generator with pixel-shuffle upsampling, the BatchNorm critic, its WGAN
variant and the WGAN-GP gradient penalty, on NHWC tensors.

What the JAX modules fix and these keep: every conv pads as flax's SAME (a
3x3 stride-2 conv over an even size pads (0, 1), not torch's (1, 1)); the
BatchNorms are flax's (eps 1e-5; in training mode the batch's statistics,
the running ones updated with momentum 0.99 and the biased variance);
PReLU is one parameter ``alpha`` (0.25).  ``gradient_penalty`` draws its
per-sample α from the ``torch.Generator`` given, or takes ``alpha``.  The
generator and the critic are built on the card (``device="cuda"``, raising
without one) unless ``device="cpu"`` is asked for; they run cuDNN's
convolutions, as JAX runs them outside any Pallas kernel.
Parameter names are the flax ones (``conv_in``, ``res{i}.conv1``, ...,
``conv{i}``, ``bn{i}``, ``fc1``, ``fc2``); ``utils/convert.py``
``srgan_state_dict_from_flax`` maps a flax tree onto them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..detector import resolve_device
from .layers import cast_params

Tensor = torch.Tensor

BN_EPS = 1e-5
BN_MOMENTUM = 0.99     # flax: running ← momentum · running + (1 − momentum) · batch


def same_conv(mod: nn.Conv2d, x: Tensor) -> Tensor:
    """NHWC conv of ``mod`` (built with padding 0) with flax's SAME padding:
    total max((ceil(n / s) − 1) · s + k − n, 0) a side pair, the smaller
    half before."""
    pads = []
    for n, k, s in zip(x.shape[1:3], mod.kernel_size, mod.stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (pt, pb), (pl, pr) = pads
    w, b = cast_params(mod, x.dtype)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), w, b, mod.stride)
    return y.permute(0, 2, 3, 1)


def batch_norm(bn: nn.BatchNorm2d, x: Tensor) -> Tensor:
    """flax ``BatchNorm`` of the NHWC ``x``: in training mode on the batch's
    f32 statistics (the running ones updated as flax updates them), else
    on the running ones."""
    if bn.training:
        xf = x.float()
        mean = xf.mean((0, 1, 2))
        var = ((xf * xf).mean((0, 1, 2)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    y = (x.float() - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    return y.to(x.dtype)


def _conv(c_in: int, c_out: int, k: int, s: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, s, 0)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


class PReLU(nn.Module):
    """One-parameter PReLU (torch ``nn.PReLU``'s default)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x: Tensor) -> Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def pixel_shuffle(x: Tensor, r: int) -> Tensor:
    """(B, H, W, C·r²) → (B, H·r, W·r, C): torch's ``PixelShuffle`` in NHWC
    (input channel c·r² + i·r + j goes to output pixel (i, j) of channel c)."""
    B, H, W, Cr2 = x.shape
    C = Cr2 // (r * r)
    return x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3).reshape(B, H * r, W * r, C)


class SRResidualBlock(nn.Module):
    def __init__(self, channels: int = 64):
        super().__init__()
        self.conv1, self.bn1 = _conv(channels, channels, 3), _bn(channels)
        self.prelu = PReLU()
        self.conv2, self.bn2 = _conv(channels, channels, 3), _bn(channels)

    def forward(self, x: Tensor) -> Tensor:
        y = self.prelu(batch_norm(self.bn1, same_conv(self.conv1, x)))
        return x + batch_norm(self.bn2, same_conv(self.conv2, y))


class SRGenerator(nn.Module):
    """The SRGAN generator: 9x9 conv + PReLU, ``num_blocks`` residual
    blocks, 3x3 conv + BN with the long skip, log2(``scale_factor``) x
    [3x3 conv to 4·channels, pixel shuffle 2, PReLU], 9x9 conv to RGB;
    output (tanh + 1) / 2 in [0, 1], f32."""

    def __init__(self, scale_factor: int = 2, channels: int = 64, num_blocks: int = 5,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.conv_in, self.prelu_in = _conv(3, channels, 9), PReLU()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            setattr(self, f"res{i}", SRResidualBlock(channels))
        self.conv_mid, self.bn_mid = _conv(channels, channels, 3), _bn(channels)
        self.num_up = int(math.log2(scale_factor))
        for j in range(self.num_up):
            setattr(self, f"up{j}_conv", _conv(channels, channels * 4, 3))
            setattr(self, f"up{j}_prelu", PReLU())
        self.conv_out = _conv(channels, 3, 9)
        self.to(device)

    def forward(self, x: Tensor) -> Tensor:
        h1 = self.prelu_in(same_conv(self.conv_in, x))
        h = h1
        for i in range(self.num_blocks):
            h = getattr(self, f"res{i}")(h)
        h = h1 + batch_norm(self.bn_mid, same_conv(self.conv_mid, h))
        for j in range(self.num_up):
            h = getattr(self, f"up{j}_prelu")(pixel_shuffle(same_conv(getattr(self, f"up{j}_conv"),
                                                                      h), 2))
        return (torch.tanh(same_conv(self.conv_out, h).float()) + 1.0) / 2.0


class SRDiscriminator(nn.Module):
    """The conv-ladder critic: 8 x [3x3 conv (64, 64/2, 128, 128/2, 256,
    256/2, 512, 512/2), BN after the first, LeakyReLU 0.2], global mean,
    1x1 conv 1024 + LeakyReLU, 1x1 conv 1 → (B,) f32 probabilities;
    ``wgan=True`` drops the BatchNorms and the sigmoid (raw scores)."""

    WIDTHS = ((64, 1), (64, 2), (128, 1), (128, 2), (256, 1), (256, 2), (512, 1), (512, 2))

    def __init__(self, wgan: bool = False, leak: float = 0.2,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.wgan, self.leak = wgan, leak
        c_in = 3
        for i, (c, s) in enumerate(self.WIDTHS):
            setattr(self, f"conv{i}", _conv(c_in, c, 3, s))
            if not wgan and i > 0:
                setattr(self, f"bn{i}", _bn(c))
            c_in = c
        self.fc1 = _conv(c_in, 1024, 1)
        self.fc2 = _conv(1024, 1, 1)
        self.to(device)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for i in range(len(self.WIDTHS)):
            h = same_conv(getattr(self, f"conv{i}"), h)
            if not self.wgan and i > 0:
                h = batch_norm(getattr(self, f"bn{i}"), h)
            h = F.leaky_relu(h, self.leak)
        h = h.mean((1, 2), keepdim=True)
        h = same_conv(self.fc2, F.leaky_relu(same_conv(self.fc1, h), self.leak))
        out = h.reshape(x.shape[0]).float()
        return out if self.wgan else torch.sigmoid(out)


def gradient_penalty(critic: Callable[[Tensor], Tensor], real: Tensor, fake: Tensor,
                     generator: Optional[torch.Generator] = None,
                     alpha: Optional[Tensor] = None) -> Tensor:
    """WGAN-GP: the mean of (‖∇ critic(x̂)‖ − 1)² at x̂ = α·real + (1 − α)·fake,
    α ~ N(0, 1) a sample (drawn from ``generator``, or ``alpha`` (B, 1, 1,
    1) as given).  Differentiable in the critic's parameters (and in real
    and fake where they require it)."""
    B = real.shape[0]
    if alpha is None:
        alpha = torch.randn((B, 1, 1, 1), generator=generator, dtype=real.dtype,
                            device=real.device)
    inter = alpha * real + (1.0 - alpha) * fake
    if not inter.requires_grad:
        inter = inter.requires_grad_()
    (grads,) = torch.autograd.grad(critic(inter).sum(), inter, create_graph=True)
    norms = torch.sqrt((grads.reshape(B, -1) ** 2).sum(1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()
