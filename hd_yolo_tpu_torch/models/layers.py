"""Trunk building blocks (port of ``hd_yolo_tpu/models/layers.py``).

Module and parameter names follow the reference torch layout
(``conv``/``bn``, ``cv1``/``cv2``/``cv3``, ``m.j``), so a flax tree converted
by ``utils/convert.py`` or a reference ``state_dict`` loads with
``strict=True``.

Layout: activations are logical NCHW tensors kept in channels-last memory
(NHWC bytes), which is what cuDNN's fast convolutions and the stem kernel
want.  Parameters stay float32 masters; each conv folds its inference
BatchNorm into the weights and bias and casts them to the activation dtype
(bf16 in production), so cuDNN / cuBLAS accumulate in f32 and write the
compute dtype.  The folded weights are derived once per state of the
masters (``cached``), not on every call.  A 1x1 conv runs as a matmul over
the NHWC bytes (``F.linear``, bias added in the GEMM epilogue).  The first
layer (a stem-shaped conv on <= 4 channels) goes through the stem kernel
(``ops/pallas_stem.py``).

In training mode (``module.training``) every conv runs differentiably as
conv → BatchNorm on the batch's statistics → activation, with no folded
weights, merged C3 convs or stem kernel (the JAX package's training forward
also keeps its stem kernel off).  The statistics are f32 whatever the
activation dtype and the output is in that dtype, as flax's BatchNorm; the
running statistics follow flax: ``mean ← 0.97·mean + 0.03·batch_mean`` and
``var ← 0.97·var + 0.03·batch_var`` with the biased batch variance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pallas_stem import stem_conv

BN_EPS = 1e-3
BN_MOMENTUM = 0.03   # torch convention; flax momentum 0.97

Tensor = torch.Tensor


def cached(module: nn.Module, name: str, sources, make):
    """``make()``, computed once per state of the ``sources`` tensors: an
    in-place update (``load_state_dict``, ``copy_``) bumps a tensor's version
    and a move to another device changes its address, so either recomputes.
    The result is kept on the module, outside its ``state_dict``.  Under
    autograd (grad enabled and a source that requires it: a training
    forward) it is made in the graph on every call and not kept.

    Under ``torch.export`` the sources are fake tensors with no address: the
    value of the last eager call is used as it is, and enters the graph as a
    constant (``engines/evaluate.export`` runs one eager call first); with
    none cached yet it is computed in the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()               # autograd needs the graph: made anew each call
    hit = module.__dict__.get("_cached_" + name)
    if torch.compiler.is_compiling():
        if hit is not None:
            return hit[1]
        with torch.no_grad():
            return make()
    key = tuple((t.data_ptr(), t._version) for t in sources)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make())
        module.__dict__["_cached_" + name] = hit
    return hit[1]


def conv(x: Tensor, w: Tensor, b: Optional[Tensor], stride=1, padding=0,
         groups: int = 1) -> Tensor:
    """conv2d with bias; a 1x1/stride-1 conv runs as one matmul over the NHWC bytes."""
    if w.shape[2:] == (1, 1) and groups == 1 and tuple(_pair(stride)) == (1, 1):
        return F.linear(x.permute(0, 2, 3, 1), w[:, :, 0, 0], b).permute(0, 3, 1, 2)
    return F.conv2d(x, w, b, stride, padding, 1, groups)


def batch_norm_train(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    """Training BatchNorm of the NCHW ``x``: normalized with the batch's f32
    mean and biased variance, output in ``x``'s dtype; ``bn``'s running
    statistics updated as flax updates them.  The kernel gets no buffers
    (its own update would blend in the unbiased variance); the biased
    variance is read back from the inverse standard deviation it saves,
    which spares a second pass over ``x``."""
    y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True, 0.0,
                                              BN_EPS)
    with torch.no_grad():
        var = (invstd.float().reciprocal().square() - BN_EPS).clamp(min=0.0)
        bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.float())
        bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
    return y


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


def _act(act):
    if act is True or act == "silu":
        return F.silu
    if act is False or act is None or act == "identity":
        return lambda x: x
    raise ValueError(f"unsupported activation {act!r}")


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation — the reference ``Conv``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act_name = act
        self.act = _act(act)

    def folded(self):
        """Inference BN as a per-channel affine: (scale, shift), f32."""
        bn = self.bn
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
        shift = bn.bias.float() - bn.running_mean.float() * scale
        return scale, shift

    def _sources(self):
        bn = self.bn
        return (self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)

    def fused_weight(self, dtype):
        """Conv weight with the BN scale folded in, and the BN shift as bias, in ``dtype``."""
        def make():
            scale, shift = self.folded()
            w = self.conv.weight.float() * scale[:, None, None, None]
            return w.to(dtype), shift.to(dtype)

        return cached(self, f"fused_{dtype}", self._sources(), make)

    def is_stem(self, x: Tensor) -> bool:
        """The yolov5 stem shape family: few input channels, k % s == 0, s > 1."""
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        return (x.shape[1] <= 4 and x.dtype == torch.float32 and self.conv.groups == 1
                and k % s == 0 and k >= s > 1 and self.act_name in (True, "silu")
                and self.conv.out_channels % 8 == 0)

    def forward(self, x: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
        dtype = dtype or x.dtype
        if self.training:
            c = self.conv
            y = conv(x.to(dtype), c.weight.to(dtype), None, c.stride, c.padding, c.groups)
            return self.act(batch_norm_train(y, self.bn))
        if self.is_stem(x):
            def make():
                scale, shift = self.folded()
                w = self.conv.weight.float().permute(2, 3, 1, 0).contiguous()   # (K, K, C, N)
                return w, scale.contiguous(), shift.contiguous()

            w, scale, shift = cached(self, "stem", self._sources(), make)
            y = stem_conv(x.permute(0, 2, 3, 1).contiguous(), w, scale, shift,
                          stride=self.conv.stride[0], padding=self.conv.padding[0], out_dtype=dtype)
            return y.permute(0, 3, 1, 2)        # NCHW view of the NHWC result
        w, b = self.fused_weight(dtype)
        y = conv(x.to(dtype), w, b, self.conv.stride, self.conv.padding, self.conv.groups)
        return self.act(y)


class Bottleneck(nn.Module):
    """1x1 → 3x3 with optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs.

    Inference runs cv1 and cv2 (two 1x1 convs over the same input) as ONE
    conv with their output channels concatenated, then splits — the merged
    form of ``layers.py`` ``C3._merged12`` (BN folded per branch)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.c_ = c_
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: Tensor) -> Tensor:
        if self.training:
            return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))

        def make():
            w1, b1 = self.cv1.fused_weight(x.dtype)
            w2, b2 = self.cv2.fused_weight(x.dtype)
            return torch.cat([w1, w2]), torch.cat([b1, b2])

        w, b = cached(self, f"merged_{x.dtype}", self.cv1._sources() + self.cv2._sources(), make)
        y = F.silu(conv(x, w, b))
        y1, y2 = y[:, : self.c_], y[:, self.c_:]
        return self.cv3(torch.cat([self.m(y1), y2], 1))


class SPPF(nn.Module):
    """Fast SPP: 3 chained same-k max pools ≡ SPP(5, 9, 13)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x: Tensor) -> Tensor:
        x = self.cv1(x)
        k = self.k
        y1 = F.max_pool2d(x, k, 1, k // 2)
        y2 = F.max_pool2d(y1, k, 1, k // 2)
        y3 = F.max_pool2d(y2, k, 1, k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Concat(nn.Module):
    """Channel concat of multiple inputs."""

    def forward(self, xs: Sequence[Tensor]) -> Tensor:
        return torch.cat(list(xs), 1)


class Upsample(nn.Module):
    """Nearest-neighbour upsample (each pixel repeated ``scale`` times per axis)."""

    def __init__(self, scale: int = 2, method: str = "nearest"):
        super().__init__()
        if method != "nearest":
            raise ValueError(f"unsupported upsample method {method!r}")
        self.scale = int(scale)

    def forward(self, x: Tensor) -> Tensor:
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")
