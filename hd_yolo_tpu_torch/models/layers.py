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

The hub zoo (``DWConv`` to ``MixConv2d``, at the end) is plain torch ops on
the same conventions: the JAX package's arithmetic, the reference's
submodule names, the activation table of ``get_activation``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pallas_stem import stem_conv
from ..parallel.distributed import all_sum, step_group

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
    which spares a second pass over ``x``.

    Inside a step over several processes (``parallel.global_batch``) the
    statistics are the global batch's: each rank's per-channel sum, sum of
    squares and count are summed over the group, and the backward sums its
    per-channel terms over the group too, so it reaches every rank's
    activations.  On the card that is ``_GlobalBatchNorm`` (ATen's fused
    kernels, the ranks' statistics merged as Welford's, a collective each
    way); elsewhere differentiable ops through ``parallel.all_sum``, the
    variance E[x²] − E[x]² as flax computes it."""
    if step_group() is not None:
        return _batch_norm_global(x, bn)
    y, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True, 0.0,
                                              BN_EPS)
    with torch.no_grad():
        var = (invstd.float().reciprocal().square() - BN_EPS).clamp(min=0.0)
        _update_running(bn, mean.float(), var)
    return y


def _update_running(bn: nn.BatchNorm2d, mean: Tensor, var: Tensor) -> None:
    bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
    bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var)


class _GlobalBatchNorm(torch.autograd.Function):
    """The card's form of the global batch's BatchNorm, on ATen's fused CUDA
    kernels (those ``nn.SyncBatchNorm`` runs): each rank's Welford mean,
    inverse deviation and count gathered from every rank and merged
    (``batch_norm_gather_stats_with_counts``: at one rank the local
    statistics as they are), the normalisation in one pass; the backward's
    two per-channel sums all-reduced.  One collective each way; the running
    statistics updated as flax updates them."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, group):
        import torch.distributed as dist

        C = x.shape[1]
        mean_l, invstd_l = torch.batch_norm_stats(x, BN_EPS)
        local = torch.cat([mean_l, invstd_l, mean_l.new_full((1,), x.numel() // C)])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        every = torch.stack(parts)                                  # (world, 2C + 1)
        counts = every[:, 2 * C]
        # f32 scratch running statistics (torch's update of them is not
        # flax's, and without them the counts must be in x's dtype)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, every[:, :C], every[:, C:2 * C], mean_l.new_zeros(C), mean_l.new_ones(C), 0.0,
            BN_EPS, counts)
        var = (invstd.reciprocal().square() - BN_EPS).clamp(min=0.0)
        running_mean.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
        running_var.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        ctx.group = group
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, BN_EPS)

    @staticmethod
    def backward(ctx, dy):
        import torch.distributed as dist

        x, weight, mean, invstd, counts = ctx.saved_tensors
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        dy = dy.contiguous(memory_format=fmt)
        sum_dy, sum_dy_xmu, g_w, g_b = torch.batch_norm_backward_reduce(
            dy, x, mean, invstd, weight, True, True, True)
        C = x.shape[1]
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        g_x = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sums[:C], sums[C:],
                                              counts)
        return g_x, g_w, g_b, None, None, None


def _batch_norm_global(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    if x.is_cuda:
        return _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                      step_group())
    # the plain form (the CPU's): the same statistics through differentiable ops
    xf = x.float()
    C = x.shape[1]
    n = x.numel() // C
    var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)    # one pass over x
    count = torch.full((1,), float(n), dtype=torch.float32, device=x.device)
    stats = all_sum(torch.cat([mean_l * n, (var_l + mean_l.square()) * n, count]))
    count = stats[2 * C:]
    mean = stats[:C] / count
    var = (stats[C:2 * C] / count - mean.square()).clamp(min=0.0)
    scale = torch.rsqrt(var + BN_EPS) * bn.weight.float()
    shift = bn.bias.float() - mean * scale
    with torch.no_grad():
        _update_running(bn, mean.detach(), var.detach())
    return torch.addcmul(shift[:, None, None], xf, scale[:, None, None]).to(x.dtype)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def autopad(k, p=None):
    """'same' padding for odd kernels (a pair for a (kh, kw) kernel)."""
    if p is not None:
        return p
    return k // 2 if isinstance(k, int) else tuple(v // 2 for v in k)


def _identity(x: Tensor) -> Tensor:
    return x


# the JAX package's activation table (``get_activation``); its ``gelu`` is the
# tanh approximation and its ``leaky_relu`` has slope 0.1
ACTIVATIONS = {
    True: F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
    "hardswish": F.hardswish,
    "mish": F.mish,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    False: _identity,
    None: _identity,
    "identity": _identity,
}


def _act(act):
    if callable(act) and not isinstance(act, bool):
        return act
    if act in ACTIVATIONS:
        return ACTIVATIONS[act]
    raise ValueError(f"unknown activation {act!r}")


def batch_norm(x: Tensor, bn: nn.BatchNorm2d) -> Tensor:
    """A standalone BatchNorm of the NCHW ``x``: on the batch's statistics in
    training mode (``batch_norm_train``), on the running ones otherwise."""
    if bn.training:
        return batch_norm_train(x, bn)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        BN_EPS)


class ConvBnAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + activation — the reference ``Conv``."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1, act=True):
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
        c = self.conv
        k, s = c.kernel_size[0], c.stride[0]
        square = (c.kernel_size[1] == k and c.stride[1] == s and c.padding[0] == c.padding[1])
        return (square and x.shape[1] <= 4 and x.dtype == torch.float32 and c.groups == 1
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
        self.m = self.inner(c_, n, shortcut, g)

    @staticmethod
    def inner(c_: int, n: int, shortcut: bool, g: int) -> nn.Module:
        return nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

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


# --- the hub zoo: the rest of the JAX package's layers -----------------------
# Submodules carry the reference torch modules' attribute names, so a
# reference ``state_dict`` loads by key; the arithmetic is the JAX package's
# where it departs from the reference (noted in each docstring).


def cast(module: nn.Module, name: str, dtype: torch.dtype) -> Tensor:
    """``module``'s parameter ``name`` in ``dtype``, cast once per state of
    the parameter (``cached``)."""
    p = getattr(module, name)
    return cached(module, f"{name}_{dtype}", (p,), lambda: p.to(dtype))


def bare_conv(c: nn.Conv2d, x: Tensor) -> Tensor:
    """A conv with no BatchNorm (and no bias) in ``x``'s dtype."""
    return conv(x, cast(c, "weight", x.dtype), None, c.stride, c.padding, c.groups)


def linear(lin: nn.Linear, x: Tensor) -> Tensor:
    b = None if lin.bias is None else cast(lin, "bias", x.dtype)
    return F.linear(x, cast(lin, "weight", x.dtype), b)


class DWConv(ConvBnAct):
    """Depthwise-ish conv: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class BottleneckCSP(nn.Module):
    """CSP bottleneck, original formulation: ``cv3(m(cv1(x)))`` beside
    ``cv2(x)`` (both bare 1x1 convs), BatchNorm and SiLU over the two, then
    ``cv4`` (the reference's v3.1 form applies LeakyReLU there; the JAX
    package applies SiLU)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1)
        self.bn = nn.BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: Tensor) -> Tensor:
        y = torch.cat([bare_conv(self.cv3, self.m(self.cv1(x))), bare_conv(self.cv2, x)], 1)
        return self.cv4(F.silu(batch_norm(y, self.bn)))


def attention(ma: nn.MultiheadAttention, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Multi-head attention of (B, L, C) queries, keys and values through
    ``ma``'s input and output projections, as flax's
    ``MultiHeadDotProductAttention`` computes it (the query scaled by
    1/sqrt(head dim) before the product)."""
    h = ma.num_heads
    d = q.shape[-1] // h
    w = cast(ma, "in_proj_weight", q.dtype).chunk(3)
    b = cast(ma, "in_proj_bias", q.dtype).chunk(3)
    qh, kh, vh = (F.linear(t, wi, bi).unflatten(-1, (h, d)).transpose(1, 2)
                  for t, wi, bi in zip((q, k, v), w, b))          # (B, h, L, d)
    att = torch.softmax((qh / math.sqrt(d)) @ kh.transpose(-1, -2), -1)
    return linear(ma.out_proj, (att @ vh).transpose(1, 2).flatten(2))


class TransformerLayer(nn.Module):
    """q / k / v projections, attention with a residual, then fc1 → fc2 with
    a residual (no LayerNorm)."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, p: Tensor) -> Tensor:
        p = attention(self.ma, linear(self.q, p), linear(self.k, p), linear(self.v, p)) + p
        return linear(self.fc2, linear(self.fc1, p)) + p


class TransformerBlock(nn.Module):
    """ViT-style block on the flattened feature map: an optional ``conv`` to
    ``c2`` channels, a learnable position embedding (``linear``), then
    ``num_layers`` layers (``tr``)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int):
        super().__init__()
        self.conv = ConvBnAct(c1, c2) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))

    def forward(self, x: Tensor) -> Tensor:
        if self.conv is not None:
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.flatten(2).transpose(1, 2)                  # (B, H·W, C), tokens row-major
        p = self.tr(p + linear(self.linear, p))
        return p.transpose(1, 2).reshape(b, c, h, w)


class C3TR(C3):
    """C3 with a 4-head ``TransformerBlock`` of ``n`` layers inside."""

    @staticmethod
    def inner(c_: int, n: int, shortcut: bool, g: int) -> nn.Module:
        return TransformerBlock(c_, c_, 4, n)


class SPP(nn.Module):
    """Spatial pyramid pooling: ``cv1``, max pools of each size (stride 1,
    'same' padding) concatenated with their input, ``cv2``."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        k = (k,) if isinstance(k, int) else tuple(k)
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(k) + 1), c2, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(v, 1, v // 2) for v in k)

    def forward(self, x: Tensor) -> Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class C3SPP(C3):
    """C3 with an ``SPP`` (5, 9, 13) inside (the JAX package's signature:
    the third argument is C3's ``n``, unused)."""

    @staticmethod
    def inner(c_: int, n, shortcut: bool, g: int) -> nn.Module:
        return SPP(c_, c_)


class Focus(nn.Module):
    """Space-to-depth 2x, channel blocks in the order (::2, ::2), (1::2, ::2),
    (::2, 1::2), (1::2, 1::2) of (y, x), then ``conv``."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1, act=True):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k, s, p, g, act)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], 1))


class GhostConv(nn.Module):
    """Ghost convolution: ``cv1`` to half the channels, a depthwise 5x5
    ``cv2`` on those, both concatenated."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, None, g, act)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, None, c_, act)

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """``conv``: GhostConv, a depthwise conv at stride 2, GhostConv (linear);
    plus ``shortcut``: at stride 2 a depthwise conv and a 1x1 conv, else the
    input.  Where the channels differ at stride 1 the JAX package adds
    ``0 * y`` in place of the input (the reference has no such case)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                      ConvBnAct(c1, c2, 1, 1, act=False)) \
            if s == 2 else nn.Identity()
        self.zero_shortcut = s != 2 and c1 != c2

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv(x)
        return y + (0.0 * y if self.zero_shortcut else self.shortcut(x))


class C3Ghost(C3):
    """C3 with ``n`` GhostBottlenecks inside."""

    @staticmethod
    def inner(c_: int, n: int, shortcut: bool, g: int) -> nn.Module:
        return nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class CrossConv(nn.Module):
    """A (1, k) conv then a (k, 1) conv, with an optional residual."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, e: float = 1.0,
                 shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnAct(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Contract(nn.Module):
    """Space-to-depth by ``gain``: channel (sy·gain + sx)·C + c."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = int(gain)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, s * s * c, h // s, w // s)


class Expand(nn.Module):
    """Depth-to-space by ``gain``, the inverse of ``Contract``."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = int(gain)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, s, s, c // (s * s), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // (s * s), h * s, w * s)


class MaxPool2d(nn.Module):
    """``nn.MaxPool2d`` rows of legacy configs: kernel ``k``, stride ``s``,
    symmetric padding ``p`` that never wins."""

    def __init__(self, k: int = 2, s: int = 2, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = int(k), int(s), int(p)

    def forward(self, x: Tensor) -> Tensor:
        return F.max_pool2d(x, self.k, self.s, self.p)


class ZeroPad2d(nn.Module):
    """``nn.ZeroPad2d`` rows of legacy configs: (left, right, top, bottom)."""

    def __init__(self, pads=(0, 0, 0, 0)):
        super().__init__()
        self.pads = tuple(int(v) for v in pads)

    def forward(self, x: Tensor) -> Tensor:
        return F.pad(x, self.pads)


class BatchNorm2d(nn.BatchNorm2d):
    """A standalone BatchNorm row (eps 1e-3, flax's momentum)."""

    def __init__(self, c1: int):
        super().__init__(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: Tensor) -> Tensor:
        return batch_norm(x, self)


def mix_splits(c2: int, n: int) -> list:
    """Output channels of each of ``n`` kernel sizes: the counts of
    floor(linspace(0, n − 1e-6, c2)) == g, with linspace in f32 as
    ``jnp.linspace`` forms it (start·(1 − t) + end·t)."""
    end = torch.tensor(n - 1e-6, dtype=torch.float32)
    t = torch.arange(c2 - 1, dtype=torch.float32) / float(max(c2 - 1, 1))
    idx = torch.floor(torch.cat([end * t, end[None]]) if c2 > 1 else torch.zeros(1))
    return [int((idx == g).sum()) for g in range(n)]


class MixConv2d(nn.Module):
    """Mixed kernel sizes, equal channel split, groups gcd(c1, split), then
    BatchNorm and SiLU (the JAX package's form: no residual, SiLU where the
    reference adds its input and applies LeakyReLU)."""

    def __init__(self, c1: int, c2: int, k=(1, 3), s: int = 1):
        super().__init__()
        k = (k,) if isinstance(k, int) else tuple(k)
        self.m = nn.ModuleList(
            nn.Conv2d(c1, c_, kk, s, kk // 2, groups=math.gcd(c1, c_), bias=False)
            for kk, c_ in zip(k, mix_splits(c2, len(k))))
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: Tensor) -> Tensor:
        return F.silu(batch_norm(torch.cat([bare_conv(m, x) for m in self.m], 1), self.bn))
