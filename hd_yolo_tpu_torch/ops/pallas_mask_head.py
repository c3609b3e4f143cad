"""Fused inference mask head on the card: wrapper of ``kernels/mask_head.cu``
(bf16) and ``kernels/mask_head_f32.cu`` (f32), the Hopper ports of
``hd_yolo_tpu/ops/pallas_mask_head.py``.

``fused_mask_probs(head, pooled, labels, active=None)`` computes
``sigmoid(MaskHead(pooled))[..., label]`` per ROI as (N, 2M, 2M) f32 for
the first ``active`` ROIs (a 0-d integer tensor; ``None`` means all) and
exactly 0 for the rest.  On a
CUDA tensor the kernel runs the whole chain (4 convs, deconv, selected
logits, sigmoid); on a CPU tensor the plain version below runs the same
function with the same rounding points: each GEMM on compute-dtype
operands with f32 accumulation, the accumulator rounded to the compute
dtype before the bias add, the selected-logit dot in f32.

Each kernel is a ``torch.library`` op, ``hd_yolo_tpu_torch::mask_head`` or
``::mask_head_f32``
(the ``ctypes`` launch in its body, a fake implementation of its output
shape), so ``torch.export`` keeps it as one call in the graph; eager calls
on the card go through the same op.  Its packed weights are derived once
per weight state (``models/layers.cached``); under export the packed
tensors of the last eager call enter the graph as constants.

Deconv weights: the reference layout ``conv5_mask.weight`` (I, O, 2, 2)
gives ``out[2i+dy, 2j+dx] = x[i, j] · W[:, :, dy, dx]`` — the flax kernel
already flipped back by ``utils/convert.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from ..models.layers import cached

Tensor = torch.Tensor


def _selected_logits(head, labels: Tensor, cd: torch.dtype):
    logits = head.maskrcnn_preds.mask_fcn_logits
    wl = logits.weight[:, :, 0, 0]                                  # (nc, C)
    return wl[labels].to(cd), logits.bias.float()[labels]


def mask_head_plain(head, pooled: Tensor, wl_sel: Tensor) -> Tensor:
    """(N, M, M, C) → (N, 4, M, M) selected pre-bias logits per deconv tap
    d = dy*2 + dx, f32."""
    cd = pooled.dtype
    x = pooled.permute(0, 3, 1, 2).float()
    for conv in head.fcn:
        acc = F.conv2d(x, conv.weight.to(cd).float(), padding=1)
        x = torch.relu(acc.to(cd) + conv.bias.to(cd)[:, None, None]).float()
    deconv = head.maskrcnn_preds.conv5_mask
    wl = wl_sel.to(cd).float()
    outs = []
    for dy in range(2):
        for dx in range(2):
            z = torch.einsum("nihw,io->nohw", x, deconv.weight[:, :, dy, dx].to(cd).float())
            z = torch.relu(z.to(cd) + deconv.bias.to(cd)[:, None, None]).float()
            outs.append((z * wl[:, :, None, None]).sum(1))
    return torch.stack(outs, 1)


def _deinterleave(o: Tensor) -> Tensor:
    """(N, 4, M, M) taps → (N, 2M, 2M): out[n, 2i+dy, 2j+dx] = o[n, dy*2+dx, i, j]."""
    N, _, M, _ = o.shape
    return o.reshape(N, 2, 2, M, M).permute(0, 3, 1, 4, 2).reshape(N, 2 * M, 2 * M)


def kernel_weights(head, cd: torch.dtype = torch.bfloat16):
    """The operand layouts: wf (4, 9, co, ci), bf (4, C), wd (4, co, ci)
    with d = dy*2+dx, bd (C,), all in ``cd``."""
    wf = torch.stack([c.weight.permute(2, 3, 0, 1).reshape(9, c.out_channels, c.in_channels)
                      for c in head.fcn]).to(cd).contiguous()
    bf = torch.stack([c.bias for c in head.fcn]).to(cd).contiguous()
    deconv = head.maskrcnn_preds.conv5_mask
    wd = deconv.weight.permute(2, 3, 1, 0).reshape(4, deconv.out_channels,
                                                   deconv.in_channels).to(cd).contiguous()
    return wf, bf, wd, deconv.bias.to(cd).contiguous()


def _slices(w: Tensor, core: int = 8) -> Tensor:
    """(..., 256 co, 256 ci) → (..., pass 2, ks, 256·core): each (pass, ks)
    k-slice (co 128·pass.., 2·core ci from 2·core·ks) in wgmma's no-swizzle
    K-major layout, 8-co groups of two core matrices of 8 rows x 16 bytes
    (``core`` elements: 8 for bf16, 4 for 32-bit operands)."""
    lead = w.shape[:-2]
    ks = 256 // (2 * core)
    w = w.reshape(*lead, 2, 16, 8, ks, 2, core)         # pass, co group, co row, ks, k half, ci
    n = len(lead)
    perm = list(range(n)) + [n + i for i in (0, 3, 1, 4, 2, 5)]
    return w.permute(*perm).reshape(*lead, 2, ks, 256 * core)


def mask_head_stream(wf: Tensor, wd: Tensor, core: int = 8) -> Tensor:
    """The kernel's weight stream: its k-slices in the order it consumes
    them, (layer, pass, tap, ks) for the convs then (d, pass, ks) for the
    deconv taps, as one contiguous tensor: (1280, 2048) for the bf16 kernel
    (16 ci a slice), (2560, 1024) at ``core`` 4 (8 ci a slice)."""
    conv = _slices(wf, core).permute(0, 2, 1, 3, 4)      # layer, pass, tap, ks
    return torch.cat([conv.reshape(-1, 256 * core),
                      _slices(wd, core).reshape(-1, 256 * core)]).contiguous()


def _active_count(active, N: int) -> int:
    return N if active is None else max(0, min(int(active), N))


def fused_mask_probs_plain(head, pooled: Tensor, labels: Tensor, active=None) -> Tensor:
    N = pooled.shape[0]
    k = _active_count(active, N)
    wl_sel, bl_sel = _selected_logits(head, labels[:k].to(torch.int64), pooled.dtype)
    o = mask_head_plain(head, pooled[:k], wl_sel) + bl_sel[:, None, None, None]
    out = torch.zeros((N,) + (2 * pooled.shape[1],) * 2, dtype=torch.float32, device=pooled.device)
    out[:k] = _deinterleave(torch.sigmoid(o))
    return out


def fused_mask_probs(head, pooled: Tensor, labels: Tensor, active: Optional[Tensor] = None) -> Tensor:
    """MaskHead → sigmoid → per-ROI channel select, fused.

    head: ``models/detect_head.MaskHead``; pooled (N, M, M, C); labels (N,)
    mask-channel index in [0, number of mask classes) (the kernel reads the
    index on the device and does not check it); active: a 0-d integer
    tensor, how many leading ROIs to compute (the kernel reads it on the
    device, no host sync), or ``None`` for all.  Returns (N, 2M, 2M) f32 probabilities, exactly 0 for
    ROIs at or past ``active``.

    bf16 features run ``kernels/mask_head.cu``, f32 features (an f32 model)
    its f32 form ``kernels/mask_head_f32.cu``: each computes in the pooled
    dtype, as the JAX package's kernel does."""
    if pooled.device.type == "cpu":
        return fused_mask_probs_plain(head, pooled, labels, active)
    labels = labels.to(torch.int64).contiguous()
    N, M, M2, C = pooled.shape
    if pooled.dtype not in (torch.bfloat16, torch.float32) or (M, M2, C) != (14, 14, 256):
        raise ValueError(f"mask head kernels take (N, 14, 14, 256) bf16 or f32, got "
                         f"{tuple(pooled.shape)} {pooled.dtype}")
    pooled = pooled.contiguous()
    if active is not None:
        active = active.to(torch.int64).reshape(())  # the packed branch's sum is int64 already
    if pooled.dtype == torch.float32:
        return _fused_mask_probs_f32(head, pooled, labels, active)

    def weights():
        wf, bf, wd, bd = kernel_weights(head)
        logits = head.maskrcnn_preds.mask_fcn_logits
        return (mask_head_stream(wf, wd), bf, bd,
                logits.weight[:, :, 0, 0].to(torch.bfloat16).contiguous(),
                logits.bias.float().contiguous())

    # the kernel selects each ROI's logits column and bias itself
    stream, bf, bd, wl, bl = cached(head, "kernel_weights", tuple(head.parameters()), weights)
    tensors = [pooled, stream, bf, bd, wl, bl, labels]
    if active is not None:
        tensors.append(active)
    kernels.require_cuda(*tensors)
    return mask_head_op(pooled, stream, bf, bd, wl, bl, labels, active)


def tf32_round(x: Tensor) -> Tensor:
    """f32 → the nearest TF32 value (ties away from zero, as ``cvt.rna``),
    low 13 mantissa bits zero, as f32."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), the operands of a split
    TF32 product lo·hi + hi·lo + hi·hi."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def mask_head_stream_f32(wf: Tensor, wd: Tensor) -> Tensor:
    """The f32 kernel's weight stream: :func:`mask_head_stream`'s 2560
    k8-slices for 32-bit operands, each split into its hi then its lo
    half: (2560, 2, 1024)."""
    return torch.stack(split_tf32(mask_head_stream(wf.float(), wd.float(), core=4)), 1).contiguous()


def kernel_weights_f32(head):
    """The f32 form's operands: the split weight stream of
    :func:`mask_head_stream_f32`, bf (4, C), bd (C,), the logits' wl
    (classes, C) and bl (classes,), all f32."""
    wf, bf, wd, bd = kernel_weights(head, torch.float32)
    logits = head.maskrcnn_preds.mask_fcn_logits
    return (mask_head_stream_f32(wf, wd), bf, bd,
            logits.weight[:, :, 0, 0].float().contiguous(), logits.bias.float().contiguous())


def _fused_mask_probs_f32(head, pooled: Tensor, labels: Tensor, active: Optional[Tensor]) -> Tensor:
    weights = cached(head, "kernel_weights_f32", tuple(head.parameters()),
                     lambda: kernel_weights_f32(head))
    tensors = [pooled, *weights, labels] + ([] if active is None else [active])
    kernels.require_cuda(*tensors)
    return mask_head_f32_op(pooled, *weights, labels, active)


def _launch(pooled, stream, bf, bd, wl, bl, labels, active) -> Tensor:
    N, M = pooled.shape[:2]
    out = torch.empty((N, 2 * M, 2 * M), dtype=torch.float32, device=pooled.device)
    dev, stream_handle = kernels.device_and_stream(pooled)
    code = kernels.fn("mask_head")(
        pooled.data_ptr(), stream.data_ptr(), bf.data_ptr(), bd.data_ptr(), wl.data_ptr(),
        bl.data_ptr(), labels.data_ptr(), out.data_ptr(),
        None if active is None else active.data_ptr(), N, dev, stream_handle)
    kernels.check(code, "mask_head")
    kernels.LAUNCHES["mask_head"] += 1
    return out


def _fake(pooled, stream, bf, bd, wl, bl, labels, active):
    N, M = pooled.shape[:2]
    return pooled.new_empty((N, 2 * M, 2 * M), dtype=torch.float32)


mask_head_op = kernels.register_op(
    "mask_head", "(Tensor pooled, Tensor stream, Tensor bf, Tensor bd, Tensor wl, Tensor bl, "
                 "Tensor labels, Tensor? active) -> Tensor", _launch, _fake)


def _launch_f32(pooled, stream, bf, bd, wl, bl, labels, active) -> Tensor:
    N, M = pooled.shape[:2]
    out = torch.empty((N, 2 * M, 2 * M), dtype=torch.float32, device=pooled.device)
    # the activations between layers, ping-pong
    work = torch.empty(2 * N * M * M * pooled.shape[3], dtype=torch.float32, device=pooled.device)
    dev, stream_handle = kernels.device_and_stream(pooled)
    code = kernels.fn("mask_head_f32")(
        pooled.data_ptr(), stream.data_ptr(), bf.data_ptr(), bd.data_ptr(), wl.data_ptr(),
        bl.data_ptr(), labels.data_ptr(), out.data_ptr(),
        None if active is None else active.data_ptr(), work.data_ptr(), N, dev, stream_handle)
    kernels.check(code, "mask_head_f32")
    kernels.LAUNCHES["mask_head_f32"] += 1
    return out


mask_head_f32_op = kernels.register_op(
    "mask_head_f32", "(Tensor pooled, Tensor stream, Tensor bf, Tensor bd, Tensor wl, Tensor bl, "
                     "Tensor labels, Tensor? active) -> Tensor", _launch_f32, _fake)
