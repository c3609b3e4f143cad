"""Fused inference mask head on the card: wrapper of ``kernels/mask_head.cu``
(the Hopper port of ``hd_yolo_tpu/ops/pallas_mask_head.py``).

``fused_mask_probs(head, pooled, labels)`` computes
``sigmoid(MaskHead(pooled))[..., label]`` per ROI as (N, 2M, 2M) f32.  On a
CUDA tensor the kernel runs the whole chain (4 convs, deconv, selected
logits, sigmoid); on a CPU tensor the plain version below runs the same
function with the same rounding points: each GEMM on compute-dtype
operands with f32 accumulation, the accumulator rounded to the compute
dtype before the bias add, the selected-logit dot in f32.

Deconv weights: the reference layout ``conv5_mask.weight`` (I, O, 2, 2)
gives ``out[2i+dy, 2j+dx] = x[i, j] · W[:, :, dy, dx]`` — the flax kernel
already flipped back by ``utils/convert.py``.
"""

from __future__ import annotations

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
    """The kernel's operand layouts: wf (4, 9, co, ci), bf (4, C), wd (4, co, ci)
    with d = dy*2+dx, bd (C,), all in ``cd``."""
    wf = torch.stack([c.weight.permute(2, 3, 0, 1).reshape(9, c.out_channels, c.in_channels)
                      for c in head.fcn]).to(cd).contiguous()
    bf = torch.stack([c.bias for c in head.fcn]).to(cd).contiguous()
    deconv = head.maskrcnn_preds.conv5_mask
    wd = deconv.weight.permute(2, 3, 1, 0).reshape(4, deconv.out_channels,
                                                   deconv.in_channels).to(cd).contiguous()
    return wf, bf, wd, deconv.bias.to(cd).contiguous()


def fused_mask_probs_plain(head, pooled: Tensor, labels: Tensor) -> Tensor:
    wl_sel, bl_sel = _selected_logits(head, labels.to(torch.int64), pooled.dtype)
    o = mask_head_plain(head, pooled, wl_sel) + bl_sel[:, None, None, None]
    return _deinterleave(torch.sigmoid(o))


def fused_mask_probs(head, pooled: Tensor, labels: Tensor) -> Tensor:
    """MaskHead → sigmoid → per-ROI channel select, fused.

    head: ``models/detect_head.MaskHead``; pooled (N, M, M, C); labels (N,)
    mask-channel index (≥ 0).  Returns (N, 2M, 2M) f32 probabilities."""
    if pooled.device.type == "cpu":
        return fused_mask_probs_plain(head, pooled, labels)
    labels = labels.to(torch.int64)
    N, M, M2, C = pooled.shape
    if pooled.dtype != torch.bfloat16 or (M, M2, C) != (14, 14, 256):
        raise ValueError(f"mask head kernel takes (N, 14, 14, 256) bf16, got "
                         f"{tuple(pooled.shape)} {pooled.dtype}")
    pooled = pooled.contiguous()
    wf, bf, wd, bd = cached(head, "kernel_weights", tuple(head.parameters()),
                            lambda: kernel_weights(head))
    wl_sel, bl_sel = _selected_logits(head, labels, torch.bfloat16)
    wl_sel, bl_sel = wl_sel.contiguous(), bl_sel.contiguous()
    kernels.require_cuda(pooled, wf, bf, wd, bd, wl_sel, bl_sel)
    out = torch.empty((N, 2 * M, 2 * M), dtype=torch.float32, device=pooled.device)
    dev, stream = kernels.device_and_stream(pooled)
    code = kernels.fn("mask_head")(
        pooled.data_ptr(), wf.data_ptr(), bf.data_ptr(), wd.data_ptr(), bd.data_ptr(),
        wl_sel.data_ptr(), bl_sel.data_ptr(), out.data_ptr(), N, dev, stream)
    kernels.check(code, "mask_head")
    kernels.LAUNCHES["mask_head"] += 1
    return out
