"""Model container: backbone → neck → headers (``Detect``, or
``AnchorFreeDetect`` for an ``AFDetect`` row), from a parsed spec (port of
``hd_yolo_tpu/models/yolo.py``).

``forward`` is the inference path (no autograd); ``losses`` is the training
forward (``model.train()``: BatchNorm on batch statistics, losses only) and
the validation forward with targets (``model.eval()``: losses and outputs).
A model is built in eval mode.

The module tree uses the reference torch key layout — ``backbone.i``,
``neck.j``, ``headers.<tag>`` — so converted flax weights and reference
``state_dict`` files load with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from . import layers as L
from .anchor_free_head import AnchorFreeDetect
from .builder import NetworkSpec, parse_model_cfg
from .detect_head import Detect

Tensor = torch.Tensor


# rows built as ``module(c_in, *args)`` (the JAX package's args after the
# input channels, which flax infers) and as ``module(*args)``
_WITH_C_IN = {
    "DWConv": L.DWConv, "Bottleneck": L.Bottleneck, "BottleneckCSP": L.BottleneckCSP,
    "C3": L.C3, "C3TR": L.C3TR, "C3SPP": L.C3SPP, "C3Ghost": L.C3Ghost, "SPP": L.SPP,
    "SPPF": L.SPPF, "Focus": L.Focus, "GhostConv": L.GhostConv,
    "GhostBottleneck": L.GhostBottleneck, "CrossConv": L.CrossConv, "MixConv2d": L.MixConv2d,
    "BatchNorm2d": L.BatchNorm2d,
}
_NO_C_IN = {
    "Contract": L.Contract, "Expand": L.Expand, "Concat": L.Concat, "Upsample": L.Upsample,
    "MaxPool2d": L.MaxPool2d, "ZeroPad2d": L.ZeroPad2d,
}


def _build_layer(l, c_in: int) -> nn.Module:
    a = list(l.args)
    if l.module == "Conv":
        k = a[1] if len(a) > 1 else 1
        s = a[2] if len(a) > 2 else 1
        p = a[3] if len(a) > 3 else None
        g = a[4] if len(a) > 4 else 1
        act = a[5] if len(a) > 5 else True
        return L.ConvBnAct(c_in, a[0], k, s, p, g, act)
    if l.module in _WITH_C_IN:
        return _WITH_C_IN[l.module](c_in, *a)
    if l.module in _NO_C_IN:
        return _NO_C_IN[l.module](*a)
    raise KeyError(f"unknown module {l.module!r} at layer {l.index}")


class Model(nn.Module):
    """Config-driven multi-task detector.

    Construct via ``Model.from_cfg('yolov5l6-mask', 'hyp-nuclei')``.
    ``dtype`` is the compute dtype of the activations; parameters stay f32.
    """

    def __init__(self, spec: NetworkSpec, dtype: torch.dtype = torch.float32,
                 pre_nms_topk: int = 1024, max_masks: int = 100, dim_reduced: int = 256,
                 mask_window: Optional[int] = None, mask_budget: Optional[int] = None,
                 mask_rois: int = 64):
        super().__init__()
        self.spec = spec
        self.dtype = dtype
        ch: Dict[int, int] = {}
        mods: List[nn.Module] = []
        for l in spec.layers:
            if l.from_idx == -1:
                c_in = ch[l.index - 1] if l.index > 0 else spec.ch_in
            elif isinstance(l.from_idx, int):
                c_in = ch[l.from_idx]
            else:
                c_in = sum(ch[l.index - 1] if j == -1 else ch[j] for j in l.from_idx)
            if l.n > 1:
                mod = nn.Sequential(*(_build_layer(l, c_in if r == 0 else l.out_channels)
                                      for r in range(l.n)))
            else:
                mod = _build_layer(l, c_in)
            mods.append(mod)
            ch[l.index] = l.out_channels
        self.backbone = nn.ModuleList(mods[: spec.n_backbone])
        self.neck = nn.ModuleList(mods[spec.n_backbone:])
        self.headers = nn.ModuleDict({
            h.tag: AnchorFreeDetect(h, pre_nms_topk=pre_nms_topk) if h.kind == "anchor_free"
            else Detect(h, pre_nms_topk=pre_nms_topk, max_masks=max_masks,
                        dim_reduced=dim_reduced, mask_window=mask_window,
                        mask_budget=mask_budget, mask_rois=mask_rois)
            for h in spec.headers
        })
        self.eval()

    @classmethod
    def from_cfg(cls, cfg, hyp=None, **kwargs) -> "Model":
        return cls(parse_model_cfg(cfg, hyp), **kwargs)

    @property
    def blocks(self) -> List[nn.Module]:
        return list(self.backbone) + list(self.neck)

    def trunk(self, x: Tensor) -> Dict[int, Tensor]:
        """backbone + neck on an NHWC batch; returns {layer_idx: feature} for
        the saved indices, as NCHW tensors in channels-last memory.  An
        integer (uint8) batch is divided by 255 at entry."""
        if not x.is_floating_point():
            x = x.float() / 255.0
        cur = x.permute(0, 3, 1, 2)              # NCHW view of the NHWC bytes
        saved: Dict[int, Tensor] = {}
        save = set(self.spec.save)
        for l, mod in zip(self.spec.layers, self.blocks):
            if l.from_idx == -1:
                inp = cur
            elif isinstance(l.from_idx, int):
                inp = saved[l.from_idx]
            else:
                inp = [cur if j == -1 else saved[j] for j in l.from_idx]
            if isinstance(mod, L.ConvBnAct):
                cur = mod(inp, dtype=self.dtype)
            else:
                cur = mod(inp.to(self.dtype) if torch.is_tensor(inp) else inp)
            if l.index in save:
                saved[l.index] = cur
        return saved

    @torch.no_grad()
    def forward(self, x: Tensor, compute_masks: bool = True) -> Dict[str, Dict[str, Tensor]]:
        """(B, H, W, 3) batch → {task: inference outputs}."""
        feats = self.trunk(x)
        return {
            h.tag: self.headers[h.tag]([feats[j] for j in h.from_idx], compute_masks=compute_masks)
            for h in self.spec.headers
        }

    def losses(self, x: Tensor, targets: Dict[str, Dict[str, Tensor]],
               compute_masks: bool = True):
        """(B, H, W, 3) batch and {task: targets} → ({task: losses}, {task:
        outputs}): outputs are empty in training mode (``model.train()``)
        and the inference outputs in eval mode."""
        feats = self.trunk(x)
        losses, outputs = {}, {}
        for h in self.spec.headers:
            losses[h.tag], outputs[h.tag] = self.headers[h.tag].losses(
                [feats[j] for j in h.from_idx], targets[h.tag], compute_masks=compute_masks)
        return losses, outputs

    @staticmethod
    def total_loss(losses: Dict[str, Dict], mask_weight: float = 1.0) -> Tensor:
        """Σ over tasks of det + mask loss."""
        total = 0.0
        for task_losses in losses.values():
            total = total + task_losses["det_loss"] + mask_weight * task_losses["mask_loss"]
        return total

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded weights for training from scratch, from flax's default
        distributions: each conv, deconv and dense kernel (an attention's
        projections too) lecun-normal on its fan-in (a normal truncated at
        ±2 standard deviations, scaled to variance 1/fan_in), zero biases,
        BatchNorm scale 1 and shift 0 with running statistics 0 / 1, and the
        Detect prior biases (an anchor-free header has none)."""
        def lecun(w: Tensor, fan_in: int) -> None:
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978   # truncnorm(-2, 2) std
            t = torch.empty(w.shape).normal_(generator=generator)
            while True:                                  # redraw past ±2
                bad = t.abs() > 2.0
                if not bad.any():
                    break
                t[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
            w.copy_(t * std)

        for mod in self.modules():
            for w, fan_in in _kernels(mod):
                lecun(w, fan_in)
            if isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            else:
                for name, b in mod.named_parameters(recurse=False):
                    if name.endswith("bias"):
                        b.zero_()
        for det in self.headers.values():
            if isinstance(det, Detect):
                det.init_det_bias()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: He-normal kernels, unit BN with light
        running stats, the Detect focal-style prior biases."""
        for name, mod in self.named_modules():
            for w, fan_in in _kernels(mod):
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            if isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.copy_(torch.randn(c, generator=generator) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=generator) * 0.5 + 0.75)
            else:
                for pname, b in mod.named_parameters(recurse=False):
                    if pname.endswith("bias"):
                        b.zero_()
        for det in self.headers.values():
            if isinstance(det, Detect):
                det.init_det_bias()


def _kernels(mod: nn.Module):
    """(kernel, flax fan-in) of a module's own weights: a conv's kernel
    (kh, kw, I), a deconv's too (its torch layout is (I, O, kh, kw)), a
    dense layer's inputs, and each of an attention's q / k / v input
    projections (rows of ``in_proj_weight``) on the embedding width."""
    if isinstance(mod, nn.Conv2d):
        yield mod.weight, mod.weight[0].numel()
    elif isinstance(mod, nn.ConvTranspose2d):
        yield mod.weight, mod.weight.shape[0] * mod.weight[0, 0].numel()
    elif isinstance(mod, nn.Linear):
        yield mod.weight, mod.weight.shape[1]
    elif isinstance(mod, nn.MultiheadAttention):
        yield mod.in_proj_weight, mod.in_proj_weight.shape[1]
