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


def _build_layer(l, c_in: int) -> nn.Module:
    a = list(l.args)
    if l.module == "Conv":
        k = a[1] if len(a) > 1 else 1
        s = a[2] if len(a) > 2 else 1
        p = a[3] if len(a) > 3 else None
        g = a[4] if len(a) > 4 else 1
        act = a[5] if len(a) > 5 else True
        return L.ConvBnAct(c_in, a[0], k, s, p, g, act)
    if l.module == "C3":
        return L.C3(c_in, a[0], *a[1:])
    if l.module == "Bottleneck":
        return L.Bottleneck(c_in, a[0], *a[1:])
    if l.module == "SPPF":
        return L.SPPF(c_in, a[0], *a[1:])
    if l.module == "Concat":
        return L.Concat()
    if l.module == "Upsample":
        return L.Upsample(*a)
    raise NotImplementedError(f"module {l.module!r} is not ported yet")


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
        distributions: each conv and deconv kernel lecun-normal on its fan-in
        (a normal truncated at ±2 standard deviations, scaled to variance
        1/fan_in), zero biases, BatchNorm scale 1 and shift 0 with running
        statistics 0 / 1, and the Detect prior biases (an anchor-free
        header has none)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                # flax's fan-in: the kernel's (kh, kw, I) for a conv, the
                # deconv's (kh, kw, I) too (its torch layout is (I, O, kh, kw))
                fan_in = w[0].numel() if isinstance(mod, nn.Conv2d) else \
                    w.shape[0] * w[0, 0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978   # truncnorm(-2, 2) std
                t = torch.empty(w.shape).normal_(generator=generator)
                while True:                                  # redraw past ±2
                    bad = t.abs() > 2.0
                    if not bad.any():
                        break
                    t[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
                w.copy_(t * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        for det in self.headers.values():
            if isinstance(det, Detect):
                det.init_det_bias()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: He-normal convs, unit BN with light
        running stats, the Detect focal-style prior biases."""
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = mod.weight[0].numel() if isinstance(mod, nn.Conv2d) else \
                    mod.weight.shape[0] * mod.weight[0, 0].numel()
                w = torch.randn(mod.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.copy_(torch.randn(c, generator=generator) * 0.1)
                mod.running_var.copy_(torch.rand(c, generator=generator) * 0.5 + 0.75)
        for det in self.headers.values():
            if isinstance(det, Detect):
                det.init_det_bias()
