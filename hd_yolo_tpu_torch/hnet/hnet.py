"""HNet container, inference (port of ``hd_yolo_tpu/hnet/hnet.py``): Swin
backbone → FPN → per-task headers at their own amplifications.

``HNet.from_cfg(load_cfg("hnet-nucls"), dtype=torch.bfloat16)`` builds the
model on the card with seeded weights; ``forward(x)`` takes a (B, H, W, 3)
batch (uint8 is divided by 255) and returns ``(losses, outputs)`` as
``HNet.apply(..., train=False)`` does: ``losses[task] == {}`` and, per task,

* ``maskrcnn`` — the tile-grid pass of the JAX ``_maskrcnn_task``: the image
  is cut into ``roi_size`` windows, each window is ROI-aligned from every
  pyramid level at the task amplification (``extract_roi_feature_maps``,
  the single-level ROI-align kernel), the header runs on that virtual batch
  and its boxes are projected back to image pixels: ``boxes``, ``scores``,
  ``labels``, ``valid``, ``masks``;
* ``panoptic`` — ``probs`` and ``logits`` over the pyramid resized by the
  amplification (bilinear, antialiased);
* ``cl`` — ``probs`` and ``logits`` from the coarsest resized level.

On the card the mask branch runs the mask-head kernel, which takes bf16
ROIs of 256 channels (``fpn.out_channels`` 256).  Not ported yet, and
raising when asked for: training (``targets``: the losses, constrain
modules and mosaic), the ``darknet`` backbone, the ``fcos`` header and
keypoints.  A config's ``constrains`` are training-only and ignored here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..detector import resolve_device
from ..wsi.tiling import sliding_window_grid
from .feature_mosaic import extract_roi_feature_maps
from .fpn import FeaturePyramidNetwork
from .heads import ClassificationHead, PanopticSegHead
from .layers import resize_bilinear
from .mask_rcnn import MaskRCNN
from .swin import SwinTransformer

Tensor = torch.Tensor


class HNet(nn.Module):
    """``HNet(cfg, dtype, device)`` builds the model with torch's default
    init on ``device`` (CUDA by default; raises when CUDA is missing), to
    load a state dict into; ``HNet.from_cfg`` gives it seeded weights."""

    def __init__(self, cfg: Dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        b = cfg.get("backbone", {"type": "swin"})
        if b.get("type", "swin") != "swin":
            raise NotImplementedError(f"backbone type {b.get('type')!r} is not ported yet "
                                      "(the port has the swin backbone)")
        depths = tuple(b.get("depths", (2, 2, 6, 2)))
        self.backbone = SwinTransformer(
            embed_dim=b.get("embed_dim", 96), depths=depths,
            num_heads=tuple(b.get("num_heads", (3, 6, 12, 24))),
            window_size=b.get("window_size", 7))
        # one pyramid level per swin stage (stride 4 · 2^stage)
        self.backbone_strides = tuple(4.0 * 2.0 ** i for i in range(len(depths)))

        f = cfg.get("fpn", {})
        self.fpn_type = f.get("type", "fpn")
        if self.fpn_type not in ("fpn", "dynamic"):
            raise ValueError(f"unknown fpn type {self.fpn_type!r}")
        C = f.get("out_channels", 256)
        self.fpn = FeaturePyramidNetwork(self.backbone.channels, C, f.get("extra_blocks", 0))

        self.header_cfg = cfg.get("headers", {})
        headers = {}
        for task, h in self.header_cfg.items():
            kind = h.get("type", "maskrcnn")
            if kind == "maskrcnn":
                if h.get("num_keypoints", 0) > 0:
                    raise NotImplementedError("Mask R-CNN keypoints are not ported yet")
                headers[task] = MaskRCNN(
                    C, h["num_classes"], strides=self.backbone_strides,
                    anchor_sizes=tuple(h.get("anchor_sizes", (32.0, 64.0, 128.0, 256.0))),
                    pre_nms_topk=h.get("pre_nms_topk", 1024),
                    num_proposals=h.get("num_proposals", 256),
                    num_detections=h.get("num_detections", 100),
                    with_masks=h.get("with_masks", True))
            elif kind == "panoptic":
                headers[task] = PanopticSegHead(C, h["num_classes"], h.get("channels", 128),
                                                int(h.get("scale_factor", 1)),
                                                self.fpn.num_outputs)
            elif kind in ("cl", "classification"):
                headers[task] = ClassificationHead(C, h["num_classes"], h.get("hidden", 256))
            elif kind == "fcos":
                raise NotImplementedError(f"header {task!r}: the fcos header is not ported yet")
            else:
                raise ValueError(f"unknown header type {kind!r}")
        self.headers = nn.ModuleDict(headers)
        self.eval().to(device)

    @classmethod
    def from_cfg(cls, cfg: Dict, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda", seed: int = 0) -> "HNet":
        """The model for ``cfg`` with seeded random weights (``seed``), in eval
        mode on ``device`` (CUDA by default; raises when CUDA is missing).
        ``dtype`` is the compute dtype; parameters stay f32 masters."""
        model = cls(cfg, dtype, device)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights: He-normal convs, N(0, 0.02) linear layers
        and relative-position tables, unit norms, zero biases."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 * math.sqrt(2.0 / fan_in))
            elif isinstance(mod, nn.ConvTranspose2d):
                fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator)
                                 * math.sqrt(2.0 / fan_in))
            elif isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * 0.02)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.LayerNorm,
                                nn.GroupNorm)) and mod.bias is not None:
                mod.bias.zero_()
        for name, p in self.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    # ---------------------------------------------------------- amplification
    def extract_amplified(self, feats: Sequence[Tensor], amp: float) -> List[Tensor]:
        """Whole-pyramid resample for the dense headers (at least one cell)."""
        if amp == 1.0:
            return list(feats)
        return [resize_bilinear(f, (max(int(f.shape[1] * amp), 1), max(int(f.shape[2] * amp), 1)))
                for f in feats]

    def _virtual_size(self, win: int, amp: float) -> Tuple[int, int]:
        """(level-0 cells, virtual px) of a win-px window rendered at amp×."""
        stride0 = float(self.backbone_strides[0])
        cells = max(int(round(win / stride0 * amp)), 1)
        return cells, int(cells * stride0)

    def _roi_pyramids(self, feats: Sequence[Tensor], rois_px: Tensor, win: int, amp: float):
        """(B, R, 4) px ROIs pooled from every level at the task amplification
        → (per level (B·R, S_l, S_l, C), virtual px size).  'fpn': crops of the
        fused pyramid; 'dynamic': the FPN runs on crops of the raw levels."""
        cells, v_px = self._virtual_size(win, amp)
        if self.fpn_type == "dynamic":
            return self.fpn.forward_rois(feats, rois_px, self.backbone_strides, cells), v_px
        pyr = extract_roi_feature_maps(feats, rois_px, self.backbone_strides, roi_size=cells)
        B, R = rois_px.shape[:2]
        return [p.reshape((B * R,) + p.shape[2:]) for p in pyr], v_px

    def _tiles(self, H: int, W: int, win: int, device) -> Tensor:
        """(Nt, 4) xyxy px windows of the static tile grid, made once per
        image size and device."""
        cache = self.__dict__.setdefault("_tile_cache", {})
        key = (H, W, win, str(device))
        if key not in cache:
            origins = torch.as_tensor(sliding_window_grid(H, W, tile=win, overlap=0),
                                      dtype=torch.float32).flip(-1)            # (Nt, 2) x, y
            cache[key] = torch.cat([origins, origins + float(win)], -1).to(device)
        return cache[key]

    def _maskrcnn_task(self, header: MaskRCNN, hcfg: Dict, feats: Sequence[Tensor],
                       img_hw: Tuple[int, int]) -> Dict[str, Tensor]:
        """Tile-grid inference, projected back to the image frame."""
        H, W = img_hw
        amp = float(hcfg.get("amplification", 1.0))
        win = min(int(hcfg.get("roi_size") or min(H, W)), H, W)
        B = feats[0].shape[0]
        tiles = self._tiles(H, W, win, feats[0].device)
        nt = tiles.shape[0]
        pyr, v_px = self._roi_pyramids(feats, tiles[None].expand(B, nt, 4), win, amp)
        o = header.infer(pyr, (v_px, v_px))
        K = o["boxes"].shape[1]
        shift = tiles[:, :2].repeat(1, 2)                      # (Nt, 4) x, y, x, y origin
        boxes = o["boxes"].reshape(B, nt, K, 4) * (float(win) / float(v_px)) + shift[None, :, None]
        o = {k: v.reshape((B, nt * K) + v.shape[2:]) for k, v in o.items()}
        o["boxes"] = boxes.reshape(B, nt * K, 4)
        return o

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, x: Tensor, targets: Optional[Dict] = None):
        """(B, H, W, 3) batch → (losses, outputs), inference only."""
        if targets is not None:
            raise NotImplementedError("HNet training (losses, constrain modules, mosaic) is not "
                                      "ported yet; forward takes no targets")
        H, W = x.shape[1:3]
        if not x.is_floating_point():
            x = x.float() / 255.0
        raw = self.backbone(x.to(self.dtype))
        dense_tasks = any(not isinstance(h, MaskRCNN) for h in self.headers.values())
        feats = self.fpn(raw) if (self.fpn_type == "fpn" or dense_tasks) else raw
        det_feats = raw if self.fpn_type == "dynamic" else feats

        losses: Dict[str, Dict] = {}
        outputs: Dict[str, Dict[str, Tensor]] = {}
        for task, header in self.headers.items():
            if isinstance(header, MaskRCNN):
                outputs[task] = self._maskrcnn_task(header, self.header_cfg[task], det_feats,
                                                    (H, W))
            else:
                amp = float(self.header_cfg[task].get("amplification", 1.0))
                outputs[task] = header(self.extract_amplified(feats, amp))
            losses[task] = {}
        return losses, outputs
