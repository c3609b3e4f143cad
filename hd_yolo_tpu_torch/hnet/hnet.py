"""HNet container (port of ``hd_yolo_tpu/hnet/hnet.py``): a Swin or darknet
backbone → FPN → per-task headers at their own amplifications, and the
cross-header constrain losses in training.

``HNet.from_cfg(load_cfg("hnet-nucls"), dtype=torch.bfloat16)`` builds the
model on the card with seeded weights; ``forward(x, targets=None)`` takes a
(B, H, W, 3) batch (uint8 is divided by 255) and returns ``(losses,
outputs)`` as ``HNet.apply`` does.  Per task:

* ``maskrcnn`` — pass 1, the tile-grid inference of the JAX
  ``_maskrcnn_task``: the image is cut into ``roi_size`` windows, each
  window is ROI-aligned from every pyramid level at the task amplification
  (``extract_roi_feature_maps``, the single-level ROI-align kernel), the
  header runs on that virtual batch and its boxes (and keypoints) are
  projected back to image pixels: ``boxes``, ``scores``, ``labels``,
  ``valid``, ``masks``, with ``num_keypoints`` > 0 ``keypoints``.  With
  targets, pass 2 pools the annotation ROIs (``targets[task]['rois']``
  with ``roi_valid``, else the whole image), projects the GT boxes and
  keypoints into each ROI's virtual frame (``_project_gt_to_rois``) and
  computes the header's losses (``rpn_obj_loss``, ``rpn_reg_loss``,
  ``roi_cls_loss``, ``roi_reg_loss``, ``mask_loss``, ``keypoint_loss``);
* ``fcos`` — the same double pass with the FCOS header (``boxes``,
  ``scores``, ``labels``, ``valid``; ``fcos_cls_loss``, ``fcos_reg_loss``,
  ``fcos_ctr_loss``);
* ``panoptic`` — ``probs`` and ``logits`` over the pyramid resized by the
  amplification (bilinear, antialiased); with a ``seg_map`` target,
  ``seg_loss``;
* ``cl`` — ``probs`` and ``logits`` from the coarsest resized level; with a
  ``label`` target, ``cl_loss``.

With targets, each entry of the config's ``constrains`` adds
``losses['constrains'][id]``: the confliction loss between a seg task's
probabilities and a det task's detections (box-mean, or mask-weighted with
``weighting: mask``).  Without targets the forward runs under
``torch.no_grad``; with them it is differentiable (``train()`` turns on
the backbone's drop path and dropouts, drawn from the ``generator`` given),
and pass 1 keeps the gradients of the detections' scores and masks that
the constrain losses use.  ``total_loss`` weighs the terms as JAX does.

The ``darknet`` backbone (``DarkNetBackbone``) is the yolo layer kit's CSP
trunk at ``width`` and ``depth``, levels /8, /16, /32; in eval mode its
first layer is the stem kernel (the f32 image in, the compute dtype out),
in training mode its BatchNorms use the batch's statistics and update
their running ones.  On the card inference runs the mask-head kernel,
which takes bf16 ROIs of 256 channels (``fpn.out_channels`` 256); a
differentiable forward runs the cuDNN chain instead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..detector import resolve_device
from ..models.layers import C3, ConvBnAct
from ..wsi.tiling import sliding_window_grid
from .fcos import FCOS
from .feature_mosaic import extract_roi_feature_maps
from .fpn import FeaturePyramidNetwork
from .heads import (ClassificationHead, ConstrainModule, DynamicConstrainModule,
                    PanopticSegHead)
from .layers import resize_bilinear
from .mask_rcnn import MaskRCNN
from .swin import SwinTransformer

Tensor = torch.Tensor


class DarkNetBackbone(nn.Module):
    """The CSP trunk of the yolo layer kit: a 6x6/s2 ``ConvBnAct`` stem, then
    four [3x3/s2 ``ConvBnAct``, ``C3``] stages on channels ``c(v) =
    max(int(v · width // 8) · 8, 8)`` of 64..1024 and ``max(round(3 ·
    depth), 1)`` bottlenecks; the outputs of the last three stages (/8, /16,
    /32) as NHWC levels.  ``layers`` is that sequence; ``dtype`` the compute
    dtype (the stem takes the f32 image)."""

    def __init__(self, width: float = 0.5, depth: float = 0.33,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = lambda v: max(int(v * width // 8) * 8, 8)                        # noqa: E731
        n = max(round(3 * depth), 1)
        layers, c_in = [ConvBnAct(3, c(64), 6, 2, 2)], c(64)
        for ch in (128, 256, 512, 1024):
            layers += [ConvBnAct(c_in, c(ch), 3, 2), C3(c(ch), c(ch), n)]
            c_in = c(ch)
        self.layers = nn.ModuleList(layers)
        self.channels = tuple(c(ch) for ch in (256, 512, 1024))

    def forward(self, x: Tensor, generator=None) -> List[Tensor]:
        """(B, H, W, 3) f32 → [(B, H/8, W/8, c(256)), /16, /32] in ``dtype``."""
        y = self.layers[0](x.float().permute(0, 3, 1, 2), dtype=self.dtype)
        outs = []
        for i in range(1, len(self.layers), 2):
            y = self.layers[i + 1](self.layers[i](y))
            if i >= 3:
                outs.append(y.permute(0, 2, 3, 1).contiguous())
        return outs


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
        self.stochastic = False
        if b.get("type", "swin") == "swin":
            depths = tuple(b.get("depths", (2, 2, 6, 2)))
            self.backbone = SwinTransformer(
                embed_dim=b.get("embed_dim", 96), depths=depths,
                num_heads=tuple(b.get("num_heads", (3, 6, 12, 24))),
                window_size=b.get("window_size", 7),
                drop_path_rate=b.get("drop_path_rate", 0.0), drop_rate=b.get("drop_rate", 0.0),
                attn_drop_rate=b.get("attn_drop_rate", 0.0))
            self.stochastic = any(b.get(k, 0.0) > 0 for k in ("drop_path_rate", "drop_rate",
                                                              "attn_drop_rate"))
            # one pyramid level per swin stage (stride 4 · 2^stage)
            self.backbone_strides = tuple(4.0 * 2.0 ** i for i in range(len(depths)))
        else:
            self.backbone = DarkNetBackbone(b.get("width", 0.5), b.get("depth", 0.33), dtype)
            self.backbone_strides = (8.0, 16.0, 32.0)

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
                headers[task] = MaskRCNN(
                    C, h["num_classes"], strides=self.backbone_strides,
                    anchor_sizes=tuple(h.get("anchor_sizes", (32.0, 64.0, 128.0, 256.0))),
                    pre_nms_topk=h.get("pre_nms_topk", 1024),
                    num_proposals=h.get("num_proposals", 256),
                    num_detections=h.get("num_detections", 100),
                    with_masks=h.get("with_masks", True),
                    num_keypoints=h.get("num_keypoints", 0))
            elif kind == "fcos":
                headers[task] = FCOS(
                    C, h["num_classes"], strides=self.backbone_strides,
                    pre_nms_topk=h.get("pre_nms_topk", 512),
                    num_detections=h.get("num_detections", 100),
                    score_thresh=h.get("score_thresh", 0.05), nms_thresh=h.get("nms_thresh", 0.5),
                    size_base=h.get("size_base", 64.0))
            elif kind == "panoptic":
                headers[task] = PanopticSegHead(C, h["num_classes"], h.get("channels", 128),
                                                int(h.get("scale_factor", 1)),
                                                self.fpn.num_outputs)
            elif kind in ("cl", "classification"):
                headers[task] = ClassificationHead(C, h["num_classes"], h.get("hidden", 256))
            else:
                raise ValueError(f"unknown header type {kind!r}")
        self.headers = nn.ModuleDict(headers)
        self.constrain_cfg = cfg.get("constrains", {})
        self.constrains = nn.ModuleDict({
            cid: DynamicConstrainModule(c["edges"], c.get("values", ()))
            if c.get("weighting") == "mask" else ConstrainModule(c["edges"])
            for cid, c in self.constrain_cfg.items()})
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
        and relative-position tables, unit norms, zero biases; an FCOS
        header JAX's own init (``FCOS.reset_parameters``)."""
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
        for h in self.headers.values():
            if isinstance(h, FCOS):
                h.reset_parameters(generator)

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

    def _tile_rois(self, H: int, W: int, win: int, B: int, device) -> Tensor:
        """(B, Nt, 4) the tile grid's windows for each image, contiguous (the
        ROI-align kernels read boxes packed: an expanded view would cost a
        copy a call), made once per image size, batch and device."""
        cache = self.__dict__.setdefault("_tile_cache", {})
        key = (H, W, win, B, str(device))
        if key not in cache:
            cache[key] = self._tiles(H, W, win, device)[None].expand(B, -1, 4).contiguous()
        return cache[key]

    def _project_gt_to_rois(self, t: Dict[str, Tensor], rois_px: Tensor,
                            img_hw: Tuple[int, int], v_px: int) -> Dict[str, Tensor]:
        """Image-frame GT → per-ROI virtual-frame targets of the (B·R) ROI
        batch: a GT lands in a ROI when its centre is inside; its box is
        clipped to the ROI and rescaled to the v_px frame, and kept when
        wider and taller than 1 px; labels and masks follow every ROI of
        their image."""
        H, W = img_hw
        dev = rois_px.device
        gt = t["boxes"].float() * torch.tensor([W, H, W, H], dtype=torch.float32, device=dev)
        B, R = rois_px.shape[:2]
        T = gt.shape[1]
        r = rois_px.float()
        sw = v_px / (r[..., 2] - r[..., 0]).clamp(min=1e-6)
        sh = v_px / (r[..., 3] - r[..., 1]).clamp(min=1e-6)
        origin = torch.stack([r[..., 0], r[..., 1], r[..., 0], r[..., 1]], -1)[:, :, None]
        local = (gt[:, None] - origin) * torch.stack([sw, sh, sw, sh], -1)[:, :, None]
        cx = (local[..., 0] + local[..., 2]) * 0.5
        cy = (local[..., 1] + local[..., 3]) * 0.5
        inside = (cx >= 0) & (cx < v_px) & (cy >= 0) & (cy < v_px)
        clipped = local.clamp(0.0, float(v_px))
        ok = (t["valid"].bool()[:, None] & inside & (clipped[..., 2] - clipped[..., 0] > 1.0)
              & (clipped[..., 3] - clipped[..., 1] > 1.0))
        boxes = torch.where(ok[..., None], clipped / v_px, torch.zeros_like(clipped))
        out = {"boxes": boxes.reshape(B * R, T, 4), "valid": ok.reshape(B * R, T),
               "labels": t["labels"][:, None].expand(B, R, T).reshape(B * R, T)}
        if "keypoints" in t:
            # normalised image-frame (x, y, visibility) → the ROI's virtual
            # frame; a point outside the ROI loses its visibility
            kp = t["keypoints"].float()                                      # (B, T, nk, 3)
            kp_px = kp[..., :2] * torch.tensor([W, H], dtype=torch.float32, device=dev)
            scale = torch.stack([sw, sh], -1)[:, :, None, None]
            klocal = (kp_px[:, None] - r[..., :2][:, :, None, None]) * scale  # (B, R, T, nk, 2)
            kin = ((klocal >= 0) & (klocal < v_px)).all(-1)
            kvis = kp[..., 2][:, None] * kin
            out["keypoints"] = torch.cat([klocal / v_px, kvis[..., None]], -1).reshape(
                (B * R,) + kp.shape[1:])
        if "masks" in t:
            m = t["masks"]
            out["masks"] = m[:, None].expand((B, R) + m.shape[1:]).reshape((B * R,) + m.shape[1:])
        return out

    def _maskrcnn_task(self, header: Union[MaskRCNN, FCOS], hcfg: Dict,
                       feats: Sequence[Tensor], img_hw: Tuple[int, int],
                       t: Optional[Dict[str, Tensor]] = None):
        """Pass 1, tile-grid inference projected back to the image frame;
        with targets ``t``, pass 2, the losses over the annotation ROIs →
        (losses, outputs).  The detection headers' double pass (Mask R-CNN
        and FCOS)."""
        H, W = img_hw
        amp = float(hcfg.get("amplification", 1.0))
        win = min(int(hcfg.get("roi_size") or min(H, W)), H, W)
        B = feats[0].shape[0]
        tiles = self._tiles(H, W, win, feats[0].device)
        nt = tiles.shape[0]
        pyr, v_px = self._roi_pyramids(feats, self._tile_rois(H, W, win, B, tiles.device), win,
                                       amp)
        o = header.infer(pyr, (v_px, v_px))
        K = o["boxes"].shape[1]
        shift = tiles[:, :2].repeat(1, 2)                      # (Nt, 4) x, y, x, y origin
        scale = float(win) / float(v_px)
        boxes = o["boxes"].reshape(B, nt, K, 4) * scale + shift[None, :, None]
        o = {k: v.reshape((B, nt * K) + v.shape[2:]) for k, v in o.items()}
        o["boxes"] = boxes.reshape(B, nt * K, 4)
        if "keypoints" in o:
            # the keypoints share the boxes' frame: the same scale and tile
            # origin for x, y; the score as it is
            kp = o["keypoints"].reshape((B, nt, K) + o["keypoints"].shape[2:])
            kxy = kp[..., :2] * scale + tiles[None, :, None, None, :2]
            o["keypoints"] = torch.cat([kxy, kp[..., 2:]], -1).reshape((B, nt * K) + kp.shape[3:])

        losses: Dict[str, Tensor] = {}
        if t is not None:
            dev = feats[0].device
            if "rois" in t:
                ann = t["rois"].float()
                roi_valid = t.get("roi_valid")
                if roi_valid is None:
                    roi_valid = torch.ones(ann.shape[:2], dtype=torch.bool, device=dev)
            else:                                      # the whole image as the one ROI
                ann = torch.tensor([[[0.0, 0.0, float(W), float(H)]]] * B, device=dev)
                roi_valid = torch.ones((B, 1), dtype=torch.bool, device=dev)
            pyr_l, v_l = self._roi_pyramids(feats, ann, win, amp)
            losses = header.compute_losses(pyr_l, (v_l, v_l),
                                           self._project_gt_to_rois(t, ann, (H, W), v_l),
                                           image_weight=roi_valid.reshape(-1).float())
        return losses, o

    # --------------------------------------------------------------- forward
    def forward(self, x: Tensor, targets: Optional[Dict] = None, generator=None,
                compute_masks: bool = True):
        """(B, H, W, 3) batch [, {task: targets}] → (losses, outputs);
        without targets under ``torch.no_grad``.  ``compute_masks`` is
        accepted for the engines and ignored, as in JAX: masks follow each
        header's ``with_masks``."""
        if targets is None:
            with torch.no_grad():
                return self._forward(x, None, generator)
        return self._forward(x, targets, generator)

    def losses(self, x: Tensor, targets: Dict, compute_masks: bool = True, generator=None):
        """The training step's entry: ``forward(x, targets)``."""
        return self._forward(x, targets, generator)

    def _forward(self, x: Tensor, targets: Optional[Dict], generator):
        H, W = x.shape[1:3]
        if not x.is_floating_point():
            x = x.float() / 255.0
        # the darknet stem takes the f32 image (the stem kernel rounds it)
        raw = self.backbone(x if isinstance(self.backbone, DarkNetBackbone) else x.to(self.dtype),
                            generator)
        dense_tasks = any(not isinstance(h, (MaskRCNN, FCOS)) for h in self.headers.values())
        feats = self.fpn(raw) if (self.fpn_type == "fpn" or dense_tasks) else raw
        det_feats = raw if self.fpn_type == "dynamic" else feats

        losses: Dict[str, Dict] = {}
        outputs: Dict[str, Dict[str, Tensor]] = {}
        for task, header in self.headers.items():
            hcfg = self.header_cfg[task]
            t = targets.get(task) if targets is not None else None
            if isinstance(header, (MaskRCNN, FCOS)):
                losses[task], outputs[task] = self._maskrcnn_task(header, hcfg, det_feats, (H, W),
                                                                  t)
            else:
                key = "label" if isinstance(header, ClassificationHead) else "seg_map"
                losses[task], outputs[task] = header(
                    self.extract_amplified(feats, float(hcfg.get("amplification", 1.0))),
                    None if t is None else t.get(key))

        if targets is not None:
            for cid, cm in self.constrains.items():
                c = self.constrain_cfg[cid]
                seg_o, det_o = outputs.get(c["seg_task"], {}), outputs.get(c["det_task"], {})
                if "probs" not in seg_o or "boxes" not in det_o:
                    continue
                # the seg probabilities lie at stride0 / amp of the image frame
                seg_amp = float(self.header_cfg[c["seg_task"]].get("amplification", 1.0))
                seg_stride = float(self.backbone_strides[0]) / seg_amp
                n_seg = seg_o["probs"].shape[-1]
                onehot = (det_o["labels"].clamp(min=0)[..., None]
                          == torch.arange(n_seg, device=x.device)).float()
                scores = onehot * det_o["scores"][..., None]
                if isinstance(cm, DynamicConstrainModule):
                    masks = det_o.get("masks")
                    if masks is None:                  # no mask branch: uniform box weight
                        masks = torch.ones(det_o["valid"].shape + (28, 28), device=x.device)
                    loss = cm(seg_o["probs"], det_o["boxes"], scores, masks, det_o["valid"],
                              seg_stride)
                else:
                    loss = cm(seg_o["probs"], det_o["boxes"], scores, det_o["valid"], seg_stride)
                losses.setdefault("constrains", {})[cid] = loss
        return losses, outputs

    def total_loss(self, losses: Dict[str, Dict[str, Tensor]],
                   mask_weight: float = 1.0) -> Tensor:
        """Σ of every header and constrain loss: each task's terms times its
        ``loss_weight`` (default 1), the terms whose key holds "mask" also
        times ``mask_weight``; each constrain times its own ``loss_weight``."""
        total = 0.0
        for task, task_losses in losses.items():
            if task == "constrains":
                for cid, v in task_losses.items():
                    total = total + float(self.constrain_cfg.get(cid, {}).get("loss_weight",
                                                                              1.0)) * v
                continue
            tw = float(self.header_cfg.get(task, {}).get("loss_weight", 1.0))
            for k, v in task_losses.items():
                total = total + tw * (mask_weight if "mask" in k else 1.0) * v
        return total
