"""The plain reference of the benchmark's yolo detectors: the published
yolov5 P6 layout (ultralytics v6.0 ``Conv``, ``C3``, ``Bottleneck``,
``SPPF``, nearest upsample, concat) with its ``Detect`` header, and the
hd_yolo ``detSC`` mask branch (a 3x3 conv per level to 256 channels and the
Mask R-CNN mask head), in plain float32 PyTorch, NCHW, no fused or folded
weights.

Its module tree carries the published torch names (``backbone.i``,
``neck.j``, ``headers.<tag>``; ``conv``/``bn``, ``cv1``..``cv3``, ``m.j``;
``m.l`` det convs, ``seg.k``, ``seg_h.maskrcnn_heads.mask_fcn{1..4}``,
``seg_h.maskrcnn_preds.{conv5_mask,mask_fcn_logits}``), so one state dict
loads into it and into the system under test.  It imports nothing of the
system under test.

Every convolution goes through ``Prec.conv``: float32 as it is (the
reference), or with its input, weight and output rounded to float8 e4m3
with one scale a tensor (the control: activations and weights one step
below the bf16 the configurations state; products accumulate in float32).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3          # ultralytics' yolov5 BatchNorm eps (the flax port's too)
E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude mapped to e4m3's 448), back in float32."""
    s = t.abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Prec:
    """How the reference computes a convolution: ``fp8`` False is float32
    (TF32 off: the caller sets ``torch.backends``), True the control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.fp8 else t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def deconv(self, x, w, b, stride):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b, stride=stride))


F32 = Prec(False)


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


class Conv(nn.Module):
    """conv (no bias) → BatchNorm (running statistics) → SiLU."""

    def __init__(self, c1, c2, k=1, s=1, p=None):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)

    def forward(self, x, prec: Prec = F32):
        c, bn = self.conv, self.bn
        y = prec.conv(x, c.weight, None, c.stride, c.padding)
        y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                         BN_EPS)
        return F.silu(y)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x, prec: Prec = F32):
        y = self.cv2(self.cv1(x, prec), prec)
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x, prec: Prec = F32):
        y = self.cv1(x, prec)
        for b in self.m:
            y = b(y, prec)
        return self.cv3(torch.cat([y, self.cv2(x, prec)], 1), prec)


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x, prec: Prec = F32):
        x = self.cv1(x, prec)
        k = self.k
        y1 = F.max_pool2d(x, k, 1, k // 2)
        y2 = F.max_pool2d(y1, k, 1, k // 2)
        y3 = F.max_pool2d(y2, k, 1, k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1), prec)


class Upsample(nn.Module):
    def __init__(self, scale=2):
        super().__init__()
        self.scale = scale

    def forward(self, x, prec: Prec = F32):
        return F.interpolate(x, scale_factor=self.scale, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs, prec: Prec = F32):
        return torch.cat(list(xs), 1)


class _MaskHeads(nn.Module):
    def __init__(self, c):
        super().__init__()
        for j in range(1, 5):
            setattr(self, f"mask_fcn{j}", nn.Conv2d(c, c, 3, 1, 1))


class _MaskPreds(nn.Module):
    def __init__(self, c, nc_masks):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(c, c, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(c, nc_masks, 1)


class MaskHead(nn.Module):
    """Mask R-CNN's mask head: 4 x (3x3 conv + ReLU), 2x2/s2 deconv + ReLU,
    1x1 logits (torchvision ``MaskRCNNHeads`` + ``MaskRCNNPredictor``)."""

    def __init__(self, c, nc_masks):
        super().__init__()
        self.maskrcnn_heads = _MaskHeads(c)
        self.maskrcnn_preds = _MaskPreds(c, nc_masks)

    def forward(self, x, prec: Prec = F32):
        """(N, C, 14, 14) pooled features → (N, nc_masks, 28, 28) logits."""
        for j in range(1, 5):
            c = getattr(self.maskrcnn_heads, f"mask_fcn{j}")
            x = F.relu(prec.conv(x, c.weight, c.bias, 1, 1))
        d, lg = self.maskrcnn_preds.conv5_mask, self.maskrcnn_preds.mask_fcn_logits
        x = F.relu(prec.deconv(x, d.weight, d.bias, 2))
        return prec.conv(x, lg.weight, lg.bias)


class Detect(nn.Module):
    """yolov5's Detect (a 1x1 conv a level to anchors x (5 + nc)) with the
    detSC mask branch when the header maps some class to a mask channel."""

    def __init__(self, h: dict):
        super().__init__()
        self.h = h
        na, no = h["na"], h["nc"] + 5
        self.m = nn.ModuleList(nn.Conv2d(c, na * no, 1) for c in h["in_channels"])
        if h["nc_masks"] > 0:
            self.seg = nn.ModuleList(Conv(c, 256, 3) for c in reversed(h["in_channels"]))
            self.seg_h = MaskHead(256, h["nc_masks"])

    def det_logits(self, feats: Sequence[torch.Tensor], prec: Prec = F32) -> List[torch.Tensor]:
        """Per level the raw logits (B, ny, nx, na, no)."""
        out = []
        for conv, f in zip(self.m, feats):
            d = prec.conv(f, conv.weight, conv.bias)
            B, _, ny, nx = d.shape
            out.append(d.permute(0, 2, 3, 1).reshape(B, ny, nx, self.h["na"], -1))
        return out

    def seg_feats(self, feats: Sequence[torch.Tensor], prec: Prec = F32) -> List[torch.Tensor]:
        """Per level the mask branch's (B, 256, ny, nx) features (``seg`` is
        listed top-down: level i uses ``seg[nl - 1 - i]``)."""
        nl = len(feats)
        return [self.seg[nl - 1 - i](f, prec) for i, f in enumerate(feats)]


def _header(row, ch, cfg, hyp) -> dict:
    f, _, _, args = row[0], row[1], row[2], list(row[3])
    tag = row[4] if len(row) > 4 else "det"
    anchors = cfg[args[0]] if isinstance(args[0], str) else args[0]
    nc = int(args[2])
    masks = args[3] if len(args) > 3 else {}
    if isinstance(masks, int):
        masks = {c: masks for c in range(nc + 1)}
    mask_idx = [int(dict((int(k), v) for k, v in masks.items()).get(c, 0)) for c in range(nc + 1)]
    th = hyp.get(tag, hyp)
    return {"tag": tag, "from": list(f), "in_channels": [ch[j] for j in f],
            "anchors": [list(a) for a in anchors], "strides": [float(s) for s in args[1]],
            "nc": nc, "na": len(anchors[0]) // 2, "mask_idx": mask_idx,
            "nc_masks": max(mask_idx) + 1 if mask_idx else 0,
            "conf_thres": float(th.get("conf_thres", 0.15)),
            "iou_thres": float(th.get("iou_thres", 0.45)),
            "max_det": int(th.get("max_det", 300)),
            "hierarchy": [(int(p), [int(c) for c in cs]) for p, cs in th.get("hierarchy", [])]}


def _stride_factor(m: str, args) -> float:
    if m == "Conv":
        return float(args[2]) if len(args) > 2 else 1.0
    if m == "nn.Upsample":
        return 1.0 / float(args[1])
    return 1.0


def _published_rows(cfg: dict) -> dict:
    """ultralytics' one ``head:`` section → backbone / fpn / headers rows
    (the Detect row as ``[anchors, strides, nc, no masks]``, its strides
    from the layers' cumulative downsampling)."""
    rows = list(cfg["backbone"]) + list(cfg["head"])
    strides, fpn, headers = [], [], []
    for i, row in enumerate(rows):
        f, m, args = row[0], row[2], row[3]
        if m == "Detect":
            fl = [x if x >= 0 else i + x for x in f]
            nc = cfg[args[0]] if isinstance(args[0], str) else args[0]
            headers.append([fl, 1, "Detect", ["anchors", [strides[x] for x in fl], nc,
                                              {c: -1 for c in range(nc + 1)}], "det"])
            strides.append(strides[fl[-1]])
            continue
        fi = f[0] if isinstance(f, list) else f
        prev = 1.0 if i == 0 else strides[fi if fi >= 0 else i + fi]
        strides.append(prev * _stride_factor(m, args))
        if i >= len(cfg["backbone"]):
            fpn.append(row)
    return dict(cfg, fpn=fpn, headers=headers)


class Model(nn.Module):
    """The whole detector from a configuration's ``model`` rows (the
    published ultralytics layout, or hd_yolo's backbone / fpn / headers)."""

    def __init__(self, cfg: dict, hyp: dict):
        super().__init__()
        if "head" in cfg:
            cfg = _published_rows(cfg)
        gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
        ch: List[int] = []
        self.rows = []
        mods = []
        for i, row in enumerate(list(cfg["backbone"]) + list(cfg["fpn"])):
            f, n, m, args = row[0], row[1], row[2], list(row[3])
            n = max(round(n * gd), 1) if n > 1 else n
            c1 = 3 if i == 0 else (ch[f] if isinstance(f, int) else None)
            if m == "Conv":
                c2 = make_divisible(args[0] * gw)
                mod = Conv(c1, c2, *args[1:])
            elif m == "C3":
                c2 = make_divisible(args[0] * gw)
                mod = C3(c1, c2, n, *args[1:])
            elif m == "SPPF":
                c2 = make_divisible(args[0] * gw)
                mod = SPPF(c1, c2, *args[1:])
            elif m == "nn.Upsample":
                c2, mod = c1, Upsample(int(args[1]))
            elif m == "Concat":
                c2, mod = sum(ch[j] for j in f), Concat()
            else:
                raise KeyError(f"the reference has no layer {m!r}")
            mods.append(mod)
            ch.append(c2)
            self.rows.append(f)
        nb = len(cfg["backbone"])
        self.backbone = nn.ModuleList(mods[:nb])
        self.neck = nn.ModuleList(mods[nb:])
        self.hspecs = [_header(r, ch, cfg, hyp) for r in cfg["headers"]]
        self.headers = nn.ModuleDict({h["tag"]: Detect(h) for h in self.hspecs})
        self.save = sorted({j for f in self.rows for j in ([f] if isinstance(f, int) else f)
                            if j != -1} | {j for h in self.hspecs for j in h["from"]})

    def trunk(self, x: torch.Tensor, prec: Prec = F32) -> Dict[int, torch.Tensor]:
        """(B, H, W, 3) uint8 → {layer: NCHW float32 feature} of the saved layers."""
        cur = x.float().div(255.0).permute(0, 3, 1, 2).contiguous()
        saved = {}
        for i, (f, mod) in enumerate(zip(self.rows, list(self.backbone) + list(self.neck))):
            if f == -1:
                inp = cur
            elif isinstance(f, int):
                inp = saved[f]
            else:
                inp = [cur if j == -1 else saved[j] for j in f]
            cur = mod(inp, prec)
            if i in self.save:
                saved[i] = cur
        return saved
