"""Config-driven network builder (port of ``hd_yolo_tpu/models/builder.py``).

YAML rows ``[from, number, module, args, tag?, header_args?]``, depth/width
multiples, channel threading, save-lists, and per-task header hyp slicing
(loss_keys / nms_keys / multi_label).  Parsing is pure Python that emits a
hashable ``NetworkSpec``; the torch ``Model`` (models/yolo.py) builds its
module tree from it.  Field for field the same spec as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .. import LOGGER
from ..config import load_cfg
from ..ops.boxes import make_divisible

# module-name registry rows: name -> (is_channel_module, arg names)
_CHANNEL_MODULES = {
    "Conv", "GhostConv", "Bottleneck", "GhostBottleneck", "SPP", "SPPF", "DWConv",
    "MixConv2d", "Focus", "CrossConv", "BottleneckCSP", "C3", "C3TR", "C3SPP", "C3Ghost",
}
_REPEAT_INSERT = {"BottleneckCSP", "C3", "C3TR", "C3Ghost"}

# torch names appearing in configs → our module names
_ALIASES = {
    "nn.Upsample": "Upsample",
    "nn.BatchNorm2d": "BatchNorm2d",
    "nn.MaxPool2d": "MaxPool2d",
    "nn.ZeroPad2d": "ZeroPad2d",
}

LOSS_KEYS = (
    "box", "cls", "cls_pw", "cls_cw", "obj", "obj_pw", "mask",
    "iou_t", "anchor_t", "fl_gamma", "label_smoothing", "mask_iou_t", "mask_type",
)
NMS_KEYS = ("conf_thres", "iou_thres", "max_det")


def _freeze(x):
    """Recursively convert dicts/lists to hashable tuples for flax attrs."""
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    from_idx: Union[int, Tuple[int, ...]]
    module: str
    args: Tuple[Any, ...]          # positional args after channel resolution
    n: int                         # residual repeat count (for Sequential-style repeats)
    out_channels: int
    section: str                   # 'backbone' | 'fpn' | 'header'
    tag: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class HeaderSpec:
    index: int
    from_idx: Tuple[int, ...]
    tag: str
    in_channels: Tuple[int, ...]
    anchors: Tuple[Tuple[float, ...], ...]
    strides: Tuple[float, ...]
    nc: int
    masks: Tuple[Tuple[int, int], ...]     # (class -> mask channel) items
    multi_label: bool
    nms_params: Tuple[Tuple[str, float], ...]
    loss_hyp: Tuple[Tuple[str, Any], ...]
    default_input_size: Optional[int] = 640
    amplification: Optional[float] = None
    kind: str = "detect"                   # 'detect' (anchor) | 'anchor_free'
    # label hierarchy: ((parent, (children...)), ...); () = default obj→classes
    hierarchy: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    layers: Tuple[LayerSpec, ...]          # backbone + fpn rows
    headers: Tuple[HeaderSpec, ...]
    save: Tuple[int, ...]                  # indices whose outputs are kept
    n_backbone: int
    ch_in: int = 3


def _layer_stride_factor(m: str, args: Sequence[Any]) -> float:
    """Spatial downsample factor a single layer applies (1 = keeps size)."""
    m = _ALIASES.get(m, m)
    if m in ("Conv", "DWConv", "GhostConv", "CrossConv", "MixConv2d",
             "GhostBottleneck"):
        return float(args[2]) if len(args) > 2 else 1.0
    if m == "Focus":
        return 2.0
    if m == "Contract":
        return float(args[0])
    if m == "Expand":
        return 1.0 / float(args[0])
    if m == "Upsample":
        return 1.0 / float(args[1]) if len(args) > 1 and args[1] else 1.0
    if m == "MaxPool2d":
        return float(args[1]) if len(args) > 1 else float(args[0])
    return 1.0


def normalize_legacy_cfg(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Ultralytics-format hub yaml → the reference's reworked 3-section schema.

    The reference repo ships 22 hub configs still in the upstream format
    (single ``head:`` section, Detect args ``[nc, anchors]``, no strides);
    its own ``build_network`` (yolov5.py:80-161) only accepts the reworked
    ``backbone/fpn/headers`` layout with Detect args
    ``[anchors, strides, nc, masks]``.  This converts: the ``head`` rows
    before Detect become ``fpn``, Detect rows become ``headers``, and the
    per-level strides are inferred by propagating the cumulative spatial
    downsample factor through the layer graph (upstream computes them with
    a probe forward at build time).
    """
    import copy

    cfg = copy.deepcopy(dict(cfg))
    head = list(cfg.pop("head"))
    rows = list(cfg["backbone"]) + head
    strides: List[float] = []
    fpn, headers = [], []
    for i, row in enumerate(rows):
        f, n, m, args = row[0], row[1], row[2], list(row[3])
        res = [cfg[a] if isinstance(a, str) and a in cfg else a for a in args]
        if m == "Detect":
            fl = [x if x >= 0 else i + x for x in f]
            det_strides = [int(round(strides[x])) for x in fl]
            nc, anchors = res[0], res[1]
            # upstream Detect has no mask branch; the reworked Detect treats
            # an empty dict as "generic mask for every class" (yolo_head.py
            # :94-95), so spell out the all-ignore mapping explicitly
            no_masks = {cl: -1 for cl in range(int(nc) + 1)}
            headers.append(
                [fl, n, "Detect", [anchors, det_strides, int(nc), no_masks],
                 "det"])
            strides.append(float(det_strides[-1]))
            continue
        fi = (f[0] if isinstance(f, (list, tuple)) else f)
        prev = 1.0 if i == 0 else strides[fi if fi >= 0 else i + fi]
        strides.append(prev * _layer_stride_factor(m, res))
        if i >= len(cfg["backbone"]):
            fpn.append(row)
    cfg["fpn"], cfg["headers"] = fpn, headers
    cfg.setdefault("ch", 3)  # the reference build_network requires the key
    return cfg


def parse_model_cfg(cfg, hyp) -> NetworkSpec:
    """Parse a model YAML + hyp YAML into a NetworkSpec (yolov5.py:80-161 semantics)."""
    cfg = load_cfg(cfg)
    if "head" in cfg and "headers" not in cfg:
        cfg = normalize_legacy_cfg(cfg)
    hyp = load_cfg(hyp) if hyp is not None else {}
    gd, gw = cfg["depth_multiple"], cfg["width_multiple"]
    ch: List[int] = [cfg.get("ch", 3)]
    amplification = cfg.get("amplification")

    rows = list(cfg["backbone"]) + list(cfg["fpn"]) + list(cfg["headers"])
    n_backbone, n_fpn = len(cfg["backbone"]), len(cfg["fpn"])

    layers: List[LayerSpec] = []
    headers: List[HeaderSpec] = []
    save: List[int] = []
    c2 = ch[-1]
    for i, row in enumerate(rows):
        f, n, m, args = row[0], row[1], row[2], list(row[3])
        tag = row[4] if len(row) > 4 else None
        header_args = row[5] if len(row) > 5 else None
        m = _ALIASES.get(m, m)
        # resolve YAML key references in args (e.g. 'anchors')
        args = [cfg[a] if isinstance(a, str) and a in cfg else a for a in args]
        n_rep = max(round(n * gd), 1) if n > 1 else n

        section = "backbone" if i < n_backbone else ("fpn" if i < n_backbone + n_fpn else "header")

        if m in ("Detect", "AFDetect"):
            in_ch = tuple(ch[x] for x in f)
            if m == "AFDetect":  # anchor-free rows: [strides, nc] (no anchors)
                anchors = [[0, 0]] * len(f)
                args = [anchors] + list(args)
            anchors = args[0]
            if isinstance(anchors, int):  # anchor-free placeholder (yolov5.py:101-102)
                anchors = [list(range(anchors * 2))] * len(f)
            strides = tuple(float(s) for s in args[1])
            nc = int(args[2])
            mask_spec = args[3] if len(args) > 3 else {}
            if isinstance(mask_spec, int):  # int → all classes share that mask channel
                mask_spec = {cl: mask_spec for cl in range(nc + 1)}
            tag = tag or "det"
            task_hyp = hyp.get(tag, hyp)
            loss_hyp = {k: task_hyp[k] for k in LOSS_KEYS if k in task_hyp}
            # class-weight vectors (WeightReduceLoss, loss.py:24-48) must be
            # nc-sized for THIS header; a hyp written for another task's class
            # count would broadcast-crash deep inside det_loss — fall back to
            # uniform weights with a warning instead.
            cw = loss_hyp.get("cls_cw")
            if isinstance(cw, (list, tuple)) and len(cw) != nc:
                LOGGER.warning(
                    "hyp[%s]['cls_cw'] has %d entries but header nc=%d; "
                    "using uniform class weights", tag, len(cw), nc,
                )
                loss_hyp["cls_cw"] = 1.0
            nms_params = {k: float(task_hyp[k]) for k in NMS_KEYS if k in task_hyp}
            multi_label = bool(task_hyp.get("multi_label", False))
            default_input_size = 640
            h_amp = amplification
            if header_args:
                default_input_size = header_args[0] if len(header_args) > 0 else 640
                h_amp = header_args[1] if len(header_args) > 1 else amplification
            headers.append(
                HeaderSpec(
                    index=i,
                    from_idx=tuple(f),
                    tag=tag,
                    in_channels=in_ch,
                    anchors=_freeze(anchors),
                    strides=strides,
                    nc=nc,
                    masks=tuple(sorted((int(k), int(v)) for k, v in dict(mask_spec).items())),
                    multi_label=multi_label,
                    nms_params=tuple(sorted(nms_params.items())),
                    loss_hyp=_freeze(loss_hyp),
                    default_input_size=default_input_size,
                    amplification=h_amp,
                    kind="anchor_free" if m == "AFDetect" else "detect",
                    hierarchy=tuple(
                        (int(p), tuple(int(c) for c in ch))
                        for p, ch in task_hyp.get("hierarchy", [])
                    ),
                )
            )
            save.extend(x % i for x in f)
            ch.append(ch[f[-1]])  # header passthrough (not used downstream)
            if i == 0:
                ch = []
            continue

        if m in _CHANNEL_MODULES:
            c1, c2 = ch[f], args[0]
            c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            if m in _REPEAT_INSERT:
                args.insert(1, n_rep)
                n_rep = 1
        elif m == "BatchNorm2d":
            args, c2 = [], ch[f]
        elif m == "Concat":
            c2 = sum(ch[x] for x in f)
            args = []
        elif m == "Contract":
            c2 = ch[f] * args[0] ** 2
        elif m == "Expand":
            c2 = ch[f] // args[0] ** 2
        elif m == "Upsample":
            # nn.Upsample args: (size, scale_factor, mode)
            args = [int(args[1]), str(args[2])] if len(args) >= 3 else [2, "nearest"]
            c2 = ch[f]
        else:
            c2 = ch[f]

        # resolve negative refs other than -1 ("previous") to absolute indices
        # (legacy rows like yolov3-tiny's ``[-2, 1, Conv, ...]``; the
        # reference resolves these through its save-list modulo, yolov5.py:150)
        if isinstance(f, (list, tuple)):
            f = [j if j == -1 else j % i for j in f]
        elif f != -1:
            f = f % i
        layers.append(
            LayerSpec(
                index=i, from_idx=_freeze(f) if isinstance(f, (list, tuple)) else f,
                module=m, args=_freeze(args), n=n_rep, out_channels=c2, section=section, tag=tag,
            )
        )
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch = []
        ch.append(c2)

    spec = NetworkSpec(
        layers=tuple(layers),
        headers=tuple(headers),
        save=tuple(sorted(set(save))),
        n_backbone=n_backbone,
        ch_in=cfg.get("ch", 3),
    )
    for l in spec.layers:
        LOGGER.debug(f"{l.index:>3} {str(l.from_idx):>12} {l.n:>3} {l.module:<16} {l.args}")
    return spec
