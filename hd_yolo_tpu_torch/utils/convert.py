"""Carry weights across: a flax ``{'params', 'batch_stats'}`` tree (as numpy)
→ a reference-layout torch ``state_dict`` for this package's ``Model``.

The key map and layout rules of ``hd_yolo_tpu/utils/export_torch.py``:
  flax conv kernel (kh, kw, I, O)    → torch Conv2d weight (O, I, kh, kw)
  flax ConvTranspose (kh, kw, I, O)  → flipped back spatially, then (I, O, kh, kw)
  bn {scale, bias} + stats {mean, var} → weight / bias / running_mean / running_var
  header ``seg.k``                    ↔ flax ``seg{nl-1-k}`` (the reference list is top-down)
  anchor-free header ``stems.i`` / ``cls_convs.i`` / ``reg_convs.i`` ↔ flax
  ``stem{i}`` / ``cls_conv{i}`` / ``reg_conv{i}``, and ``cls_preds.i`` /
  ``reg_preds.i`` / ``obj_preds.i`` ↔ ``cls_pred{i}`` / ``reg_pred{i}`` /
  ``obj_pred{i}`` (the JAX package's exporter has no such map; these keys
  are the port's own)
The hub zoo layers map from the tree ``model.init`` builds (not from the
exporter's map, which lacks them): flax's auto-named submodules
(``ConvBnAct_0``, ``GhostConv_1``, ``Bottleneck_{j}``, ``GhostBottleneck_{j}``,
``SPP_0``, ``TransformerBlock_0``, ``BatchNorm_0``, ``m{i}``) to the
reference's attribute names (``cv1``..``cv4``, ``conv.0/1/2``,
``shortcut.0/1``, ``m.{j}``, ``bn``); a ``TransformerBlock``'s per-head
attention kernels to ``nn.MultiheadAttention``'s ``in_proj_*`` and
``out_proj``; a row repeated n > 1 times (``blocks_{i}_{r}``) to
``{key}.{r}``.  BatchNorm buffers also get ``num_batches_tracked`` = 0, so
the converted tree loads with ``strict=True``.

``hnet_state_dict_from_flax`` does the same for ``hnet.HNet``, with the key
layouts of the JAX package's importers inverted (``utils/import_swin.py``,
``utils/import_maskrcnn.py``): dense kernel (I, O) → weight (O, I), norm
{scale, bias} → weight / bias, the box head's fc6 input columns (7, 7, C) →
the reference's (C, 7, 7); the Mask R-CNN mask head takes the port's
``MaskHead`` names and the flipped deconv, its keypoint branch torchvision's
names (flax ``kp{i}`` → ``keypoint_head.{2i}``, the flipped ``deconv`` →
``keypoint_predictor.kps_score_lowres``), FCOS, the panoptic and cl
headers their flax names (FCOS's ``scale{i}`` → ``scales.{i}.scale``); the
darknet backbone's flax auto-names (``ConvBnAct_0``, then ``ConvBnAct_{i}``
and ``C3_{i-1}`` a stage) → ``layers.{j}`` in call order, with its
BatchNorm statistics.  ``srgan_state_dict_from_flax`` maps the SRGAN
generator and critic, whose names are the flax ones.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.builder import NetworkSpec


class _Reader:
    def __init__(self, params: Mapping, stats: Mapping):
        self.params = params
        self.stats = stats
        self.sd: Dict[str, np.ndarray] = {}

    @staticmethod
    def _get(tree, path):
        for k in path:
            if k not in tree:
                return None
            tree = tree[k]
        return tree

    def conv(self, tkey: str, *fpath):
        node = self._get(self.params, fpath)
        if node is None:
            return
        self.sd[tkey + ".weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
        if "bias" in node:
            self.sd[tkey + ".bias"] = np.asarray(node["bias"])

    def deconv(self, tkey: str, *fpath):
        node = self._get(self.params, fpath)
        if node is None:
            return
        w = np.asarray(node["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
        self.sd[tkey + ".weight"] = np.ascontiguousarray(w)
        if "bias" in node:
            self.sd[tkey + ".bias"] = np.asarray(node["bias"])

    def bn(self, tkey: str, *fpath):
        p = self._get(self.params, fpath)
        s = self._get(self.stats, fpath)
        if p is None or s is None:
            return
        self.sd[tkey + ".weight"] = np.asarray(p["scale"])
        self.sd[tkey + ".bias"] = np.asarray(p["bias"])
        self.sd[tkey + ".running_mean"] = np.asarray(s["mean"])
        self.sd[tkey + ".running_var"] = np.asarray(s["var"])
        self.sd[tkey + ".num_batches_tracked"] = np.zeros((), np.int64)

    def dense(self, tkey: str, *fpath):
        node = self._get(self.params, fpath)
        if node is None:
            return
        self.sd[tkey + ".weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
        if "bias" in node:
            self.sd[tkey + ".bias"] = np.asarray(node["bias"])

    def norm(self, tkey: str, *fpath):
        node = self._get(self.params, fpath)
        self.sd[tkey + ".weight"] = np.asarray(node["scale"])
        self.sd[tkey + ".bias"] = np.asarray(node["bias"])

    def conv_block(self, tkey: str, fpath):
        self.conv(tkey + ".conv", *fpath, "conv")
        self.bn(tkey + ".bn", *fpath, "bn")


def _j(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def _numbered(node, prefix: str):
    """j for each child ``{prefix}{j}`` of a flax node, in order."""
    j = 0
    while node is not None and f"{prefix}{j}" in node:
        yield j
        j += 1


def _transformer(r: _Reader, tkey: str, fpath) -> None:
    """flax ``TransformerBlock`` → ``conv`` / ``linear`` / ``tr.{i}``: each
    layer's dense kernels transposed; its ``MultiHeadDotProductAttention``
    per-head (C, heads, head_dim) query / key / value kernels flattened into
    ``nn.MultiheadAttention``'s ``in_proj_weight`` rows (q, k, v) and the
    (heads, head_dim, C) output kernel into ``out_proj``."""
    node = r._get(r.params, fpath)
    if "ConvBnAct_0" in node:
        r.conv_block(_j(tkey, "conv"), fpath + ("ConvBnAct_0",))
    r.dense(_j(tkey, "linear"), *fpath, "pos")
    for i in _numbered(node, "ma"):
        t = _j(tkey, f"tr.{i}")
        for tk, fk in (("q", f"q{i}"), ("k", f"k{i}"), ("v", f"v{i}"), ("fc1", f"fc1_{i}"),
                       ("fc2", f"fc2_{i}")):
            r.dense(f"{t}.{tk}", *fpath, fk)
        ma = node[f"ma{i}"]
        c = np.asarray(ma["query"]["kernel"]).shape[0]
        r.sd[f"{t}.ma.in_proj_weight"] = np.concatenate(
            [np.asarray(ma[p]["kernel"]).reshape(c, -1).T for p in ("query", "key", "value")])
        r.sd[f"{t}.ma.in_proj_bias"] = np.concatenate(
            [np.asarray(ma[p]["bias"]).reshape(-1) for p in ("query", "key", "value")])
        r.sd[f"{t}.ma.out_proj.weight"] = np.ascontiguousarray(
            np.asarray(ma["out"]["kernel"]).reshape(-1, c).T)
        r.sd[f"{t}.ma.out_proj.bias"] = np.asarray(ma["out"]["bias"])


def _ghost_bottleneck(r: _Reader, tkey: str, fpath) -> None:
    node = r._get(r.params, fpath)
    for cv, sub in (("cv1", "ConvBnAct_0"), ("cv2", "ConvBnAct_1")):
        r.conv_block(_j(tkey, "conv.0", cv), fpath + ("GhostConv_0", sub))
        r.conv_block(_j(tkey, "conv.2", cv), fpath + ("GhostConv_1", sub))
    if "DWConv_0" in node:                               # stride 2
        r.conv_block(_j(tkey, "conv.1"), fpath + ("DWConv_0", "ConvBnAct_0"))
        r.conv_block(_j(tkey, "shortcut.0"), fpath + ("DWConv_1", "ConvBnAct_0"))
        r.conv_block(_j(tkey, "shortcut.1"), fpath + ("ConvBnAct_0",))


def _spp(r: _Reader, tkey: str, fpath) -> None:
    r.conv_block(_j(tkey, "cv1"), fpath + ("ConvBnAct_0",))
    r.conv_block(_j(tkey, "cv2"), fpath + ("ConvBnAct_1",))


def _bottlenecks(r: _Reader, tkey: str, fpath) -> None:
    for j in _numbered(r._get(r.params, fpath), "Bottleneck_"):
        _spp(r, _j(tkey, f"m.{j}"), fpath + (f"Bottleneck_{j}",))   # cv1, cv2 alike


def layer_from_flax(r: _Reader, module: str, tkey: str, fpath) -> None:
    """One layer row of the JAX package's ``Model`` at flax path ``fpath``
    (its tree as ``model.init`` builds it) → the port's keys under
    ``tkey``."""
    if module == "Conv":
        r.conv_block(tkey, fpath)
    elif module == "DWConv":
        r.conv_block(tkey, fpath + ("ConvBnAct_0",))
    elif module in ("Bottleneck", "SPP", "GhostConv", "CrossConv"):
        _spp(r, tkey, fpath)                             # ConvBnAct_0 / _1 → cv1 / cv2
    elif module in ("C3", "C3TR", "C3SPP", "C3Ghost"):
        for cv in ("cv1", "cv2", "cv3"):
            r.conv_block(_j(tkey, cv), fpath + (cv,))
        if module == "C3":
            _bottlenecks(r, tkey, fpath)
        elif module == "C3TR":
            _transformer(r, _j(tkey, "m"), fpath + ("TransformerBlock_0",))
        elif module == "C3SPP":
            _spp(r, _j(tkey, "m"), fpath + ("SPP_0",))
        else:
            for j in _numbered(r._get(r.params, fpath), "GhostBottleneck_"):
                _ghost_bottleneck(r, _j(tkey, f"m.{j}"), fpath + (f"GhostBottleneck_{j}",))
    elif module == "BottleneckCSP":
        r.conv_block(_j(tkey, "cv1"), fpath + ("ConvBnAct_0",))
        r.conv(_j(tkey, "cv2"), *fpath, "cv2")
        r.conv(_j(tkey, "cv3"), *fpath, "cv3")
        r.conv_block(_j(tkey, "cv4"), fpath + ("ConvBnAct_1",))
        r.bn(_j(tkey, "bn"), *fpath, "BatchNorm_0")
        _bottlenecks(r, tkey, fpath)
    elif module == "SPPF":
        r.conv_block(_j(tkey, "cv1"), fpath + ("cv1",))
        r.conv_block(_j(tkey, "cv2"), fpath + ("cv2",))
    elif module == "Focus":
        r.conv_block(_j(tkey, "conv"), fpath + ("ConvBnAct_0",))
    elif module == "GhostBottleneck":
        _ghost_bottleneck(r, tkey, fpath)
    elif module == "BatchNorm2d":
        r.bn(tkey, *fpath, "BatchNorm_0")
    elif module == "MixConv2d":
        for i in _numbered(r._get(r.params, fpath), "m"):
            r.conv(_j(tkey, f"m.{i}"), *fpath, f"m{i}")
        r.bn(_j(tkey, "bn"), *fpath, "BatchNorm_0")
    elif module == "TransformerBlock":
        _transformer(r, tkey, fpath)
    elif module not in ("Concat", "Upsample", "Contract", "Expand", "MaxPool2d", "ZeroPad2d"):
        raise NotImplementedError(f"no weight map for module {module!r}")


def layer_state_dict_from_flax(variables_np: Mapping, module: str,
                               prefix: str) -> Dict[str, torch.Tensor]:
    """The flax variables of one layer (a ``models/layers.py`` module's own
    tree at the root) → the port's keys for ``module`` under ``prefix``."""
    r = _Reader(variables_np.get("params", {}), variables_np.get("batch_stats", {}))
    layer_from_flax(r, module, prefix, ())
    return {k: torch.from_numpy(np.array(v)) for k, v in r.sd.items()}


def state_dict_from_flax(variables_np: Mapping, spec: NetworkSpec) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} numpy tree → reference-layout state_dict.
    A row repeated ``n`` > 1 times (flax ``blocks_{i}_{r}``) maps to
    ``{tkey}.{r}``."""
    r = _Reader(variables_np.get("params", {}), variables_np.get("batch_stats", {}))
    for l in spec.layers:
        tkey = f"backbone.{l.index}" if l.index < spec.n_backbone else \
            f"neck.{l.index - spec.n_backbone}"
        if l.n > 1:
            for rep in range(l.n):
                layer_from_flax(r, l.module, f"{tkey}.{rep}", (f"blocks_{l.index}_{rep}",))
        else:
            layer_from_flax(r, l.module, tkey, (f"blocks_{l.index}",))

    for h in spec.headers:
        hkey, fh, nl = f"headers.{h.tag}", f"header_{h.tag}", len(h.strides)
        if h.kind == "anchor_free":
            for i in range(nl):
                for tk, fk in (("stems", "stem"), ("cls_convs", "cls_conv"),
                               ("reg_convs", "reg_conv")):
                    r.conv_block(f"{hkey}.{tk}.{i}", (fh, f"{fk}{i}"))
                for tk, fk in (("cls_preds", "cls_pred"), ("reg_preds", "reg_pred"),
                               ("obj_preds", "obj_pred")):
                    r.conv(f"{hkey}.{tk}.{i}", fh, f"{fk}{i}")
            continue
        for l in range(nl):
            r.conv(f"{hkey}.m.{l}", fh, f"det{l}")
        for k in range(nl):
            r.conv_block(f"{hkey}.seg.{k}", (fh, f"seg{nl - 1 - k}"))
        for j in range(4):
            r.conv(f"{hkey}.seg_h.maskrcnn_heads.mask_fcn{j + 1}", fh, "mask_head", f"fcn{j}")
        r.deconv(f"{hkey}.seg_h.maskrcnn_preds.conv5_mask", fh, "mask_head", "deconv")
        r.conv(f"{hkey}.seg_h.maskrcnn_preds.mask_fcn_logits", fh, "mask_head", "logits")
    return {k: torch.from_numpy(np.array(v)) for k, v in r.sd.items()}


def swin_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``SwinTransformer`` params → ``hnet.swin.SwinTransformer`` keys."""
    r = _Reader(params, {})
    r.conv("patch_embed.proj", "patch_embed")
    r.norm("patch_embed.norm", "patch_norm")
    i = 0
    while f"stage{i}_block0" in params:
        j = 0
        while f"stage{i}_block{j}" in params:
            t, f = f"layers.{i}.blocks.{j}", f"stage{i}_block{j}"
            for tk, fk in (("norm1", "norm1"), ("norm2", "norm2")):
                r.norm(f"{t}.{tk}", f, fk)
            for tk, fk in (("attn.qkv", ("attn", "qkv")), ("attn.proj", ("attn", "proj")),
                           ("mlp.fc1", ("fc1",)), ("mlp.fc2", ("fc2",))):
                r.dense(f"{t}.{tk}", f, *fk)
            r.sd[f"{t}.attn.relative_position_bias_table"] = np.asarray(
                params[f]["attn"]["relative_position_bias_table"])
            j += 1
        if f"merge{i}" in params:
            r.dense(f"layers.{i}.downsample.reduction", f"merge{i}", "reduction")
            r.norm(f"layers.{i}.downsample.norm", f"merge{i}", "norm")
        if f"out_norm{i}" in params:
            r.norm(f"norm{i}", f"out_norm{i}")
        i += 1
    return r.sd


def fpn_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``FeaturePyramidNetwork`` params → torchvision FPN keys."""
    r = _Reader(params, {})
    i = 0
    while f"lateral{i}" in params:
        r.conv(f"inner_blocks.{i}", f"lateral{i}")
        r.conv(f"layer_blocks.{i}", f"out{i}")
        i += 1
    r.conv("extra_blocks.p6", "p6")
    r.conv("extra_blocks.p7", "p7")
    return r.sd


def maskrcnn_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``MaskRCNN`` params → torchvision keys (``rpn.head.*``,
    ``roi_heads.*``), the mask head under the port's ``MaskHead`` names."""
    r = _Reader(params, {})
    for tk, fk in (("conv", "conv"), ("cls_logits", "cls"), ("bbox_pred", "reg")):
        r.conv(f"rpn.head.{tk}", "rpn_head", fk)
    r.dense("roi_heads.box_head.fc6", "box_head", "fc6")
    w = r.sd["roi_heads.box_head.fc6.weight"]                      # (O, 7·7·C), (h, w, c) order
    O, S = w.shape[0], 7
    r.sd["roi_heads.box_head.fc6.weight"] = np.ascontiguousarray(
        w.reshape(O, S, S, -1).transpose(0, 3, 1, 2).reshape(O, -1))
    r.dense("roi_heads.box_head.fc7", "box_head", "fc7")
    r.dense("roi_heads.box_predictor.cls_score", "box_head", "cls_score")
    r.dense("roi_heads.box_predictor.bbox_pred", "box_head", "bbox_pred")
    if "mask_head" in params:
        m = "roi_heads.mask_head"
        for j in range(4):
            r.conv(f"{m}.maskrcnn_heads.mask_fcn{j + 1}", "mask_head", f"fcn{j}")
        r.deconv(f"{m}.maskrcnn_preds.conv5_mask", "mask_head", "deconv")
        r.conv(f"{m}.maskrcnn_preds.mask_fcn_logits", "mask_head", "logits")
    if "keypoint_head" in params:
        for j in _numbered(params["keypoint_head"], "kp"):
            r.conv(f"roi_heads.keypoint_head.{2 * j}", "keypoint_head", f"kp{j}")
        r.deconv("roi_heads.keypoint_predictor.kps_score_lowres", "keypoint_head", "deconv")
    return r.sd


def fcos_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``FCOS`` params → ``hnet.fcos.FCOS`` keys."""
    r = _Reader(params, {})
    for tower in ("cls_tower", "bbox_tower"):
        for i in _numbered(params[tower], "conv"):
            r.conv(f"{tower}.conv{i}", tower, f"conv{i}")
            r.norm(f"{tower}.gn{i}", tower, f"gn{i}")
    for name in ("cls_logits", "bbox_pred", "centerness"):
        r.conv(name, name)
    for i in _numbered(params, "scale"):
        r.sd[f"scales.{i}.scale"] = np.asarray(params[f"scale{i}"]["scale"])
    return r.sd


def darknet_state_dict_from_flax(params: Mapping, stats: Mapping) -> Dict[str, np.ndarray]:
    """flax ``DarkNetBackbone`` variables → ``hnet.hnet.DarkNetBackbone``
    keys: ``layers.0`` the stem, then ``layers.{2i-1}`` / ``layers.{2i}``
    the ``ConvBnAct_{i}`` / ``C3_{i-1}`` of stage i."""
    r = _Reader(params, stats)
    layer_from_flax(r, "Conv", "layers.0", ("ConvBnAct_0",))
    for i in _numbered(params, "C3_"):
        layer_from_flax(r, "Conv", f"layers.{2 * i + 1}", (f"ConvBnAct_{i + 1}",))
        layer_from_flax(r, "C3", f"layers.{2 * i + 2}", (f"C3_{i}",))
    return r.sd


def srgan_state_dict_from_flax(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``SRGenerator`` / ``SRDiscriminator`` variables → the port's
    modules (``hnet/srgan.py``, the same names): convs, BatchNorms with
    their statistics, PReLU ``alpha``."""
    params, stats = variables_np["params"], variables_np.get("batch_stats", {})
    r = _Reader(params, stats)

    def walk(node, path):
        for k, v in node.items():
            p = path + (k,)
            if "kernel" in v:
                r.conv(".".join(p), *p)
            elif "scale" in v:
                r.bn(".".join(p), *p)
            elif "alpha" in v:
                r.sd[".".join(p) + ".alpha"] = np.asarray(v["alpha"])
            else:
                walk(v, p)

    walk(params, ())
    return {k: torch.from_numpy(np.array(v)) for k, v in r.sd.items()}


def panoptic_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """flax ``PanopticSegHead`` params → the same names (``connector.conv*``,
    ``connector.gn*``, ``logits``)."""
    r = _Reader(params, {})
    for name in params["connector"]:
        (r.conv if name.startswith("conv") else r.norm)(f"connector.{name}", "connector", name)
    r.conv("logits", "logits")
    return r.sd


def hnet_state_dict_from_flax(variables_np: Mapping, cfg: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``HNet`` variables (numpy) → ``hnet.HNet`` state_dict, loadable
    with ``strict=True``."""
    params = variables_np["params"]
    if cfg.get("backbone", {"type": "swin"}).get("type", "swin") == "swin":
        back = swin_state_dict_from_flax(params["backbone"])
    else:
        back = darknet_state_dict_from_flax(params["backbone"],
                                            variables_np.get("batch_stats", {}).get("backbone", {}))
    sd = {f"backbone.{k}": v for k, v in back.items()}
    sd.update({f"fpn.{k}": v for k, v in fpn_state_dict_from_flax(params["fpn"]).items()})
    for task, h in cfg.get("headers", {}).items():
        node = params[f"header_{task}"]
        kind = h.get("type", "maskrcnn")
        if kind == "maskrcnn":
            part = maskrcnn_state_dict_from_flax(node)
        elif kind == "fcos":
            part = fcos_state_dict_from_flax(node)
        elif kind == "panoptic":
            part = panoptic_state_dict_from_flax(node)
        elif kind in ("cl", "classification"):
            r = _Reader(node, {})
            r.dense("fc1", "fc1")
            r.dense("fc2", "fc2")
            part = r.sd
        else:
            raise NotImplementedError(f"no weight map for header type {kind!r}")
        sd.update({f"headers.{task}.{k}": v for k, v in part.items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _find(node, field: str) -> list:
    """Every namedtuple in an optax state tree that has ``field``, in tree order."""
    out = []
    if hasattr(node, "_fields"):
        if field in node._fields:
            out.append(node)
        for v in node:
            out += _find(v, field)
    elif isinstance(node, (list, tuple)):
        for v in node:
            out += _find(v, field)
    elif isinstance(node, dict):
        for v in node.values():
            out += _find(v, field)
    return out


def _merge_masked(trees: list, like):
    """One params tree from several ``multi_transform`` group trees, each
    holding arrays for its group's leaves and ``MaskedNode`` elsewhere; a
    leaf no group holds (frozen) is zeros shaped as in ``like``."""
    if isinstance(like, dict):
        return {k: _merge_masked([t[k] for t in trees], like[k]) for k in like}
    for t in trees:
        if not (hasattr(t, "_fields") and type(t).__name__ == "MaskedNode"):
            return np.asarray(t)
    return np.zeros_like(np.asarray(like))


def train_state_from_flax(state, model, opt, ema) -> None:
    """Load the JAX package's ``TrainState`` (its arrays as numpy; params,
    batch_stats, the optax state of ``engines/optim.build_optimizer`` —
    ``apply_if_finite``, ``MultiSteps``, the SGD traces or Adam moments of
    each group —, EMA and step) into the port's ``model``, optimizer ``opt``
    and ``ema`` (``engines/optim``), in place.  Returns the step as an int.
    Frozen parameters have no optimizer state in the JAX tree and get 0."""
    spec = model.spec
    stats = state.batch_stats
    model.load_state_dict(state_dict_from_flax({"params": state.params, "batch_stats": stats},
                                                spec))
    names = opt.names

    def to_t(tree):
        sd = state_dict_from_flax({"params": tree, "batch_stats": stats}, spec)
        return [sd[n] for n in names]

    st = opt.state
    fin = _find(state.opt_state, "notfinite_count")
    if fin:
        st["notfinite"] = torch.tensor(int(np.asarray(fin[0].notfinite_count)))
    multi = _find(state.opt_state, "mini_step")
    if multi and "acc" in st:
        st["mini_step"] = torch.tensor(int(np.asarray(multi[0].mini_step)))
        st["acc"] = to_t(multi[0].acc_grads)
    counts = _find(state.opt_state, "hyperparams")
    if counts:
        st["count"] = torch.tensor(int(np.asarray(counts[0].count)))
    traces = _find(state.opt_state, "trace") or _find(state.opt_state, "mu")
    first = "trace" if _find(state.opt_state, "trace") else "mu"
    st["trace"] = to_t(_merge_masked([getattr(t, first) for t in traces], state.params))
    if "nu" in st:
        st["nu"] = to_t(_merge_masked([t.nu for t in _find(state.opt_state, "nu")],
                                      state.params))
    dev = opt.params[0].device
    for k, v in list(st.items()):
        st[k] = v.to(dev) if torch.is_tensor(v) else [t.to(dev).contiguous() for t in v]
    ema.params = [t.to(dev).contiguous() for t in to_t(state.ema.params)]
    ema.updates = torch.tensor(int(np.asarray(state.ema.updates))).to(dev)
    return int(np.asarray(state.step))


def load_weights(model, path: str) -> None:
    """Load a port/reference ``.pt`` (``utils/import_torch.read_checkpoint``:
    a state_dict or a pickled module, bare or under ``{'ema' | 'model' |
    'state_dict': ...}``, ultralytics keys renumbered, a single header
    renamed to the model's tag) or a pickled flax ``{'params',
    'batch_stats'}`` tree into ``model``, strictly."""
    from .import_torch import read_checkpoint, to_model_keys

    if path.endswith((".pt", ".pth")):
        sd = to_model_keys(model, read_checkpoint(path))
        for k, v in model.state_dict().items():   # reference files may omit the BN counters
            if k.endswith("num_batches_tracked") and k not in sd:
                sd[k] = v
    else:
        with open(path, "rb") as f:
            variables = pickle.load(f)
        sd = state_dict_from_flax(variables, model.spec)
    model.load_state_dict(sd, strict=True)
