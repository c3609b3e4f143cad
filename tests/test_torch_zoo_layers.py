"""PyTorch port: the hub zoo layers (``hd_yolo_tpu_torch/models/layers.py``)
against the JAX package's on the same seeded weights and inputs.

Each class of the JAX package's ``models/layers.py`` that the flagship does
not use is built from its flax tree (``model.init``), the tree's numpy
leaves carried by ``utils/convert.layer_state_dict_from_flax`` and loaded
with ``strict=True``, and run in eval mode and in train mode (batch
statistics, the updated running statistics compared too), f32, within
rtol 1e-4 / atol 1e-4 as ``test_torch_model.py`` holds the trunk.  Then a
whole ``Model`` of each hub family, on small ultralytics legacy-layout
configs parsed through ``normalize_legacy_cfg``, against JAX's model on
weights from ``state_dict_from_flax``; and the activation table.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.models import layers as JL
from hd_yolo_tpu_torch.models import layers as L
from hd_yolo_tpu_torch.models.yolo import Model, _NO_C_IN, _WITH_C_IN
from hd_yolo_tpu_torch.utils.convert import layer_state_dict_from_flax, state_dict_from_flax
from torch_port_common import random_tree

TOL = dict(rtol=1e-4, atol=1e-4)

# (case id, class, input channels, the JAX package's args, input size)
LAYERS = [
    ("DWConv", "DWConv", 16, (32, 3, 2), 16),
    ("BottleneckCSP", "BottleneckCSP", 16, (32, 2), 16),
    ("TransformerBlock", "TransformerBlock", 16, (32, 4, 2), 8),
    ("C3TR", "C3TR", 16, (32, 2), 8),
    ("SPP", "SPP", 16, (32, (3, 5, 7)), 16),
    ("C3SPP", "C3SPP", 16, (32,), 16),
    ("Focus", "Focus", 3, (16, 3), 16),
    ("GhostConv", "GhostConv", 16, (32, 3, 2), 16),
    ("GhostBottleneck-s2", "GhostBottleneck", 16, (32, 3, 2), 16),
    ("GhostBottleneck-s1", "GhostBottleneck", 16, (16, 3, 1), 16),
    ("GhostBottleneck-zero-shortcut", "GhostBottleneck", 16, (32, 3, 1), 16),
    ("C3Ghost", "C3Ghost", 16, (32, 2), 16),
    ("CrossConv", "CrossConv", 16, (16, 3, 1, 1, 1.0, True), 16),
    ("Contract", "Contract", 16, (2,), 16),
    ("Expand", "Expand", 16, (2,), 16),
    ("MaxPool2d", "MaxPool2d", 16, (3, 2, 1), 15),
    ("ZeroPad2d", "ZeroPad2d", 16, ((0, 1, 2, 3),), 16),
    ("BatchNorm2d", "BatchNorm2d", 16, (), 16),
    ("MixConv2d", "MixConv2d", 16, (30, (1, 3, 5), 1), 16),
]


def port_layer(name, c_in, args):
    if name in _NO_C_IN:
        return _NO_C_IN[name](*args)
    klass = _WITH_C_IN.get(name) or getattr(L, name)
    return klass(c_in, *args)


def flax_layer(name, args):
    return getattr(JL, name)(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# a TransformerBlock's dense and attention layers (no normalization between
# them): at flax's own init, since He-normal weights drive its attention
# logits past 200, where f32 rounding alone moves JAX's output and the
# port's beyond the tolerance from the f64 result
_DENSE = re.compile(r"^(pos|[qkv]\d+|ma\d+|fc[12]_\d+)$")


def seeded(init_tree, seed):
    """``random_tree`` of the flax init's shapes, the transformer's dense
    and attention layers left at their init values."""
    def keep(tree, init):
        if not hasattr(tree, "items"):
            return tree
        return {k: init[k] if _DENSE.match(k) else keep(v, init[k]) for k, v in tree.items()}

    init_tree = _np(init_tree)
    return keep(random_tree(init_tree, seed=seed), init_tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case,name,c_in,args,size", LAYERS, ids=[c[0] for c in LAYERS])
def test_zoo_layer_matches_jax(case, name, c_in, args, size, train):
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, size, size, c_in)).astype(np.float32)
    jm = flax_layer(name, args)
    # eager, not jitted: the JAX MixConv2d counts its splits on concrete values
    variables = seeded(jm.init(jax.random.PRNGKey(0), jnp.zeros_like(jnp.asarray(x)),
                               train=False), len(case))
    holder = torch.nn.Module()
    holder.layer = port_layer(name, c_in, args)
    holder.load_state_dict(layer_state_dict_from_flax(variables, name, "layer"), strict=True)
    holder.train(train)
    if train:
        want, new = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    got = holder.layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    if train and variables.get("batch_stats"):
        sd = layer_state_dict_from_flax({**variables, "batch_stats": _np(new["batch_stats"])},
                                        name, "layer")
        stats = {k: v for k, v in holder.state_dict().items() if k.endswith(("_mean", "_var"))}
        assert stats
        for k, v in stats.items():
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), err_msg=k, **TOL)


def test_every_jax_layer_row_has_a_port_branch():
    """``_build_layer`` builds every row module the JAX package's builder
    accepts, and nothing else."""
    from hd_yolo_tpu.models.yolo import _MODULES

    assert set(_MODULES) == set(_WITH_C_IN) | set(_NO_C_IN) | {"Conv"}


# ----------------------------------------------------------------- whole models
ANCHORS2 = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]]


def legacy(backbone, head, gw=0.25, gd=0.33, nc=4):
    return {"nc": nc, "depth_multiple": gd, "width_multiple": gw, "anchors": ANCHORS2,
            "backbone": backbone, "head": head}


FAMILIES = {
    # yolov5s-ghost (v6.0 layout), cut to two levels
    "ghost": legacy(
        [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "GhostConv", [128, 3, 2]],
         [-1, 3, "C3Ghost", [128]], [-1, 1, "GhostConv", [256, 3, 2]],
         [-1, 1, "C3Ghost", [256]], [-1, 1, "SPPF", [256, 5]]],
        [[-1, 1, "GhostConv", [128, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 2], 1, "Concat", [1]], [-1, 1, "C3Ghost", [128, False]],
         [-1, 1, "GhostConv", [128, 3, 2]], [[-1, 6], 1, "Concat", [1]],
         [-1, 1, "C3Ghost", [256, False]], [[9, 12], 1, "Detect", ["nc", "anchors"]]]),
    # yolov5s v3.1: Focus, BottleneckCSP, SPP
    "v3.1-csp": legacy(
        [[-1, 1, "Focus", [64, 3]], [-1, 1, "Conv", [128, 3, 2]],
         [-1, 3, "BottleneckCSP", [128]], [-1, 1, "Conv", [256, 3, 2]],
         [-1, 1, "SPP", [256, [5, 9, 13]]], [-1, 1, "BottleneckCSP", [256, False]]],
        [[-1, 1, "Conv", [128, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 2], 1, "Concat", [1]], [-1, 1, "BottleneckCSP", [128, False]],
         [[9, 5], 1, "Detect", ["nc", "anchors"]]]),
    # yolov3-tiny-like: nn.MaxPool2d and nn.ZeroPad2d rows, a -2 reference
    "v3-tiny": legacy(
        [[-1, 1, "Conv", [16, 3, 1]], [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
         [-1, 1, "Conv", [32, 3, 1]], [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
         [-1, 1, "Conv", [64, 3, 1]], [-1, 1, "nn.MaxPool2d", [2, 2, 0]],
         [-1, 1, "Conv", [128, 3, 1]], [-1, 1, "nn.ZeroPad2d", [[0, 1, 0, 1]]],
         [-1, 1, "nn.MaxPool2d", [2, 1, 0]], [-1, 1, "Conv", [128, 3, 1]],
         [-1, 1, "nn.MaxPool2d", [2, 2, 0]]],
        [[-1, 1, "Conv", [128, 1, 1]], [-2, 1, "Conv", [64, 1, 1]],
         [-1, 1, "nn.Upsample", [None, 2, "nearest"]], [[-1, 9], 1, "Concat", [1]],
         [-1, 1, "Conv", [128, 3, 1]], [[15, 11], 1, "Detect", ["nc", "anchors"]]],
        gw=1.0, gd=1.0),
    # C3TR (yolov5s-transformer's last backbone C3), a standalone BatchNorm and DWConv
    "c3tr": legacy(
        [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]],
         [-1, 1, "C3", [128]], [-1, 1, "DWConv", [256, 3, 2]],
         [-1, 1, "nn.BatchNorm2d", [256]], [-1, 2, "C3TR", [256]]],
        [[-1, 1, "Conv", [128, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 2], 1, "Concat", [1]], [-1, 1, "C3", [128, False]],
         [[9, 5], 1, "Detect", ["nc", "anchors"]]]),
    # yolov5x6 (v6.0 models/hub/yolov5x6.yaml) row for row: P3-P6, the 6x6
    # stem, SPPF, four Detect inputs; at a small width and depth, 128 px
    "x6": dict(legacy(
        [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 3, "C3", [128]],
         [-1, 1, "Conv", [256, 3, 2]], [-1, 6, "C3", [256]], [-1, 1, "Conv", [512, 3, 2]],
         [-1, 9, "C3", [512]], [-1, 1, "Conv", [768, 3, 2]], [-1, 3, "C3", [768]],
         [-1, 1, "Conv", [1024, 3, 2]], [-1, 3, "C3", [1024]], [-1, 1, "SPPF", [1024, 5]]],
        [[-1, 1, "Conv", [768, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 8], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
         [-1, 1, "Conv", [512, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 6], 1, "Concat", [1]], [-1, 3, "C3", [512, False]],
         [-1, 1, "Conv", [256, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
         [[-1, 4], 1, "Concat", [1]], [-1, 3, "C3", [256, False]],
         [-1, 1, "Conv", [256, 3, 2]], [[-1, 20], 1, "Concat", [1]],
         [-1, 3, "C3", [512, False]], [-1, 1, "Conv", [512, 3, 2]],
         [[-1, 16], 1, "Concat", [1]], [-1, 3, "C3", [768, False]],
         [-1, 1, "Conv", [768, 3, 2]], [[-1, 12], 1, "Concat", [1]],
         [-1, 3, "C3", [1024, False]], [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]]],
        gw=0.125, gd=0.33), anchors=[[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
                                     [140, 301, 303, 264, 238, 542],
                                     [436, 615, 739, 380, 925, 792]]),
    # the rest of the zoo in one trunk: MixConv2d, CrossConv, Contract,
    # Expand, C3SPP, GhostBottleneck at stride 2, a repeated row
    "mix": legacy(
        [[-1, 1, "Conv", [32, 3, 1]], [-1, 1, "Contract", [2]],
         [-1, 1, "MixConv2d", [64, [1, 3, 5], 1]], [-1, 2, "CrossConv", [64, 3, 1, 1, 1.0, True]],
         [-1, 1, "GhostBottleneck", [128, 3, 2]], [-1, 1, "C3SPP", [128]],
         [-1, 1, "Conv", [256, 3, 2]]],
        [[-1, 1, "Expand", [2]], [[-1, 5], 1, "Concat", [1]], [-1, 1, "Conv", [128, 1, 1]],
         [[9, 6], 1, "Detect", ["nc", "anchors"]]],
        gw=0.5, gd=1.0),
}


# input size by family (64 px else): the P6 family needs 128 for a 2 x 2 P6 map
SIZES = {"x6": 128}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hub_family_model_matches_jax(family):
    cfg = FAMILIES[family]
    size = SIZES.get(family, 64)
    x = np.random.default_rng(1).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    jm = JaxModel.from_cfg(cfg, "hyp-nuclei")
    # eager init (the MixConv2d split needs concrete values)
    tree = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = seeded(tree, 3)
    tm = Model.from_cfg(cfg, "hyp-nuclei")
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    want = jm.apply(variables, jnp.asarray(x), method=lambda m, v: m.trunk(v))
    with torch.no_grad():
        got = tm.trunk(torch.from_numpy(x))
    for j in tm.spec.headers[0].from_idx:
        w = np.asarray(want[j])
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(got[j].permute(0, 2, 3, 1).numpy(), w, err_msg=str(j), **TOL)


# ----------------------------------------------------------------- activations
@pytest.mark.parametrize("act", list(JL._ACTIVATIONS), ids=str)
def test_activation_table_matches_jax(act):
    x = np.linspace(-8, 8, 257, dtype=np.float32)
    want = np.asarray(JL.get_activation(act)(jnp.asarray(x)))
    np.testing.assert_allclose(L._act(act)(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["relu", "hardswish", "leaky_relu", "gelu"])
def test_conv_with_activation_matches_jax(act):
    """A ``Conv`` row's activation argument reaches the port's ``ConvBnAct``,
    whose stem-kernel gate stays on SiLU only."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JL.ConvBnAct(16, 6, 2, 2, act=act)
    variables = random_tree(_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=5)
    holder = torch.nn.Module()
    holder.layer = L.ConvBnAct(3, 16, 6, 2, 2, act=act)
    holder.load_state_dict(layer_state_dict_from_flax(variables, "Conv", "layer"), strict=True)
    holder.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert not holder.layer.is_stem(xt)
    with torch.no_grad():
        got = holder.layer(xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)
