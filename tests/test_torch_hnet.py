"""PyTorch port, hnet inference: each module and the whole ``HNet`` forward
against the JAX package on the same numpy weights (``random_variables``,
converted by ``hnet_state_dict_from_flax``) and inputs, all in f32 on the
CPU (the port's plain path).

Tolerances: Swin, FPN, connector and ROI pyramids atol 1e-4; anchors exact;
RPN proposal validity exact, boxes atol 1e-3; the whole forward: seg and cl
probabilities atol 1e-4, at least 98% of the JAX detections found again
(same label, IoU >= 0.9), masks of matched detections mean |d| <= 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.hnet import HNet as JaxHNet
from hd_yolo_tpu.hnet.feature_mosaic import extract_roi_feature_maps as jax_extract
from hd_yolo_tpu.hnet.fpn import FeaturePyramidNetwork as JaxFPN
from hd_yolo_tpu.hnet.fpn import PanopticFeatureConnector as JaxConnector
from hd_yolo_tpu.hnet.mask_rcnn import MaskRCNN as JaxMaskRCNN
from hd_yolo_tpu.hnet.mask_rcnn import generate_anchors as jax_anchors
from hd_yolo_tpu.hnet.swin import SwinTransformer as JaxSwin
from hd_yolo_tpu.ops import batched_nms_padded as jax_batched_nms_padded
from hd_yolo_tpu.wsi.tiling import sliding_window_grid as jax_grid
from hd_yolo_tpu_torch import load_cfg
from hd_yolo_tpu_torch.hnet import HNet, MaskRCNN, SwinTransformer
from hd_yolo_tpu_torch.hnet.feature_mosaic import extract_roi_feature_maps
from hd_yolo_tpu_torch.hnet.fpn import FeaturePyramidNetwork, PanopticFeatureConnector
from hd_yolo_tpu_torch.hnet.mask_rcnn import generate_anchors
from hd_yolo_tpu_torch.ops.boxes import box_iou
from hd_yolo_tpu_torch.ops.nms import batched_nms_padded, nms_dispatch
from hd_yolo_tpu_torch.utils.convert import (fpn_state_dict_from_flax, hnet_state_dict_from_flax,
                                             maskrcnn_state_dict_from_flax,
                                             panoptic_state_dict_from_flax,
                                             swin_state_dict_from_flax)
from hd_yolo_tpu_torch.wsi.tiling import sliding_window_grid
from torch_port_common import random_tree, random_variables

# tests/test_hnet.py's hnet_setup shape, plus a cl header at amplification 0.5
CFG = {
    "backbone": {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                 "num_heads": [1, 2, 4, 8], "window_size": 4},
    "fpn": {"out_channels": 32},
    "headers": {
        "det40x": {"type": "maskrcnn", "num_classes": 3, "pre_nms_topk": 128,
                   "num_proposals": 32, "num_detections": 16,
                   "anchor_sizes": [16.0, 32.0, 64.0, 128.0]},
        "seg10x": {"type": "panoptic", "num_classes": 4, "channels": 32},
        "cl5x": {"type": "cl", "num_classes": 3, "hidden": 32, "amplification": 0.5},
    },
    "constrains": {"c0": {"seg_task": "seg10x", "det_task": "det40x", "edges": [[1, 1], [2, 2]]}},
}
X_SHAPE = (2, 64, 64, 3)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def hnet_pair():
    jm = JaxHNet.from_cfg(CFG)
    variables = random_variables(jm, X_SHAPE, seed=0)
    x = np.random.default_rng(1).uniform(0, 1, X_SHAPE).astype(np.float32)
    _, want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, jnp.asarray(x))
    model = HNet(CFG, device="cpu")
    model.load_state_dict(hnet_state_dict_from_flax(variables, CFG), strict=True)
    return model.eval(), variables, x, jax.tree.map(np.asarray, want)


def match_detections(got, want):
    """(matched, total): ``want``'s valid detections that ``got`` finds
    again with the same label at IoU >= 0.9, and the matched mask pairs."""
    matched, total, pairs = 0, 0, []
    for i in range(len(want["valid"])):
        vw, vg = np.asarray(want["valid"][i], bool), np.asarray(got["valid"][i], bool)
        total += int(vw.sum())
        if not (vw.any() and vg.any()):
            continue
        iou = box_iou(torch.as_tensor(np.asarray(want["boxes"][i])[vw], dtype=torch.float32),
                      torch.as_tensor(np.asarray(got["boxes"][i])[vg], dtype=torch.float32))
        best, j = iou.max(1)
        same = np.asarray(got["labels"][i])[vg][j.numpy()] == np.asarray(want["labels"][i])[vw]
        ok = (best.numpy() >= 0.9) & same
        matched += int(ok.sum())
        wi, gi = np.flatnonzero(vw)[ok], np.flatnonzero(vg)[j.numpy()[ok]]
        pairs += [(np.asarray(got["masks"][i][g]), np.asarray(want["masks"][i][w]))
                  for g, w in zip(gi, wi)]
    return matched, total, pairs


def test_hnet_state_dict_loads_strict(hnet_pair):
    model, variables, _, _ = hnet_pair
    sd = hnet_state_dict_from_flax(variables, CFG)
    assert set(sd) == set(model.state_dict())
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_hnet_forward_matches_jax(hnet_pair):
    model, _, x, want = hnet_pair
    losses, got = model(torch.from_numpy(x))
    assert losses == {"det40x": {}, "seg10x": {}, "cl5x": {}}
    for task in ("seg10x", "cl5x"):
        assert got[task]["probs"].shape == want[task]["probs"].shape
        _close(got[task]["probs"], want[task]["probs"], 1e-4)
    d = {k: v.numpy() for k, v in got["det40x"].items()}
    assert d["boxes"].shape == (2, 16, 4) and d["masks"].shape == (2, 16, 28, 28)
    matched, total, pairs = match_detections(d, want["det40x"])
    assert total >= 16 and matched >= 0.98 * total, (matched, total)
    assert np.mean([np.abs(g - w).mean() for g, w in pairs]) <= 1e-3
    assert np.all(d["labels"][~d["valid"]] == -100)
    assert np.all(d["masks"][~d["valid"]] == 0)


def test_hnet_uint8_input_is_divided_by_255(hnet_pair):
    model = hnet_pair[0]
    x = np.random.default_rng(2).integers(0, 256, X_SHAPE, dtype=np.uint8)
    _, a = model(torch.from_numpy(x))
    _, b = model(torch.from_numpy(x).float() / 255.0)
    torch.testing.assert_close(a["seg10x"]["probs"], b["seg10x"]["probs"], rtol=0, atol=0)


def test_swin_stage_with_shift_and_padding_matches_jax(rng):
    """One stage of two blocks (W-MSA, then SW-MSA) on a 10x10 patch grid,
    padded to 12 inside each block."""
    kw = dict(embed_dim=16, depths=(2,), num_heads=(2,), window_size=4, out_indices=(0,))
    jm = JaxSwin(**kw)
    x = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = random_tree(shapes, seed=3)
    want = jm.apply(v, jnp.asarray(x))
    m = SwinTransformer(**kw)
    m.load_state_dict(_t(swin_state_dict_from_flax(v["params"])), strict=True)
    (got,) = m(torch.from_numpy(x))
    assert got.shape == (2, 10, 10, 16)
    _close(got, want[0], 1e-4)


def test_fpn_connector_and_roi_crops_match_jax(rng):
    chans = (16, 24, 32, 48)
    feats = [rng.standard_normal((2, 16 >> i, 16 >> i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    jf = [jnp.asarray(f) for f in feats]
    fpn = JaxFPN(out_channels=32, extra_blocks=2)
    vf = random_tree(jax.eval_shape(lambda: fpn.init(jax.random.PRNGKey(0), jf)), seed=4)
    conn = JaxConnector(out_channels=32)
    want_p = fpn.apply(vf, jf)
    vc = random_tree(jax.eval_shape(lambda: conn.init(jax.random.PRNGKey(0), want_p[:4])), seed=5)
    rois = np.asarray([[[0, 0, 64, 64]], [[8, 4, 40, 60]]], np.float32)
    want_r = fpn.apply(vf, jf, jnp.asarray(rois), (4.0, 8.0, 16.0, 32.0), 8,
                       method=JaxFPN.forward_rois)

    m = FeaturePyramidNetwork(chans, 32, extra_blocks=2)
    m.load_state_dict(_t(fpn_state_dict_from_flax(vf["params"])), strict=True)
    c = PanopticFeatureConnector(32, 32)
    c.load_state_dict({k.split(".", 1)[1]: v for k, v in _t(panoptic_state_dict_from_flax(
        {"connector": vc["params"]})).items()}, strict=True)
    tf = [torch.from_numpy(f) for f in feats]
    got_p = m(tf)
    assert len(got_p) == 6
    for g, w in zip(got_p, want_p):
        _close(g, w, 1e-4)
    _close(c(got_p[:4]), conn.apply(vc, want_p[:4]), 1e-4)
    got_r = m.forward_rois(tf, torch.from_numpy(rois), (4.0, 8.0, 16.0, 32.0), 8)
    for g, w in zip(got_r, want_r):
        _close(g, w, 1e-4)


def test_extract_roi_feature_maps_matches_jax(rng):
    strides = (4.0, 8.0, 16.0, 32.0)
    feats = [rng.standard_normal((2, 32 >> i, 24 >> i, 8)).astype(np.float32) for i in range(4)]
    rois = rng.uniform(-10, 100, (2, 3, 4)).astype(np.float32)
    rois[..., 2:] = rois[..., :2] + rng.uniform(4, 80, (2, 3, 2))
    want = jax_extract([jnp.asarray(f) for f in feats], jnp.asarray(rois), strides, 16, 0.75)
    got = extract_roi_feature_maps([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
                                   strides, 16, 0.75)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert got[3].shape[2] == 1                       # round(16·0.75) >> 3 = 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_generate_anchors_exact():
    shapes, strides, sizes = [(5, 7), (3, 4), (2, 2), (1, 1)], (4.0, 8.0, 16.0, 32.0), \
        (16.0, 32.0, 64.0, 128.0)
    for g, w in zip(generate_anchors(shapes, strides, sizes), jax_anchors(shapes, strides, sizes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rpn_proposals_match_jax(rng):
    kw = dict(num_classes=3, anchor_sizes=(16.0, 32.0, 64.0, 128.0), pre_nms_topk=200,
              num_proposals=48)
    jm = JaxMaskRCNN(**kw)
    feats = [rng.standard_normal((2, 16 >> i, 16 >> i, 32)).astype(np.float32) for i in range(4)]
    jf = [jnp.asarray(f) for f in feats]
    v = random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jf, (64, 64))), seed=6)
    _, _, _, want_b, want_v = jm.apply(v, jf, (64, 64), method=JaxMaskRCNN._propose)
    m = MaskRCNN(32, **kw)
    m.load_state_dict(_t(maskrcnn_state_dict_from_flax(v["params"])), strict=True)
    with torch.no_grad():
        got_b, got_v = m.propose([torch.from_numpy(f) for f in feats], (64, 64))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.sum() > 10
    keep = np.asarray(want_v)
    np.testing.assert_allclose(got_b.numpy()[keep], np.asarray(want_b)[keep], rtol=0, atol=1e-3)


def test_batched_nms_offsets_each_image_by_its_own_span():
    """A (B, K) batch whose images have very different extents: the class
    offset is each image's own span, as JAX computes it under ``vmap``.  The
    threshold sits between a pair's IoU under its own image's offset and
    under the batch-wide one, so a batch-wide span would flip the decision."""
    b0 = np.asarray([[12.74, 5.4, 18.15, 10.57], [13.11, 5.61, 18.28, 8.502],
                     [20.3, 20.7, 30.1, 33.9]], np.float32)
    b1 = b0 * 377.0 + np.float32(3.7)
    boxes = np.stack([b0, b1])
    scores = np.asarray([[0.9, 0.8, 0.7]] * 2, np.float32)
    labels = np.asarray([[2, 2, 1]] * 2, np.int32)
    valid = np.ones((2, 3), bool)

    def pair_iou(span):
        off = torch.from_numpy(boxes[0] + labels[0][:, None].astype(np.float32) * span)
        return float(box_iou(off[:1], off[1:2]))

    own = np.float32(boxes[0].max() + 1.0)
    batch = np.float32(boxes.max() + 1.0)
    assert pair_iou(own) != pair_iou(batch)
    thr = (pair_iou(own) + pair_iou(batch)) / 2
    idx, keep = batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                   torch.from_numpy(labels), torch.from_numpy(valid), thr, 3)
    for i in range(2):
        ji, jk = jax_batched_nms_padded(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                        jnp.asarray(labels[i]), jnp.asarray(valid[i]), thr, 3)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
    # the batch-wide span decides image 0 the other way
    off = torch.from_numpy(boxes + labels[..., None].astype(np.float32) * batch)
    _, wrong = nms_dispatch(off, torch.from_numpy(scores), torch.from_numpy(valid), thr, 3)
    assert not torch.equal(wrong[0], keep[0])


def test_hnet_nucls_builds_with_the_jax_parameter_count():
    """The count comes from ``jax.eval_shape`` of the JAX init (no forward
    runs).  128 px gives the panoptic connector the same hops as 640 px."""
    jm = JaxHNet.from_cfg(jax_load_cfg("hnet-nucls"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 128, 128, 3)), train=False))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    m = HNet(load_cfg("hnet-nucls"), device="cpu")
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_hnet_from_cfg_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        HNet.from_cfg(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        HNet(CFG)
    m = HNet.from_cfg(CFG, device="cpu", seed=3)
    assert next(m.parameters()).device.type == "cpu" and not m.training


NEW_PARTS = {
    "darknet": {**CFG, "backbone": {"type": "darknet"}},
    "keypoints": {**CFG, "headers": {"det40x": {**CFG["headers"]["det40x"], "num_keypoints": 5}}},
    "fcos": {**CFG, "headers": {**CFG["headers"], "d": {"type": "fcos", "num_classes": 2}}},
}


@pytest.mark.parametrize("part", list(NEW_PARTS))
def test_hnet_builds_each_part_from_jax_weights(part):
    """The darknet backbone (at its defaults), the keypoint branch and the
    FCOS header each build and take JAX's weights with ``strict=True``, with
    JAX's parameter count (the whole model's, from ``jax.eval_shape``)."""
    cfg = NEW_PARTS[part]
    jm = JaxHNet.from_cfg(cfg)
    variables = random_variables(jm, X_SHAPE, seed=1)
    model = HNet(cfg, device="cpu")
    model.load_state_dict(hnet_state_dict_from_flax(variables, cfg), strict=True)
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    keys = set(model.state_dict())
    want = {"darknet": "backbone.layers.8.m.0.cv2.bn.running_var",
            "keypoints": "headers.det40x.roi_heads.keypoint_predictor.kps_score_lowres.weight",
            "fcos": "headers.d.scales.3.scale"}[part]
    assert want in keys


@pytest.mark.parametrize("h,w,tile,overlap", [(640, 640, 640, 0), (1000, 700, 640, 64),
                                              (64, 300, 32, 0), (2000, 2000, 512, 128)])
def test_sliding_window_grid_matches_jax(h, w, tile, overlap):
    np.testing.assert_array_equal(sliding_window_grid(h, w, tile, overlap),
                                  jax_grid(h, w, tile, overlap))
