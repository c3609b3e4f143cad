"""PyTorch port, hnet training: ``HNet(x, targets)`` in training mode, its
losses and gradients, the target functions, heads and constrain modules,
and one ``make_train_step`` update, against the JAX package on the same
numpy weights (``random_variables`` converted by
``hnet_state_dict_from_flax``) and batch, in f32 on the CPU.  The model is
``test_torch_hnet.py``'s small hnet (64 px, Swin ``embed_dim`` 32, depths
1/1/1/1, no drop path) with two constrains on edges 1-3: the mask-weighted
one of hnet-nucls and the box-mean one.

Gradient semantics.  On the card every ROI-align runs a kernel whose
backward gives the boxes no gradient, as JAX's TPU kernels' vjps do
(``RoiAlignBoundedFn``, ``RoiAlignLevelsFn``, on the CPU too).  JAX on the
CPU differentiates its XLA ROI-aligns in the boxes as well, into the RPN
deltas and the box head's regression.  So the JAX gradients here are taken
with the box argument of each ROI-align it calls wrapped in
``jax.lax.stop_gradient`` (the names ``multiscale_roi_align_batched`` of
``hnet.mask_rcnn`` and ``roi_align`` of ``hnet.feature_mosaic`` and
``hnet.heads``, patched for the fixture only).  ``stop_gradient`` is the
identity on values, so the same compiled JAX function gives the losses
too; the 'dynamic' FPN's losses come from the unpatched JAX forward.

Tolerances: loss items rtol 1e-5 + atol 1e-6; gradients per tensor within
1e-3 of the larger of its max|g| and 1e-3 of the model's largest |g| (the
connector's conv biases feed a GroupNorm, so their exact gradient is 0 and
both sides leave rounding noise of ~1e-8), the mask head's within 2e-2 as
in ``test_torch_train_step.py`` (sums of cancelling terms behind five
ReLUs; measured 1.4e-3 here, every other tensor within 5.2e-4); one
update's parameter changes within 1e-3 of each tensor's largest change
(2e-2 in the mask head), plus 1e-6 of its weights.
The JAX side is compiled once per function (the whole file takes about a
minute on one CPU worker).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hd_yolo_tpu.hnet.feature_mosaic as jax_mosaic
import hd_yolo_tpu.hnet.heads as jax_heads
import hd_yolo_tpu.hnet.mask_rcnn as jax_mrcnn
from hd_yolo_tpu.engines import optim as joptim
from hd_yolo_tpu.engines.train_step import TrainState as JaxTrainState
from hd_yolo_tpu.engines.train_step import make_train_step as jax_make_train_step
from hd_yolo_tpu.hnet import HNet as JaxHNet
from hd_yolo_tpu.hnet.swin import SwinTransformer as JaxSwin
from hd_yolo_tpu_torch.engines import optim as toptim
from hd_yolo_tpu_torch.engines.train_step import TrainState, make_eval_step, make_train_step
from hd_yolo_tpu_torch.hnet import HNet, SwinTransformer
from hd_yolo_tpu_torch.hnet import heads, mask_rcnn
from hd_yolo_tpu_torch.hnet.feature_mosaic import mosaic_roi_feature_maps, mosaic_targets
from hd_yolo_tpu_torch.hnet.swin import DropPath
from hd_yolo_tpu_torch.utils.convert import (hnet_state_dict_from_flax,
                                             panoptic_state_dict_from_flax,
                                             swin_state_dict_from_flax)
from test_torch_hnet import CFG as INFER_CFG
from test_torch_hnet import X_SHAPE
from torch_port_common import random_tree, random_variables

CFG = copy.deepcopy(INFER_CFG)
CFG["headers"]["cl5x"]["loss_weight"] = 2.0
CFG["constrains"] = {
    "c0": {"seg_task": "seg10x", "det_task": "det40x", "weighting": "mask",
           "edges": [[1, 1], [2, 2], [3, 3]], "values": [1.0, 0.5, 1.0]},
    "c1": {"seg_task": "seg10x", "det_task": "det40x", "edges": [[1, 1], [2, 2], [3, 3]],
           "loss_weight": 0.5},
}
B, T = X_SHAPE[0], 6
MASK_WEIGHT = 0.7
HYP = {"lr0": 0.005, "warmup_epochs": 3.0, "clip_grad_norm": 10.0}


def make_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    xy = rng.uniform(0.1, 0.5, (B, T, 2)).astype(np.float32)
    wh = rng.uniform(0.15, 0.4, (B, T, 2)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, -1] = False
    t = {"det40x": {"boxes": np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1),
                    "labels": rng.integers(1, 4, (B, T)),
                    "masks": (rng.uniform(0, 1, (B, T, 28, 28)) > 0.5).astype(np.float32),
                    "valid": valid},
         "seg10x": {"seg_map": rng.integers(0, 4, (B, 16, 16))},
         "cl5x": {"label": np.asarray([1, -1])}}      # an ignored label
    return x, t


def to_torch(t):
    return {task: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            for task, d in t.items()}


def stop_boxes(fn):
    """``fn`` with its second argument (the boxes) under ``stop_gradient``."""
    def wrapped(features, boxes, *a, **k):
        return fn(features, jax.lax.stop_gradient(boxes), *a, **k)
    return wrapped


def boxes_stopped(mp):
    mp.setattr(jax_mrcnn, "multiscale_roi_align_batched",
               stop_boxes(jax_mrcnn.multiscale_roi_align_batched))
    mp.setattr(jax_mosaic, "roi_align", stop_boxes(jax_mosaic.roi_align))
    mp.setattr(jax_heads, "roi_align", stop_boxes(jax_heads.roi_align))


def with_fpn(fpn_type):
    cfg = copy.deepcopy(CFG)
    cfg["fpn"]["type"] = fpn_type
    return cfg


def port_model(cfg, variables):
    m = HNet(cfg, device="cpu")
    m.load_state_dict(hnet_state_dict_from_flax(variables, cfg), strict=True)
    return m.train()


@pytest.fixture(scope="module")
def ref():
    """The JAX side, each function compiled once: losses and gradients
    ('fpn', ROI-align boxes stopped), losses ('dynamic', unmodified), and
    two updates of JAX's ``make_train_step`` (boxes stopped)."""
    jm = JaxHNet.from_cfg(CFG)
    variables = random_variables(jm, X_SHAPE, seed=0)
    x, t = make_batch()
    jx, jt = jnp.asarray(x), jax.tree.map(jnp.asarray, t)
    out = {"variables": variables, "x": x, "t": t}

    def loss_fn(params):
        losses, _ = jm.apply({"params": params}, jx, jt, train=True)
        return jm.total_loss(losses, MASK_WEIGHT), losses

    with pytest.MonkeyPatch.context() as mp:
        boxes_stopped(mp)
        (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        out["fpn"] = (float(total), jax.tree.map(float, losses), jax.tree.map(np.asarray, grads))
        tx = joptim.build_optimizer(variables["params"], HYP, 10, 10)
        state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx)
        step = jax_make_train_step(jm, tx)
        metrics = []
        for _ in range(2):
            state, m = step(state, {"image": jx, "targets": jt})
            metrics.append(jax.tree.map(float, m))
        out["step"] = (jax.tree.map(np.asarray, state.params), metrics)

    jd = JaxHNet.from_cfg(with_fpn("dynamic"))
    losses, _ = jax.jit(lambda p: jd.apply({"params": p}, jx, jt, train=True))(
        variables["params"])
    out["dynamic"] = jax.tree.map(float, losses)
    return out


@pytest.fixture(scope="module")
def port_fpn(ref):
    """The port's 'fpn' losses and gradients on the same weights and batch."""
    m = port_model(CFG, ref["variables"])
    losses, _ = m(torch.from_numpy(ref["x"]), to_torch(ref["t"]))
    total = m.total_loss(losses, MASK_WEIGHT)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return m, losses, total, dict(zip(names, grads))


def check_losses(got, want):
    assert set(got) == set(want)
    for task, d in want.items():
        assert set(got[task]) == set(d), task
        for k, v in d.items():
            g = float(got[task][k].detach())
            assert np.isfinite(g) and abs(g - v) <= 1e-5 * abs(v) + 1e-6, (task, k, g, v)


@pytest.mark.parametrize("fpn_type", ["fpn", "dynamic"])
def test_hnet_train_losses_match_jax(ref, port_fpn, fpn_type):
    if fpn_type == "fpn":
        got = port_fpn[1]
        want = ref["fpn"][1]
    else:
        m = port_model(with_fpn("dynamic"), ref["variables"])
        with torch.no_grad():
            got, _ = m(torch.from_numpy(ref["x"]), to_torch(ref["t"]))
        want = ref["dynamic"]
    check_losses(got, want)
    assert set(want["det40x"]) == {"rpn_obj_loss", "rpn_reg_loss", "roi_cls_loss",
                                   "roi_reg_loss", "mask_loss"}
    assert set(want["constrains"]) == {"c0", "c1"} and want["constrains"]["c0"] < 13.8
    assert want["cl5x"]["cl_loss"] > 0 and want["seg10x"]["seg_loss"] > 0


def test_hnet_total_loss_weights_match_jax(ref, port_fpn):
    """Per-task ``loss_weight``, the constrains' own weights and
    ``mask_weight`` on the terms holding "mask"."""
    m, losses, total, _ = port_fpn
    want = ref["fpn"][0]
    assert abs(float(total.detach()) - want) <= 1e-5 * abs(want)
    jm = JaxHNet.from_cfg(CFG)
    for mw in (1.0, 0.0):
        w = float(jm.total_loss(ref["fpn"][1], mw))
        assert abs(float(m.total_loss(losses, mw).detach()) - w) <= 1e-5 * abs(w)
    plain = sum(float(v) for d in ref["fpn"][1].values() for v in d.values())
    assert abs(float(total.detach()) - plain) > 0.1          # the weights change the total


def test_hnet_gradients_match_jax_with_roi_boxes_stopped(ref, port_fpn):
    got = port_fpn[3]
    want = hnet_state_dict_from_flax({"params": ref["fpn"][2]}, CFG)
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    nonzero = 0
    for name, w in want.items():
        g = got[name]
        assert g is not None, name
        w = w.numpy()
        rel = 2e-2 if ".mask_head." in name else 1e-3
        tol = rel * max(np.abs(w).max(), 1e-3 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol, err_msg=name)
        nonzero += int(np.abs(w).max() > 1e-6 * top)
    assert nonzero > 0.8 * len(want)


def test_train_step_update_matches_jax_make_train_step(ref):
    """Two updates of ``make_train_step`` with ``build_optimizer`` (lr0
    0.005, warmup 3 epochs, grad-norm clip 10) on both sides: the metrics
    and the parameters' changes."""
    m = port_model(CFG, ref["variables"])
    opt = toptim.build_optimizer(m, HYP, 10, 10)
    state = TrainState.create(m, opt)
    step = make_train_step()
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    batch = {"image": torch.from_numpy(ref["x"]), "targets": to_torch(ref["t"])}
    metrics = []
    for _ in range(2):
        state, met = step(state, batch)
        metrics.append(met)
    jparams, jmetrics = ref["step"]
    for got, want in zip(metrics, jmetrics):
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(float(got[k]) - v) <= 1e-4 * abs(v) + 1e-6, (k, float(got[k]), v)
    want = hnet_state_dict_from_flax({"params": jparams}, CFG)
    moved = 0
    for name, p in m.named_parameters():
        p0 = before[name].numpy()
        dw = want[name].numpy() - p0
        scale = max(np.abs(dw).max(), 1e-12)
        rel = 2e-2 if ".mask_head." in name else 1e-3
        np.testing.assert_allclose(p.detach().numpy() - p0, dw, rtol=0,
                                   atol=rel * scale + 1e-6 * np.abs(p0).max(), err_msg=name)
        moved += int(scale > 1e-7)
    assert moved > 0.8 * len(want) and int(state.step) == 2


def test_eval_step_takes_an_hnet(ref):
    m = port_model(CFG, ref["variables"])
    state = TrainState.create(m, toptim.build_optimizer(m, HYP, 10, 10))
    losses, out = make_eval_step()(state, torch.from_numpy(ref["x"]), to_torch(ref["t"]))
    check_losses(losses, ref["fpn"][1])
    empty, out2 = make_eval_step()(state, torch.from_numpy(ref["x"]))
    assert empty == {"det40x": {}, "seg10x": {}, "cl5x": {}}
    assert torch.equal(out["seg10x"]["probs"], out2["seg10x"]["probs"])


def test_label_params_match_jax_groups(ref):
    """Every parameter's group through the convert key map: each flax leaf
    numbered, carried across, read back.  LayerNorm and GroupNorm scales
    are ``bn_scale`` (no weight decay), as JAX labels every ``scale``."""
    variables = ref["variables"]
    m = port_model(CFG, variables)
    for freeze, jfreeze in ((None, None), (["headers.det40x."], ["header_det40x"])):
        labels = toptim.label_params(m, freeze)
        leaves, treedef = jax.tree.flatten(variables["params"])
        ids = jax.tree.unflatten(treedef, [np.full(l.shape, i, np.float32)
                                           for i, l in enumerate(leaves)])
        jlab = jax.tree.leaves(joptim.label_params(variables["params"], jfreeze))
        moved = hnet_state_dict_from_flax({"params": ids}, CFG)
        assert set(labels) == set(moved)
        for name, group in labels.items():
            assert group == jlab[int(moved[name].reshape(-1)[0])], name
        assert labels["backbone.layers.0.blocks.0.norm1.weight"] == "bn_scale"
        assert labels["headers.seg10x.connector.gn1_0.weight"] == "bn_scale"
        assert labels["backbone.layers.0.blocks.0.attn.relative_position_bias_table"] == "kernel"


def test_target_functions_match_jax(rng):
    anchors = rng.uniform(0, 60, (40, 2))
    anchors = np.concatenate([anchors, anchors + rng.uniform(2, 30, (40, 2))], -1)
    anchors = anchors.astype(np.float32)
    gt = np.stack([anchors[3], anchors[7], anchors[3] + 1.0, anchors[11]]).astype(np.float32)
    gt_valid = np.asarray([True, True, False, True])
    a_valid = rng.uniform(size=40) > 0.2
    a_valid[[3, 7, 11]] = True
    for av in (None, a_valid):
        jl, jm_ = jax_mrcnn.assign_targets(jnp.asarray(anchors), jnp.asarray(gt),
                                           jnp.asarray(gt_valid), 0.5, 0.3,
                                           None if av is None else jnp.asarray(av))
        tl, tm_ = mask_rcnn.assign_targets(torch.from_numpy(anchors), torch.from_numpy(gt),
                                           torch.from_numpy(gt_valid), 0.5, 0.3,
                                           None if av is None else torch.from_numpy(av))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
    # a batch of images with shared anchors, as the RPN loss calls it
    gtb = np.stack([gt, gt[::-1]])
    gvb = np.stack([gt_valid, gt_valid[::-1]])
    tl, tm_ = mask_rcnn.assign_targets(torch.from_numpy(anchors), torch.from_numpy(gtb),
                                       torch.from_numpy(gvb), 0.7, 0.3)
    for i in range(2):
        jl, jm_ = jax_mrcnn.assign_targets(jnp.asarray(anchors), jnp.asarray(gtb[i]),
                                           jnp.asarray(gvb[i]), 0.7, 0.3)
        np.testing.assert_array_equal(tl[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tm_[i].numpy(), np.asarray(jm_))

    deltas = mask_rcnn.encode_deltas(torch.from_numpy(anchors), torch.from_numpy(anchors[::-1]
                                                                                 .copy()))
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jax_mrcnn.encode_deltas(
        jnp.asarray(anchors), jnp.asarray(anchors[::-1]))), rtol=1e-5, atol=1e-5)
    x = rng.standard_normal(50).astype(np.float32) * 0.3
    np.testing.assert_allclose(mask_rcnn.smooth_l1(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_mrcnn.smooth_l1(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)
    labels = rng.integers(-1, 2, (2, 300))
    logits = rng.standard_normal((2, 300)).astype(np.float32) * 3
    for budget, frac in ((256.0, 0.5), (32.0, 0.25)):
        pos, neg = (labels == 1).astype(np.float32), (labels == 0).astype(np.float32)
        tw, tp, tn = mask_rcnn.sampler_weights(torch.from_numpy(pos), torch.from_numpy(neg),
                                               budget, frac)
        for i in range(2):
            jw, jp, jn = jax_mrcnn.sampler_weights(jnp.asarray(pos[i]), jnp.asarray(neg[i]),
                                                   budget, frac)
            np.testing.assert_allclose(tw[i].numpy(), np.asarray(jw), rtol=1e-6)
            assert abs(float(tp[i]) - float(jp)) <= 1e-6 and float(tn[i]) == float(jn)
            got = mask_rcnn.balanced_bce(torch.from_numpy(logits), torch.from_numpy(labels),
                                         budget, frac)[i]
            want = jax_mrcnn.balanced_bce(jnp.asarray(logits[i]), jnp.asarray(labels[i]),
                                          budget, frac)
            assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_soft_iou_and_panoptic_loss_at_another_gt_stride(rng):
    """The seg loss with a GT at half the probabilities' resolution: the
    probabilities are resized (antialiased) to the GT before scoring."""
    p = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 8, 8))]
    oh[1, ..., 2] = 0.0                                    # a class absent from one image
    assert abs(float(heads.soft_iou_loss(torch.from_numpy(p), torch.from_numpy(oh)))
               - float(jax_heads.soft_iou_loss(jnp.asarray(p), jnp.asarray(oh)))) <= 1e-6
    feats = [rng.standard_normal((2, 16 >> i, 16 >> i, 32)).astype(np.float32) for i in range(4)]
    seg = rng.integers(-1, 5, (2, 8, 8))                    # -1 and 4: outside the 4 classes
    jh = jax_heads.PanopticSegHead(num_classes=4, channels=32)
    jf = [jnp.asarray(f) for f in feats]
    v = random_tree(jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), jf)), seed=8)
    (want, _) = jh.apply(v, jf, jnp.asarray(seg))
    h = heads.PanopticSegHead(32, 4, 32)
    h.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                       panoptic_state_dict_from_flax(v["params"]).items()}, strict=True)
    got, out = h([torch.from_numpy(f) for f in feats], torch.from_numpy(seg))
    assert out["probs"].shape == (2, 16, 16, 4)
    assert abs(float(got["seg_loss"].detach()) - float(want["seg_loss"])) <= 1e-5


@pytest.mark.parametrize("dynamic", [False, True])
def test_constrain_modules_match_jax(rng, dynamic):
    """The confliction losses on fixed inputs, and their gradients in the
    seg probabilities, scores and masks (the boxes are constants here)."""
    probs = rng.uniform(0, 1, (2, 12, 12, 4)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    xy = rng.uniform(0, 150, (2, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 40, (2, 5, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 5, 4)).astype(np.float32)
    masks = rng.uniform(0, 1, (2, 5, 28, 28)).astype(np.float32)
    valid = np.asarray([[True] * 4 + [False], [True, False, True, True, True]])
    edges = ((1, 1), (2, 2), (3, 3))
    if dynamic:
        jmod, tmod = jax_heads.DynamicConstrainModule(edges, (1.0, 0.5, 1.0)), \
            heads.DynamicConstrainModule(edges, (1.0, 0.5, 1.0))
        jargs = (probs, boxes, scores, masks, valid)
    else:
        jmod, tmod = jax_heads.ConstrainModule(edges), heads.ConstrainModule(edges)
        jargs = (probs, boxes, scores, valid)
    diff = [0, 2, 3] if dynamic else [0, 2]

    def jf(*d):
        a = list(jargs)
        for i, v in zip(diff, d):
            a[i] = v
        return jmod.apply({}, *[jnp.asarray(v) for v in a], seg_stride=16.0)

    want, jg = jax.value_and_grad(jf, argnums=tuple(range(len(diff))))(
        *[jnp.asarray(jargs[i]) for i in diff])
    targs = [torch.from_numpy(np.asarray(a)) for a in jargs]
    for i in diff:
        targs[i].requires_grad_()
    got = tmod(*targs, seg_stride=16.0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    tg = torch.autograd.grad(got, [targs[i] for i in diff])
    for g, w in zip(tg, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_project_gt_to_rois_matches_jax(ref):
    jm = JaxHNet.from_cfg(CFG)
    bound = jm.bind(jax.tree.map(jnp.asarray, ref["variables"]))
    t = ref["t"]["det40x"]
    rois = np.asarray([[[0, 0, 32, 32], [16, 8, 64, 64], [0, 0, 0, 0]],
                       [[0, 0, 64, 64], [30, 30, 62, 50], [5, 5, 20, 20]]], np.float32)
    want = bound._project_gt_to_rois(jax.tree.map(jnp.asarray, t), jnp.asarray(rois), (64, 64),
                                      128)
    m = HNet(CFG, device="cpu")
    got = m._project_gt_to_rois(to_torch({"d": t})["d"], torch.from_numpy(rois), (64, 64), 128)
    assert set(got) == {"boxes", "valid", "labels", "masks"}
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert 0 < int(got["valid"].sum()) < got["valid"].numel()
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-6)
    for k in ("labels", "masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_feature_mosaic_matches_jax(rng):
    feats = [rng.standard_normal((4, 32 >> i, 32 >> i, 8)).astype(np.float32) for i in range(2)]
    rois = np.asarray([[0, 0, 128, 128], [10, 4, 100, 90], [30, 30, 60, 80], [0, 0, 256, 64]],
                      np.float32)
    want = jax_mosaic.mosaic_roi_feature_maps([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                              [4.0, 8.0], k=2, cell_size=16)
    got = mosaic_roi_feature_maps([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
                                  [4.0, 8.0], k=2, cell_size=16)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    boxes = [rng.uniform(0, 120, (n, 2)) for n in (3, 0, 5, 2)]
    boxes = [np.concatenate([b, b + rng.uniform(0.5, 60, b.shape)], -1) for b in boxes]
    labels = [np.arange(len(b)) + 1 for b in boxes]
    want = jax_mosaic.mosaic_targets(boxes, labels, rois, [4.0, 8.0], k=2, cell_size=16)
    got = mosaic_targets(boxes, labels, rois, [4.0, 8.0], k=2, cell_size=16)
    assert got["size"] == want["size"] == (128, 128)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    with pytest.raises(ValueError):
        mosaic_roi_feature_maps([torch.from_numpy(f) for f in feats], torch.zeros((3, 4)),
                                [4.0, 8.0])


def test_drop_path():
    """Identity at rate 0 and in eval mode; at rate 0.5 one Bernoulli draw
    a sample from the given generator, survivors scaled by 2."""
    x = torch.randn((16, 5, 5, 3))
    assert torch.equal(DropPath(0.0).train()(x), x)
    dp = DropPath(0.5)
    assert torch.equal(dp.eval()(x, torch.Generator().manual_seed(0)), x)
    out = dp.train()(x, torch.Generator().manual_seed(3))
    keep = torch.bernoulli(torch.full((16, 1, 1, 1), 0.5),
                           generator=torch.Generator().manual_seed(3)).bool()
    assert 0 < int(keep.sum()) < 16
    assert torch.equal(out, torch.where(keep, x * 2, torch.zeros(())))
    assert not torch.equal(out, dp(x, torch.Generator().manual_seed(4)))


def test_swin_train_mode_dropouts(rng):
    """The ramp of drop-path rates over the blocks; eval mode equals the
    JAX forward with the same rates; train mode draws from the generator."""
    kw = dict(embed_dim=16, depths=(2, 2), num_heads=(1, 2), window_size=4)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jm = JaxSwin(**kw, drop_path_rate=0.5, drop_rate=0.2, attn_drop_rate=0.1)
    v = random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                    seed=3)
    m = SwinTransformer(**kw, drop_path_rate=0.5, drop_rate=0.2, attn_drop_rate=0.1)
    m.load_state_dict({k: torch.from_numpy(np.array(a))
                       for k, a in swin_state_dict_from_flax(v["params"]).items()}, strict=True)
    rates = [blk.drop_path.rate for layer in m.layers for blk in layer.blocks]
    np.testing.assert_allclose(rates, [0.0, 0.5 / 3, 1.0 / 3, 0.5])
    assert m.layers[1].blocks[0].mlp.drop == 0.2 and m.layers[1].blocks[0].attn.attn_drop == 0.1
    want = jm.apply(v, jnp.asarray(x), train=False)
    got = m.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-4)
    m.train()
    a = m(torch.from_numpy(x), torch.Generator().manual_seed(1))
    b = m(torch.from_numpy(x), torch.Generator().manual_seed(1))
    c = m(torch.from_numpy(x), torch.Generator().manual_seed(2))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert float((a[-1] - c[-1]).abs().max()) > 1e-3
