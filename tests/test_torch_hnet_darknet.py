"""PyTorch port, the rest of the hnet stack as a whole: the darknet backbone,
the Mask R-CNN keypoint branch and the FCOS header in one ``HNet``, against
the JAX package's on the same numpy weights and batch (``random_variables``
carried by ``hnet_state_dict_from_flax``), f32 on the CPU.

The model: darknet at width 0.25, depth 0.33 (``tests/test_hnet.py``'s),
FPN 32, a Mask R-CNN header with masks and 3 keypoints, an FCOS header, a
panoptic header and two constrains (box-mean on the Mask R-CNN header,
mask-weighted on FCOS, whose detections carry no masks) on 2 x 64 px.

* ``DarkNetBackbone`` alone: eval outputs atol 1e-4 (its first layer the
  stem's plain version), training outputs atol 5e-4 on the batch's
  statistics and the running statistics after it atol 1e-5.  In training
  mode the deep levels normalise over few values (8 at /32): against both
  packages run in f64 on this input, JAX's f32 outputs are 6.8e-5 / 9.8e-5
  / 1.4e-4 off by level and the port's 7.6e-6 / 1.2e-5 / 2.2e-5, so the
  two f32 results differ by JAX's rounding, up to 1.3e-4;
* the eval forward: seg probabilities atol 1e-4; both detection headers'
  validity and labels exact, boxes and keypoint x, y atol 1e-3 px, scores,
  keypoint scores and masks atol 1e-4;
* ``_project_gt_to_rois`` with keypoints: visibility exact, coordinates
  atol 1e-6;
* the training forward (BatchNorm on the batch's statistics): every loss
  item rtol 1e-4 (+ atol 1e-6) and the BatchNorm statistics JAX's mutated
  ones atol 1e-5;
* every parameter's gradient, with each ROI-align's boxes under
  ``stop_gradient`` on the JAX side (ROADMAP C.2), within a share of the
  larger of its max|g| and 1e-3 of the model's largest: 1e-3, as
  ``tests/test_torch_hnet_train.py``, but where measured otherwise.  At
  this random init the gradients are ill-conditioned: a 1e-7 relative
  change of the input moves the port's own trunk gradients by up to 6e-4
  of their max, FCOS's and the FPN's by 2e-4, and on the backbone alone
  against f64 JAX's f32 gradients are 1.4e-4 off and the port's 2.4e-5;
  measured here, the backbone, FPN and FCOS tensors differ by up to
  1.7e-3: held at 3e-3.  Pre-activations within rounding of a ReLU's kink
  take opposite sides in the two packages: the box head's fc7 differs in
  one output row (1.2e-2), the keypoint head's 8-layer stack in whole
  output channels (4.1e-2 at ``kp4``), the mask head's by 4.1e-3: held at
  2e-2 (box and mask heads, as the mask head in
  ``tests/test_torch_hnet_train.py``) and 5e-2 (keypoints;
  ``tests/test_torch_keypoints.py`` holds that head's gradients in f64,
  within 1e-6);
* the same gradients in f64 on both sides (JAX under ``jax.enable_x64``,
  the port's model in ``.double()`` with an f64 compute dtype), where the
  ReLU kinks no longer split the packages: every tensor within 1e-6 of that
  scale.  Measured per group (largest share): backbone 5.6e-7, FPN 6.3e-7,
  RPN 4.0e-7, box head 5.6e-8, box predictor 5.0e-8, mask head 9.3e-8,
  keypoint head 1.2e-7, keypoint predictor 7.2e-7, FCOS 2.5e-7, the
  panoptic connector 9.2e-7 and its logits 2.9e-7 — the same on 1 and 3
  threads.  What remains is the losses' f32 arithmetic, which is not the
  same in the two packages under x64 (JAX promotes some loss terms to f64
  through its x64 default dtype, the port keeps them f32): no head differs
  beyond it, so the f32 test's 2e-2 / 5e-2 shares are rounding at the kinks,
  not a port fault.  The model is this file's but for ``num_detections`` 1
  (the mask and keypoint heads on one ROI an image): XLA's f64 convolutions
  on the CPU run near 1 GFLOP/s and the keypoint head's 8 x 512 stack costs
  ~22 GFLOP an ROI forward and back;
* one ``make_train_step`` update runs and moves the running statistics.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet import HNet as JaxHNet
from hd_yolo_tpu.hnet.hnet import DarkNetBackbone as JaxDarkNet
from hd_yolo_tpu_torch.engines import optim as toptim
from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
from hd_yolo_tpu_torch.hnet import DarkNetBackbone, HNet
from hd_yolo_tpu_torch.utils.convert import darknet_state_dict_from_flax, hnet_state_dict_from_flax
from test_torch_hnet_train import boxes_stopped, to_torch
from torch_port_common import random_variables

CFG = {
    "backbone": {"type": "darknet", "width": 0.25, "depth": 0.33},
    "fpn": {"out_channels": 32},
    "headers": {
        "det40x": {"type": "maskrcnn", "num_classes": 2, "pre_nms_topk": 64,
                   "num_proposals": 16, "num_detections": 3, "num_keypoints": 3,
                   "anchor_sizes": [16.0, 32.0, 64.0], "roi_size": 64},
        "fcos40x": {"type": "fcos", "num_classes": 2, "pre_nms_topk": 64, "num_detections": 8,
                    "roi_size": 64, "size_base": 16.0},
        "seg10x": {"type": "panoptic", "num_classes": 3, "channels": 32},
    },
    "constrains": {
        "c0": {"seg_task": "seg10x", "det_task": "det40x", "edges": [[1, 1], [2, 2]]},
        "c1": {"seg_task": "seg10x", "det_task": "fcos40x", "edges": [[1, 1], [2, 2]],
               "weighting": "mask", "values": [1.0, 0.5]},
    },
}
X_SHAPE = (2, 64, 64, 3)
B, T = 2, 4


def make_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    xy = rng.uniform(0.05, 0.5, (B, T, 2)).astype(np.float32)
    wh = rng.uniform(0.2, 0.45, (B, T, 2)).astype(np.float32)
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1)
    valid = np.ones((B, T), bool)
    valid[1, -1] = False
    labels = rng.integers(1, 3, (B, T))
    # keypoints in their boxes, one hidden and one outside each box
    kp = np.zeros((B, T, 3, 3), np.float32)
    kp[..., :2] = boxes[:, :, None, :2] + rng.uniform(0.1, 0.9, (B, T, 3, 2)) * (
        boxes[:, :, None, 2:] - boxes[:, :, None, :2])
    kp[..., :2, 2] = 1.0
    kp[:, :, 1, :2] = np.minimum(boxes[:, :, 2:] + 0.05, 1.0)
    rois = np.asarray([[[0, 0, 40, 40], [20, 16, 64, 64]], [[0, 0, 64, 64], [8, 30, 48, 62]]],
                      np.float32)
    det = {"boxes": boxes, "labels": labels, "valid": valid, "keypoints": kp,
           "masks": (rng.uniform(0, 1, (B, T, 28, 28)) > 0.5).astype(np.float32),
           "rois": rois, "roi_valid": np.asarray([[True, True], [True, False]])}
    return x, {"det40x": det,
               "fcos40x": {k: det[k] for k in ("boxes", "labels", "valid", "rois", "roi_valid")},
               "seg10x": {"seg_map": rng.integers(0, 3, (B, 8, 8))}}


def port_model(variables, train=False):
    m = HNet(CFG, device="cpu")
    m.load_state_dict(hnet_state_dict_from_flax(variables, CFG), strict=True)
    return m.train(train)


@pytest.fixture(scope="module")
def ref():
    """JAX's eval forward, and its training losses, gradients (ROI-align
    boxes stopped) and mutated BatchNorm statistics, each compiled once."""
    jm = JaxHNet.from_cfg(CFG)
    variables = random_variables(jm, X_SHAPE, seed=0)
    x, t = make_batch()
    jx, jt = jnp.asarray(x), jax.tree.map(jnp.asarray, t)
    _, out = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, jx)

    def loss_fn(params):
        (losses, _), upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jx, jt, train=True, mutable=["batch_stats"])
        return jm.total_loss(losses), (losses, upd["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        boxes_stopped(mp)
        (total, (losses, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    return {"variables": variables, "x": x, "t": t, "out": jax.tree.map(np.asarray, out),
            "total": float(total), "losses": jax.tree.map(float, losses),
            "grads": jax.tree.map(np.asarray, grads), "stats": jax.tree.map(np.asarray, stats)}


@pytest.fixture(scope="module")
def port_train(ref):
    m = port_model(ref["variables"], train=True)
    losses, _ = m(torch.from_numpy(ref["x"]), to_torch(ref["t"]))
    total = m.total_loss(losses)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return m, losses, total, dict(zip(names, grads))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_darknet_backbone_matches_jax(train):
    jd = JaxDarkNet(width=0.25, depth=0.33)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    v = random_variables(jd, x.shape, seed=4)
    m = DarkNetBackbone(0.25, 0.33)
    m.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in darknet_state_dict_from_flax(
        v["params"], v["batch_stats"]).items()}, strict=True)
    assert m.channels == (64, 128, 256)
    if train:
        want, upd = jd.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jd.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = m.train(train)(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(2, 8, 6, 64), (2, 4, 3, 128), (2, 2, 2, 256)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-4 if train else 1e-4)
    if train:
        new = darknet_state_dict_from_flax(v["params"], jax.tree.map(np.asarray,
                                                                     upd["batch_stats"]))
        sd = m.state_dict()
        moved = 0
        for k, w in new.items():
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), w, rtol=0, atol=1e-5, err_msg=k)
                moved += int(np.abs(w - darknet_state_dict_from_flax(
                    v["params"], v["batch_stats"])[k]).max() > 1e-4)
        assert moved > 10


def test_hnet_forward_matches_jax(ref):
    m = port_model(ref["variables"])
    losses, got = m(torch.from_numpy(ref["x"]))
    want = ref["out"]
    assert losses == {"det40x": {}, "fcos40x": {}, "seg10x": {}}
    np.testing.assert_allclose(got["seg10x"]["probs"].numpy(), want["seg10x"]["probs"], rtol=0,
                               atol=1e-4)
    for task in ("det40x", "fcos40x"):
        g = {k: v.numpy() for k, v in got[task].items()}
        w = want[task]
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert w["valid"].sum() >= 4
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-4)
    d, w = got["det40x"], want["det40x"]
    assert d["keypoints"].shape == (2, 3, 3, 3)
    np.testing.assert_allclose(d["keypoints"][..., :2].numpy(), w["keypoints"][..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(d["keypoints"][..., 2].numpy(), w["keypoints"][..., 2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(d["masks"].numpy(), w["masks"], rtol=0, atol=1e-4)


def test_project_gt_to_rois_with_keypoints_matches_jax(ref):
    jm = JaxHNet.from_cfg(CFG)
    bound = jm.bind(jax.tree.map(jnp.asarray, ref["variables"]))
    t = {k: v for k, v in ref["t"]["det40x"].items() if k not in ("rois", "roi_valid")}
    rois = np.asarray([[[0, 0, 32, 32], [16, 8, 64, 64], [0, 0, 0, 0]],
                       [[0, 0, 64, 64], [30, 30, 62, 50], [5, 5, 20, 20]]], np.float32)
    want = bound._project_gt_to_rois(jax.tree.map(jnp.asarray, t), jnp.asarray(rois), (64, 64),
                                      64)
    got = HNet(CFG, device="cpu")._project_gt_to_rois(to_torch({"d": t})["d"],
                                                      torch.from_numpy(rois), (64, 64), 64)
    assert set(got) == {"boxes", "valid", "labels", "masks", "keypoints"}
    kp, wkp = got["keypoints"].numpy(), np.asarray(want["keypoints"])
    assert kp.shape == (6, T, 3, 3)
    np.testing.assert_array_equal(kp[..., 2], wkp[..., 2])
    assert 0 < kp[..., 2].sum() < (t["keypoints"][..., 2] > 0).sum() * 3
    np.testing.assert_allclose(kp[..., :2], wkp[..., :2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))


def test_hnet_train_losses_and_statistics_match_jax(ref, port_train):
    m, losses, total, _ = port_train
    want = ref["losses"]
    assert set(losses) == set(want) == {"det40x", "fcos40x", "seg10x", "constrains"}
    assert set(want["det40x"]) == {"rpn_obj_loss", "rpn_reg_loss", "roi_cls_loss",
                                   "roi_reg_loss", "mask_loss", "keypoint_loss"}
    assert set(want["constrains"]) == {"c0", "c1"}
    for task, d in want.items():
        assert set(losses[task]) == set(d), task
        for k, w in d.items():
            g = float(losses[task][k].detach())
            assert np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w) + 1e-6, (task, k, g, w)
    assert want["det40x"]["keypoint_loss"] > 0 and want["fcos40x"]["fcos_reg_loss"] > 0
    assert abs(float(total.detach()) - ref["total"]) <= 1e-4 * abs(ref["total"])
    sd = m.state_dict()
    stats = darknet_state_dict_from_flax(ref["variables"]["params"]["backbone"],
                                         ref["stats"]["backbone"])
    for k, w in stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[f"backbone.{k}"].numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=k)


def grad_share(name: str) -> float:
    """The share of a tensor's gradient scale it is held to (docstring)."""
    if ".keypoint_" in name:
        return 5e-2
    if ".mask_head." in name or ".box_head." in name:
        return 2e-2
    if name.startswith(("backbone.", "fpn.", "headers.fcos40x.")):
        return 3e-3
    return 1e-3


def test_hnet_gradients_match_jax_with_roi_boxes_stopped(ref, port_train):
    got = port_train[3]
    want = hnet_state_dict_from_flax({"params": ref["grads"],
                                      "batch_stats": ref["variables"]["batch_stats"]}, CFG)
    want = {k: w for k, w in want.items() if k in got}
    assert set(got) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    nonzero = 0
    for name, w in want.items():
        g = got[name]
        assert g is not None, name
        w = w.numpy()
        rel = grad_share(name)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=rel * max(np.abs(w).max(),
                                                                      1e-3 * top), err_msg=name)
        nonzero += int(np.abs(w).max() > 1e-6 * top)
    assert nonzero > 0.8 * len(want)
    for part in ("backbone.layers.0.", ".keypoint_head.", ".keypoint_predictor.",
                 "fcos40x.cls_tower.", "fcos40x.scales."):
        assert any(part in n and float(g.abs().max()) > 0 for n, g in got.items()), part


F64_CFG = copy.deepcopy(CFG)
F64_CFG["headers"]["det40x"]["num_detections"] = 1


def test_hnet_gradients_match_jax_in_f64():
    variables = random_variables(JaxHNet.from_cfg(F64_CFG), X_SHAPE, seed=0)
    x, t = make_batch()
    with jax.enable_x64(True):
        jm = JaxHNet.from_cfg(F64_CFG, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        jx, jt = jnp.asarray(x.astype(np.float64)), jax.tree.map(jnp.asarray, t)

        def loss_fn(params):
            (losses, _), _ = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                      jx, jt, train=True, mutable=["batch_stats"])
            return jm.total_loss(losses)

        with pytest.MonkeyPatch.context() as mp:
            boxes_stopped(mp)
            grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(v64["params"]))
    m = HNet(F64_CFG, dtype=torch.float64, device="cpu")
    m.load_state_dict(hnet_state_dict_from_flax(variables, F64_CFG), strict=True)
    m = m.double().train()
    losses, _ = m(torch.from_numpy(x.astype(np.float64)), to_torch(t))
    names, params = zip(*m.named_parameters())
    assert all(p.dtype == torch.float64 for p in params)
    got = dict(zip(names, torch.autograd.grad(m.total_loss(losses), params, allow_unused=True)))
    want = hnet_state_dict_from_flax({"params": grads, "batch_stats": variables["batch_stats"]},
                                     F64_CFG)
    want = {k: np.asarray(w, np.float64) for k, w in want.items() if k in got}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        assert got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-3 * top), err_msg=name)
    for part in (".box_head.", ".mask_head.", ".keypoint_head.", ".keypoint_predictor."):
        assert any(part in n and float(g.abs().max()) > 0 for n, g in got.items()), part


def test_train_step_updates_the_darknet_statistics(ref):
    m = port_model(copy.deepcopy(ref["variables"]))
    state = TrainState.create(m, toptim.build_optimizer(
        m, {"lr0": 0.005, "warmup_epochs": 3.0, "clip_grad_norm": 10.0}, 10, 10))
    before = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
    state, met = make_train_step()(state, {"image": torch.from_numpy(ref["x"]),
                                           "targets": to_torch(ref["t"])})
    assert m.training and int(state.step) == 1
    assert np.isfinite(float(met["loss"])) and "det40x/keypoint_loss" in met
    assert "fcos40x/fcos_ctr_loss" in met and "constrains/c1" in met
    moved = sum(int(not torch.equal(v, m.state_dict()[k])) for k, v in before.items())
    assert moved == len(before)
