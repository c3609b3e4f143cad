"""PyTorch port, the Mask R-CNN keypoint branch (``hnet/mask_rcnn.py``): the
KeypointRCNN head, the heatmap loss and keypoint inference against the JAX
package's ``MaskRCNN(num_keypoints=3)`` on the same numpy weights (carried by
``maskrcnn_state_dict_from_flax``) and inputs, f32 on the CPU (the shapes of
``tests/test_hnet.py::test_maskrcnn_keypoint_branch``).

Tolerances: heatmap logits atol 1e-4; their gradients in the head's
parameters and its input, both packages in f64 (the heatmaps cast to f32
for the resize on both sides, as in f32), within 1e-6 of each tensor's
max|g| (in f32 the 8-layer ReLU stack's pre-activations that lie within
rounding of 0 take opposite sides of the kink in the two packages, which
moves whole output channels of a layer's gradient by up to ~4%: in f64
none does); every loss rtol 1e-5 + atol 1e-6
(exactly 0 for invisible-only keypoints); keypoint x, y atol 1e-3 px,
scores atol 1e-5, detections' validity and labels exact.  The loss case has
more foreground ROIs than the branch takes (``num_detections``): their
scores all tie, so the lowest indices win, as ``lax.top_k`` picks them."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet.mask_rcnn import MaskRCNN as JaxMaskRCNN
from hd_yolo_tpu_torch.hnet import mask_rcnn
from hd_yolo_tpu_torch.hnet.mask_rcnn import MaskRCNN
from hd_yolo_tpu_torch.utils.convert import maskrcnn_state_dict_from_flax
from torch_port_common import random_tree

KW = dict(num_classes=2, strides=(8.0, 16.0), anchor_sizes=(16.0, 32.0), pre_nms_topk=64,
          num_proposals=16, num_detections=4, with_masks=False, num_keypoints=3)
C, SIZE = 8, (128, 128)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    feats = [rng.uniform(0, 1, (2, 16 >> i, 16 >> i, C)).astype(np.float32) for i in range(2)]
    jm = JaxMaskRCNN(**KW)
    jf = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jf, SIZE))
    v = random_tree(shapes, seed=1)
    m = MaskRCNN(C, **KW)
    m.load_state_dict({k: _t(x) for k, x in maskrcnn_state_dict_from_flax(v["params"]).items()},
                      strict=True)
    return jm, v, m.eval(), feats


def targets(kp_vis=1.0):
    """Image 0: six jittered copies of a large GT box (the GT boxes join the
    ROIs, so six foreground ROIs for four slots), each with its own
    keypoints, one of them hidden; image 1: two boxes and four padded rows,
    one keypoint outside its box."""
    rng = np.random.default_rng(3)
    T = 6
    boxes = np.zeros((2, T, 4), np.float32)
    boxes[0] = np.asarray([10, 10, 120, 120]) + rng.uniform(-4, 4, (T, 4))
    boxes[1, :2] = [[20, 30, 70, 90], [60, 10, 110, 50]]
    boxes /= 128.0
    kps = np.zeros((2, T, 3, 3), np.float32)
    kps[0, :, :, :2] = rng.uniform(0.2, 0.8, (T, 3, 2))
    kps[0, :, :2, 2] = 1.0
    kps[1, :2] = [[[0.3, 0.4, 1], [0.9, 0.9, 1], [0.2, 0.6, 1]],
                  [[0.6, 0.2, 1], [0.7, 0.3, 1], [0.8, 0.35, 0]]]
    kps[..., 2] *= kp_vis
    valid = np.zeros((2, T), bool)
    valid[0], valid[1, :2] = True, True
    labels = np.where(valid, rng.integers(1, 3, (2, T)), 0).astype(np.int32)
    return {"boxes": boxes, "labels": labels, "valid": valid, "keypoints": kps}


def test_keypoint_head_matches_jax(pair):
    jm, v, m, _ = pair
    rois = np.random.default_rng(2).standard_normal((5, 14, 14, C)).astype(np.float32)
    want = jm.apply(v, jnp.asarray(rois), method=lambda mod, r: mod.keypoint_head(r))
    with torch.no_grad():
        got = m.roi_heads.heatmaps(_t(rois))
    assert tuple(got.shape) == want.shape == (5, 56, 56, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_keypoint_head_gradients_match_jax_in_f64(pair):
    _, v, m, _ = pair
    rng = np.random.default_rng(4)
    rois = rng.standard_normal((2, 14, 14, C))
    cot = rng.standard_normal((2, 56, 56, 3))
    params = v["params"]["keypoint_head"]
    with jax.enable_x64(True):
        jh = JaxMaskRCNN(**KW, dtype=jnp.float64)

        def f(p, r):
            hm = jh.apply({"params": {"keypoint_head": p}}, r,
                          method=lambda mod, x: mod.keypoint_head(x))
            return jnp.sum(hm * jnp.asarray(cot, hm.dtype))

        jp, jr = jax.grad(f, argnums=(0, 1))(
            jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params),
            jnp.asarray(rois))
        jp, jr = jax.tree.map(np.asarray, jp), np.asarray(jr)
    heads = copy.deepcopy(m.roi_heads).double()
    r = torch.from_numpy(rois).requires_grad_()
    (heads.heatmaps(r) * torch.from_numpy(cot).float()).sum().backward()
    want = maskrcnn_state_dict_from_flax({**v["params"], "keypoint_head": jp})
    checked = 0
    for name, p in heads.named_parameters():
        if name.startswith("keypoint_"):
            w = want[f"roi_heads.{name}"]
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(), err_msg=name)
            checked += 1
    assert checked == 18
    np.testing.assert_allclose(r.grad.numpy(), jr, rtol=0, atol=1e-6 * np.abs(jr).max())


@pytest.mark.parametrize("kp_vis", [1.0, 0.0], ids=["visible", "invisible_only"])
def test_keypoint_loss_matches_jax(pair, kp_vis):
    jm, v, m, feats = pair
    t = targets(kp_vis)
    want = jm.apply(v, [jnp.asarray(f) for f in feats], SIZE,
                    {k: jnp.asarray(x) for k, x in t.items()}, method=JaxMaskRCNN.compute_losses)
    fg_counts = []
    orig = mask_rcnn.assign_targets

    def spy(*a, **k):
        labels, match = orig(*a, **k)
        if "anchor_valid" in k:
            fg_counts.append(((labels == 1) & k["anchor_valid"]).sum(1))
        return labels, match

    mask_rcnn.assign_targets = spy
    try:
        with torch.no_grad():
            got = m.compute_losses([_t(f) for f in feats], SIZE, {k: _t(x) for k, x in t.items()})
    finally:
        mask_rcnn.assign_targets = orig
    assert int(fg_counts[0][0]) > KW["num_detections"]        # the tie order decides
    assert set(got) == set(want) and "keypoint_loss" in got
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        assert abs(g - w) <= 1e-5 * abs(w) + 1e-6, (k, g, w)
    if kp_vis == 0.0:
        assert float(got["keypoint_loss"]) == 0.0 == float(want["keypoint_loss"])
    else:
        assert float(got["keypoint_loss"]) > 0


def test_keypoint_loss_gradient_reaches_the_head(pair):
    _, _, m, feats = pair
    t = {k: _t(x) for k, x in targets().items()}
    loss = m.compute_losses([_t(f) for f in feats], SIZE, t)["keypoint_loss"]
    params = list(m.roi_heads.keypoint_head.parameters()) + \
        list(m.roi_heads.keypoint_predictor.parameters())
    grads = torch.autograd.grad(loss, params)
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_keypoint_inference_matches_jax(pair):
    jm, v, m, feats = pair
    want = jax.tree.map(np.asarray, jm.apply(v, [jnp.asarray(f) for f in feats], SIZE,
                                             method=JaxMaskRCNN.infer))
    with torch.no_grad():
        got = {k: x.numpy() for k, x in m.infer([_t(f) for f in feats], SIZE).items()}
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "keypoints"}
    assert got["keypoints"].shape == want["keypoints"].shape == (2, 4, 3, 3)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    vd = want["valid"]
    assert vd.sum() >= 4
    np.testing.assert_allclose(got["keypoints"][..., :2], want["keypoints"][..., :2], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["keypoints"][..., 2], want["keypoints"][..., 2], rtol=0,
                               atol=1e-5)
    assert (got["keypoints"][~vd] == 0).all()
    k, b = got["keypoints"][vd], got["boxes"][vd]
    assert ((k[..., 0] >= b[:, None, 0]) & (k[..., 0] <= b[:, None, 2])
            & (k[..., 1] >= b[:, None, 1]) & (k[..., 1] <= b[:, None, 3])).all()
    assert ((k[..., 2] > 0) & (k[..., 2] <= 1)).all()
