"""PyTorch port: the matcher, the segment max, CIoU and the losses
(``hd_yolo_tpu_torch/models/matcher.py``, ``ops/scatter.py``,
``ops/boxes.py``, ``models/losses.py``) against the JAX package on the same
seeded numpy inputs.

* matcher slots equal (indices, validity, targets to 1e-6);
* ``segment_max_with_argmax`` exactly: ties to the first index, empty
  segments at the dtype minimum with the sentinel ``n``, ids outside
  ``[0, num_segments)`` dropped;
* CIoU (and IoU / GIoU / DIoU) and its gradient within 1e-6;
* ``det_loss`` and ``seg_loss`` (bce and dice) within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import losses as jl
from hd_yolo_tpu.models import matcher as jmatch
from hd_yolo_tpu.ops import boxes as jboxes
from hd_yolo_tpu.ops.scatter import segment_max_with_argmax as jseg
from hd_yolo_tpu_torch.models import losses as tl
from hd_yolo_tpu_torch.models import matcher as tmatch
from hd_yolo_tpu_torch.ops import boxes as tboxes
from hd_yolo_tpu_torch.ops.scatter import segment_max_with_argmax as tseg

ANCHORS = [np.array([[1.25, 1.625], [2.0, 3.75], [4.125, 2.875]], np.float32),
           np.array([[1.875, 3.8125], [3.875, 2.8125], [3.6875, 7.4375]], np.float32)]
SHAPES = [(16, 16), (8, 8)]


def targets(seed, B=3, T=6):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.02, 0.98, (B, T, 2))
    wh = rng.uniform(0.01, 0.3, (B, T, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    valid = rng.uniform(size=(B, T)) < 0.7
    return boxes, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_matcher_slots_equal(seed):
    boxes, valid = targets(seed)
    jm = jmatch.match_targets(jnp.asarray(boxes), jnp.asarray(valid), [jnp.asarray(a) for a in ANCHORS],
                              SHAPES, 4.0)
    tm = tmatch.match_targets(torch.from_numpy(boxes), torch.from_numpy(valid),
                              [torch.from_numpy(a) for a in ANCHORS], SHAPES, 4.0)
    for a, b in zip(jm, tm):
        for f in ("b", "a", "gj", "gi", "obj_idx", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f).numpy(), err_msg=f)
        for f in ("tbox", "anchor_wh"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)), getattr(b, f).numpy(), rtol=0,
                                       atol=1e-6, err_msg=f)
        assert int(b.valid.sum()) > 0


@pytest.mark.parametrize("case", ["ties", "empty", "dropped", "random"])
def test_segment_max_with_argmax(case):
    rng = np.random.default_rng(7)
    if case == "ties":
        values = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 0.5], np.float32)
        ids = np.array([0, 0, 0, 1, 0, 1])
    elif case == "empty":
        values = np.array([0.2, -0.1, 0.7], np.float32)
        ids = np.array([0, 3, 0])
    elif case == "dropped":
        values = np.array([5.0, 1.0, 9.0, 2.0, 4.0], np.float32)
        ids = np.array([0, -1, 4, 1, 7])
    else:
        values = np.round(rng.uniform(-1, 1, 200), 1).astype(np.float32)   # many ties
        ids = rng.integers(-2, 12, 200)
    n_seg = 5 if case != "random" else 10
    jm, ja = jseg(jnp.asarray(values), jnp.asarray(ids, jnp.int32), n_seg)
    tm, ta = tseg(torch.from_numpy(values), torch.from_numpy(ids), n_seg)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if case == "ties":
        assert ta[0] == 1
    if case == "empty":
        assert ta[1] == len(values) and tm[1] == -np.inf


@pytest.mark.parametrize("mode", ["IoU", "GIoU", "DIoU", "CIoU"])
def test_bbox_iou_and_gradient(mode):
    rng = np.random.default_rng(2)
    b1 = np.concatenate([rng.uniform(0, 5, (64, 2)), rng.uniform(0.1, 3, (64, 2))], 1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(0, 5, (64, 2)), rng.uniform(0.1, 3, (64, 2))], 1).astype(np.float32)
    kw = {m: m == mode for m in ("GIoU", "DIoU", "CIoU")}
    f = lambda a: jnp.sum(jboxes.bbox_iou(a, jnp.asarray(b2), xywh=True, **kw))
    want, wgrad = jax.value_and_grad(f)(jnp.asarray(b1))
    t1 = torch.from_numpy(b1).requires_grad_()
    got = tboxes.bbox_iou(t1, torch.from_numpy(b2), xywh=True, **kw).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(wgrad), rtol=0, atol=1e-6)
    x1 = np.concatenate([b1[:, :2], b1[:, :2] + b1[:, 2:]], 1)
    x2 = np.concatenate([b2[:, :2], b2[:, :2] + b2[:, 2:]], 1)
    np.testing.assert_allclose(tboxes.paired_box_iou(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
                               np.asarray(jboxes.paired_box_iou(jnp.asarray(x1), jnp.asarray(x2))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tboxes.wh_iou(torch.from_numpy(b1[:, 2:]), torch.from_numpy(b2[:, 2:])).numpy(),
                               np.asarray(jboxes.wh_iou(jnp.asarray(b1[:, 2:]), jnp.asarray(b2[:, 2:]))),
                               rtol=1e-6)
    n = np.asarray(jboxes.xyxy2xywhn(jnp.asarray(x1), 7.0, 5.0, clip=True))
    np.testing.assert_allclose(tboxes.xyxy2xywhn(torch.from_numpy(x1), 7.0, 5.0, clip=True).numpy(), n,
                               rtol=1e-6)
    np.testing.assert_allclose(tboxes.xywhn2xyxy(torch.from_numpy(n), 7.0, 5.0, 1.0, 2.0).numpy(),
                               np.asarray(jboxes.xywhn2xyxy(jnp.asarray(n), 7.0, 5.0, 1.0, 2.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("fl_gamma,smooth", [(0.0, 0.0), (1.5, 0.1)])
def test_det_loss(fl_gamma, smooth):
    B, T, nc, A = 3, 6, 4, 3
    boxes, valid = targets(4, B, T)
    rng = np.random.default_rng(5)
    dets = [rng.standard_normal((B, ny, nx, A, nc + 5)).astype(np.float32) for ny, nx in SHAPES]
    labels = rng.integers(0, nc + 1, (B, T))
    onehot = np.eye(nc + 1, dtype=np.float32)[labels]
    active = np.array([True, True, False])
    hyp = jl.get_loss_hyp({"fl_gamma": fl_gamma, "label_smoothing": smooth,
                           "cls_cw": [1.0, 2.0, 0.5, 1.0]})
    jmt = jmatch.match_targets(jnp.asarray(boxes), jnp.asarray(valid), [jnp.asarray(a) for a in ANCHORS],
                               SHAPES, 4.0)
    jt, jitems, jious = jl.det_loss([jnp.asarray(d) for d in dets], jmt, jnp.asarray(onehot),
                                    jnp.asarray(active), hyp, nc)
    tmt = tmatch.match_targets(torch.from_numpy(boxes), torch.from_numpy(valid),
                               [torch.from_numpy(a) for a in ANCHORS], SHAPES, 4.0)
    tt, titems, tious = tl.det_loss([torch.from_numpy(d) for d in dets], tmt, torch.from_numpy(onehot),
                                    torch.from_numpy(active), tl.get_loss_hyp(dict(hyp)), nc)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(titems[k]), float(jitems[k]), rtol=1e-5, err_msg=k)
    for a, b in zip(jious, tious):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


def test_det_loss_gradient_is_nan_where_a_predicted_height_underflows():
    """Both packages alike: with one level's h logits at -60 the decoded
    predicted height ``(2·sigmoid)² · anchor`` underflows to 0 in f32.  The
    loss stays finite and equal, but the logits' gradient at that level
    holds NaN (CIoU's ``arctan(w1 / h1)``: arctan's derivative 0 at inf
    times the quotient's ``-w1 / h1²``), and the other level's stays finite.
    The apply-if-finite rule then skips the step (ROADMAP C.2)."""
    B, T, nc, A = 3, 6, 4, 3
    boxes, valid = targets(4, B, T)
    rng = np.random.default_rng(5)
    dets = [rng.standard_normal((B, ny, nx, A, nc + 5)).astype(np.float32) for ny, nx in SHAPES]
    dets[1][..., 3] = -60.0
    onehot = np.eye(nc + 1, dtype=np.float32)[rng.integers(0, nc + 1, (B, T))]
    active = np.array([True, True, True])
    hyp = jl.get_loss_hyp({})
    jmt = jmatch.match_targets(jnp.asarray(boxes), jnp.asarray(valid), [jnp.asarray(a) for a in ANCHORS],
                               SHAPES, 4.0)
    jloss, jgrad = jax.value_and_grad(lambda d: jl.det_loss(d, jmt, jnp.asarray(onehot),
                                                            jnp.asarray(active), hyp, nc)[0])(
        [jnp.asarray(d) for d in dets])
    tmt = tmatch.match_targets(torch.from_numpy(boxes), torch.from_numpy(valid),
                               [torch.from_numpy(a) for a in ANCHORS], SHAPES, 4.0)
    td = [torch.from_numpy(d).requires_grad_() for d in dets]
    tloss = tl.det_loss(td, tmt, torch.from_numpy(onehot), torch.from_numpy(active),
                        tl.get_loss_hyp(dict(hyp)), nc)[0]
    tgrad = torch.autograd.grad(tloss, td)
    assert np.isfinite(float(jloss)) and np.isfinite(float(tloss.detach()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for g in (np.asarray(jgrad[1]), tgrad[1].numpy()):
        assert np.isnan(g).any()
    for g in (np.asarray(jgrad[0]), tgrad[0].numpy()):
        assert np.isfinite(g).all()


@pytest.mark.parametrize("mask_type", ["bce", "dice"])
def test_seg_loss(mask_type):
    rng = np.random.default_rng(6)
    R, S, C = 10, 28, 3
    logits = rng.standard_normal((R, S, S, C)).astype(np.float32)
    masks = (rng.uniform(size=(R, S, S)) > 0.6).astype(np.float32)
    masks[3] = 0.0                                        # empty target: skipped
    labels = rng.integers(-1, C, R)
    rv = rng.uniform(size=R) < 0.8
    hyp = jl.get_loss_hyp({"type": mask_type, "mask": 0.7})
    want = jl.seg_loss(jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(rv), hyp)
    got = tl.seg_loss(torch.from_numpy(logits), torch.from_numpy(masks), torch.from_numpy(labels),
                      torch.from_numpy(rv), tl.get_loss_hyp({"type": mask_type, "mask": 0.7}))
    assert hyp["mask_type"] == mask_type
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_focal_blur_and_autobalance():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(50).astype(np.float32)
    t = rng.uniform(size=50).astype(np.float32)
    for jf, tf in ((jl.focal_factor, tl.focal_factor), (jl.q_focal_factor, tl.q_focal_factor)):
        np.testing.assert_allclose(tf(torch.from_numpy(x), torch.from_numpy(t), 1.5).numpy(),
                                   np.asarray(jf(jnp.asarray(x), jnp.asarray(t), 1.5)), rtol=1e-5)
    np.testing.assert_allclose(tl.bce_blur_with_logits(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
                               np.asarray(jl.bce_blur_with_logits(jnp.asarray(x), jnp.asarray(t))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.autobalance_update([4.0, 1.0, 0.4], [0.5, 0.2, 0.1]).numpy(),
                               np.asarray(jl.autobalance_update([4.0, 1.0, 0.4], [0.5, 0.2, 0.1])),
                               rtol=1e-6)
