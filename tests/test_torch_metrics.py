"""PyTorch port: ``hd_yolo_tpu_torch/models/metrics.py`` against the JAX
package's ``models/metrics.py``.  The port's file is a numpy copy, so every
public function is held to exact equality on seeded outputs and targets:
AP and PR curves, the one-to-one resolver, box and mask IoUs, the
confusion matrix, the streaming APMeter (boxes and masks, ignore labels, an
image without predictions) and the NuCLS summaries."""

import numpy as np
import pandas as pd
import pytest

from hd_yolo_tpu.models import metrics as jm
from hd_yolo_tpu_torch.models import metrics as tm


def assert_same(got, want, path="out"):
    """Exact equality through dicts, sequences, named tuples and frames."""
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path


def random_boxes(rng, n, extent=100.0):
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def random_image(rng, n_gt=12, n_pred=15, nc=4, masks=False, hw=(48, 48)):
    """One image's target and jittered, partly relabeled predictions, with
    −100 / −1 ignore labels among the targets."""
    gt = random_boxes(rng, n_gt)
    labels = rng.integers(1, nc + 1, n_gt)
    labels[rng.uniform(size=n_gt) < 0.15] = -100
    labels[rng.uniform(size=n_gt) < 0.05] = -1
    src = rng.integers(0, n_gt, n_pred)
    pred = gt[src] + rng.normal(0, 3, (n_pred, 4))
    plab = np.where(rng.uniform(size=n_pred) < 0.8, np.abs(labels[src]) % (nc + 1),
                    rng.integers(1, nc + 1, n_pred))
    plab[plab == 0] = 1
    out = {"boxes": pred, "scores": rng.uniform(0.05, 1, n_pred), "labels": plab}
    tgt = {"boxes": gt, "labels": labels}
    if masks:
        tgt["masks"] = rng.uniform(size=(n_gt,) + hw) > 0.6
        out["masks"] = np.where(rng.uniform(size=(n_pred,) + hw) < 0.8, tgt["masks"][src],
                                ~tgt["masks"][src])
    return out, tgt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_ap_and_ap_per_class_equal(seed):
    rng = np.random.default_rng(seed)
    recall = np.sort(rng.uniform(size=20))
    precision = rng.uniform(size=20)
    assert_same(tm.compute_ap(recall, precision), jm.compute_ap(recall, precision))
    n = 60
    tp = rng.uniform(size=(n, 10)) < np.linspace(0.8, 0.2, 10)
    conf = rng.uniform(size=n)
    pred_cls = rng.integers(0, 4, n)
    target_cls = rng.integers(0, 5, 40)
    assert_same(tm.ap_per_class(tp, conf, pred_cls, target_cls),
                jm.ap_per_class(tp, conf, pred_cls, target_cls))


@pytest.mark.parametrize("gt_winner", ["rank", "iou"])
def test_resolve_one_to_one_equal(gt_winner):
    rng = np.random.default_rng(3)
    k = 80
    args = (rng.integers(0, 25, k), rng.integers(0, 20, k), rng.uniform(0.5, 1, k), 25)
    assert_same(tm.resolve_one_to_one(*args, gt_winner=gt_winner),
                jm.resolve_one_to_one(*args, gt_winner=gt_winner))
    empty = (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    assert_same(tm.resolve_one_to_one(*empty, 3), jm.resolve_one_to_one(*empty, 3))


def test_ious_equal():
    rng = np.random.default_rng(4)
    a, b = random_boxes(rng, 17), random_boxes(rng, 9)
    assert_same(tm.box_iou_np(a, b), jm.box_iou_np(a, b))
    ma, mb = rng.uniform(size=(7, 20, 20)) > 0.5, rng.uniform(size=(5, 20, 20)) > 0.5
    assert_same(tm.get_mask_ious(ma, mb), jm.get_mask_ious(ma, mb))
    assert_same(tm.get_mask_ious(ma[:0], mb), jm.get_mask_ious(ma[:0], mb))


def test_confusion_matrix_equal():
    mats = []
    for mod in (tm, jm):
        r = np.random.default_rng(6)
        cm = mod.ConfusionMatrix(nc=4, conf=0.25, iou_thres=0.45)
        for _ in range(4):
            out, tgt = random_image(r)
            lab = np.abs(tgt["labels"]) % 4
            det = np.concatenate([out["boxes"], out["scores"][:, None],
                                  (out["labels"] % 4)[:, None]], 1)
            cm.process_batch(det, np.concatenate([lab[:, None], tgt["boxes"]], 1))
        mats.append((cm.matrix, cm.tp_fp()))
    assert mats[1][0].sum() > 0
    assert_same(mats[0], mats[1])


@pytest.mark.parametrize("iou_type", ["boxes", "masks"])
def test_apmeter_equal(iou_type):
    """Several images, ignore labels among the targets, one image with no
    predictions: the stored records, both ignore settings' curves and the
    counts equal."""
    meters = {}
    for name, mod in (("port", tm), ("jax", jm)):
        rng = np.random.default_rng(7)
        m = mod.APMeter({1: "tumor", 2: "stromal"})
        for i in range(5):
            out, tgt = random_image(rng, masks=iou_type == "masks")
            if i == 3:                                   # an image without predictions
                out = {k: v[:0] for k, v in out.items()}
            m.add(out, tgt, iou_type=iou_type)
        meters[name] = m
    p, j = meters["port"], meters["jax"]
    assert (p.n_pred, p.n_true) == (j.n_pred, j.n_true)
    assert_same([tuple(im) for im in p.images], [tuple(im) for im in j.images])
    for ignore in ((-100, -1), ()):
        assert_same(p.ap_per_class(ignore=ignore), j.ap_per_class(ignore=ignore))
    assert p.ap_per_class()["ap"].shape[0] >= 2


def test_evaluate_detection_and_summaries_equal():
    rng = np.random.default_rng(8)
    per_image = {"port": [], "jax": []}
    for i in range(4):
        out, tgt = random_image(rng, masks=True)
        if i == 2:
            out = {k: v[:0] for k, v in out.items()}
        for iou_type in ("boxes", "masks"):
            got = tm.evaluate_detection(tgt, out, [1, 2, 3, 4], iou_type=iou_type)
            want = jm.evaluate_detection(tgt, out, [1, 2, 3, 4], iou_type=iou_type)
            assert_same(got, want)
            per_image["port"].append(got[2])
            per_image["jax"].append(want[2])
    names = {1: "tumor", 2: "stromal"}
    with np.errstate(invalid="ignore", divide="ignore"):
        assert_same(tm.summarize_precision_recall(per_image["port"], names),
                    jm.summarize_precision_recall(per_image["jax"], names))


def test_accuracy_mcc_and_confusion_summaries_equal():
    rng = np.random.default_rng(9)
    y_true = rng.integers(-1, 7, 300)
    y_pred = np.where(rng.uniform(size=300) < 0.6, y_true, rng.integers(-1, 7, 300))
    ious = rng.uniform(size=300)
    w = rng.uniform(0.1, 2, 8)
    yt, yp = np.clip(y_true, 0, None), np.clip(y_pred, 0, None)
    assert_same(tm.weighted_accuracy(yp, yt, w), jm.weighted_accuracy(yp, yt, w))
    assert_same(tm.weighted_accuracy(yp, yt), jm.weighted_accuracy(yp, yt))
    assert_same(tm.weighted_accuracy([], []), jm.weighted_accuracy([], []))
    assert_same(tm.coverage_accuracy_miou(y_true, y_pred, ious),
                jm.coverage_accuracy_miou(y_true, y_pred, ious))
    assert_same(tm.matthews_corrcoef(y_true, y_pred), jm.matthews_corrcoef(y_true, y_pred))
    names = np.array(["tumor", "stromal", "sTILs", "other", "missing"])
    ct, cp = names[rng.integers(0, 5, 200)].tolist(), names[rng.integers(0, 5, 200)].tolist()
    assert_same(tm.summarize_mcc(ct, cp), jm.summarize_mcc(ct, cp))
    labels = ["tumor", "stromal", "sTILs", "other", "missing"]
    cm = rng.integers(1, 30, (5, 5)).astype(np.float64)
    assert_same(tm.summarize_confusion_matrix(cm, labels), jm.summarize_confusion_matrix(cm, labels))
    frame = pd.DataFrame(cm, index=labels, columns=labels)
    for keep in (["tumor", "stromal"], {"x": ["tumor"], "y": ["stromal", "sTILs"]}):
        assert_same(tm.reduce_confusion_matrix(frame, keep), jm.reduce_confusion_matrix(frame, keep))
