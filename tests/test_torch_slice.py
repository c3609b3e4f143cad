"""PyTorch port, the slice end to end: ``Detector(device="cpu")`` against the
JAX ``Model.apply(..., train=False)`` on the same converted weights, with
the occupancy-packed mask branch (``mask_budget``, window 16) set.

The det convs' objectness biases are raised in the numpy weights both sides
load, so NMS, the mask branch and the budget cut all see real ROIs.
Tolerances (f32 on both sides): ``valid``, ``labels``, ``levels`` and
``mask_valid`` equal; boxes and scores atol 1e-3; masks atol 1e-4; the
letterbox resize atol 2e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.data.preproc import letterbox_batch as jax_letterbox
from hd_yolo_tpu.data.preproc import normalize as jax_normalize
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.ops.boxes import scale_coords as jax_scale_coords
from hd_yolo_tpu_torch.data.preproc import letterbox_batch, normalize
from hd_yolo_tpu_torch.detector import Detector
from torch_port_common import random_variables

SIZE = 128
KW = dict(max_masks=16, pre_nms_topk=256, mask_window=16, mask_budget=20)
X_SHAPE = (2, SIZE, SIZE, 3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", **KW)
    variables = random_variables(jm, X_SHAPE, seed=1, obj_bias=1.0)
    path = tmp_path_factory.mktemp("w") / "weights.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector("yolov5s-test", "hyp-nuclei", weights=str(path), input_size=SIZE,
                   dtype=torch.float32, device="cpu", **KW)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, train=False)[1])
    return jm, variables, det, fwd


def _compare(got, want):
    for k in ("valid", "labels", "levels", "mask_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=1e-4)


def test_slice_matches_jax_model_apply(setup, rng):
    jm, variables, det, fwd = setup
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    want = fwd(variables, jnp.asarray(x))["det"]
    got = det.tiles(x)["det"]
    _compare(got, want)
    # the path did real work: detections, and more mask-eligible ROIs than the budget
    valid = np.asarray(want["valid"])
    R = KW["max_masks"]
    assert valid.sum() > 0
    assert valid[:, :R].sum() > KW["mask_budget"]
    assert int(np.asarray(want["mask_valid"]).sum()) == KW["mask_budget"]
    assert np.asarray(want["masks"]).max() > 0


def test_letterbox_matches_jax(rng):
    """jax.image.resize antialiases when it shrinks; the port's antialiased
    bilinear F.interpolate agrees within 2e-6, shrinking or growing."""
    for shape in [(97, 150, 3), (300, 211, 3), (60, 97, 3)]:
        im = rng.integers(0, 256, shape).astype(np.uint8)
        a, ga, pa = jax_letterbox(jax_normalize(jnp.asarray(im)[None]), (SIZE, SIZE))
        b, gb, pb = letterbox_batch(normalize(torch.from_numpy(im)[None]), (SIZE, SIZE))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2e-6)
        assert abs(float(ga) - gb) < 1e-6
        assert np.allclose([float(p) for p in pa], pb)


def test_detector_call_odd_image_matches_jax(setup, rng):
    """Detector.__call__ on an odd-sized image (letterbox, model, scale_coords)
    against the same steps in JAX."""
    jm, variables, det, fwd = setup
    im = rng.integers(0, 256, (97, 60, 3)).astype(np.uint8)
    x, gain, (px, py) = jax_letterbox(jax_normalize(jnp.asarray(im)[None]), (SIZE, SIZE))
    o = fwd(variables, x)["det"]
    v = np.asarray(o["valid"][0])
    boxes = np.asarray(jax_scale_coords((SIZE, SIZE), o["boxes"][0], im.shape[:2],
                                        ratio_pad=((gain, gain), (px, py))))
    rec = det(im)[0]["det"]
    np.testing.assert_allclose(rec["boxes"], boxes[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rec["scores"], np.asarray(o["scores"][0])[v], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(rec["labels"], np.asarray(o["labels"][0])[v])
    R = o["masks"].shape[1]
    np.testing.assert_array_equal(rec["has_mask"][: min(R, v.sum())],
                                  np.asarray(o["mask_valid"][0])[v[:R]])
    assert len(det([im, im])) == 2
    df = det(im).pandas()
    assert len(df) == int(v.sum())


def test_detector_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector("yolov5s-test", "hyp-nuclei", device="cuda")


def test_slice_partial_mask_prefix_matches_jax(rng, tmp_path):
    """A mask budget above the eligible count: the packed branch's ``sel_ok``
    prefix is partial, so the head computes only its leading slots
    (``active``) and the rest stay 0 — the same outputs as the JAX branch."""
    kw = dict(KW, max_masks=300, mask_budget=600)
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", **kw)
    variables = random_variables(jm, X_SHAPE, seed=1, obj_bias=1.0)
    path = tmp_path / "weights.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector("yolov5s-test", "hyp-nuclei", weights=str(path), input_size=SIZE,
                   dtype=torch.float32, device="cpu", **kw)
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False)[1])(variables, jnp.asarray(x))["det"]
    got = det.tiles(x)["det"]
    _compare(got, want)
    eligible = int(np.asarray(want["mask_valid"]).sum())
    assert 0 < eligible < kw["mask_budget"]


def test_packed_branch_pools_the_active_prefix_from_the_level_maps(setup, rng, monkeypatch):
    """The packed mask branch hands the pooling and the mask head one device
    count (``sel_ok.sum()``) as ``active``; pooled rows past it are exactly 0,
    the seg maps reach the pooling as contiguous NHWC levels, and no canvas
    is built (``level_canvas`` is off the path)."""
    from hd_yolo_tpu_torch.models import detect_head
    from hd_yolo_tpu_torch.ops import pallas_roi_align, roi_align as roi_ops

    det = setup[2]
    head = det.model.headers["det"]
    monkeypatch.setattr(head, "max_masks", 300)       # a budget above the eligible count:
    monkeypatch.setattr(head, "mask_budget", 600)     # a partial prefix
    monkeypatch.setattr(roi_ops, "level_canvas", lambda *a: pytest.fail("canvas built"))
    seen = {}
    pool, probs, bounded = (detect_head.multiscale_roi_align_packed,
                            detect_head.fused_mask_probs, pallas_roi_align.roi_align_bounded)

    def spy_pool(*a, **k):
        seen["pool_active"], seen["pooled"] = k["active"], pool(*a, **k)
        return seen["pooled"]

    def spy_bounded(levels, *a):
        seen["levels"] = levels
        return bounded(levels, *a)

    def spy_probs(h, pooled, labels, active=None):
        seen["head_active"] = active
        return probs(h, pooled, labels, active)

    monkeypatch.setattr(detect_head, "multiscale_roi_align_packed", spy_pool)
    monkeypatch.setattr(detect_head, "fused_mask_probs", spy_probs)
    monkeypatch.setattr(pallas_roi_align, "roi_align_bounded", spy_bounded)
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    got = det.tiles(x)["det"]
    act = seen["pool_active"]
    assert act is seen["head_active"] and act.dim() == 0
    n = int(act)
    assert 0 < n < seen["pooled"].shape[0] and n == int(got["mask_valid"].sum())
    assert bool((seen["pooled"][n:] == 0).all()) and float(seen["pooled"][:n].abs().max()) > 0
    assert all(f.is_contiguous() and f.dim() == 4 for f in seen["levels"])
    assert len({f.shape[-1] for f in seen["levels"]}) == 1
