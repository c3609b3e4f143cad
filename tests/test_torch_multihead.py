"""PyTorch port: the two-header configs (``det`` nc 7 and ``detSC`` nc 4 on
one trunk, both with masks) against the JAX package on the CPU, at
``yolov5s-multihead-test`` / 128 px in f32 with JAX's weights carried by
``state_dict_from_flax``.

* inference outputs of both tasks: ``valid``, ``labels``, ``levels`` and
  ``mask_valid`` equal; boxes, scores and the score vectors within 1e-3,
  masks 1e-4 (``tests/test_torch_per_image_masks.py``'s tolerances);
* training losses of both tasks with ``det`` active on image 0 only and
  ``detSC`` on image 1 only (``tests/test_multitask.py``'s split): loss
  items within rtol 1e-4, every gradient within 1e-3·max|g| (2e-2 in the
  mask branches, as ``tests/test_torch_train_step.py`` explains);
* ``Detector(..., task=)`` records against JAX's, and the REST path's
  ``?task=`` rows.  (One exported program carrying both tasks, equal to
  the eager forward, is held by the multihead tool's CPU run in
  ``tests/test_torch_multihead_check.py``.)
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.detector import Detector as JaxDetector
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch import serving
from hd_yolo_tpu_torch.detector import Detector
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

CFG, SIZE, B, T = "yolov5s-multihead-test", 128, 2, 8
X_SHAPE = (B, SIZE, SIZE, 3)
KW = dict(mask_rois=4, max_masks=8, pre_nms_topk=64)
NO = {"det": 12, "detSC": 9}
MASK_TENSORS = tuple(f"headers.{t}.{p}" for t in NO for p in ("seg.", "seg_h."))


def hyp():
    h = jax_load_cfg("hyp-nuclei")
    for t in NO:
        h[t]["mask_iou_t"] = 0.05          # random weights: give the mask loss winners
    return h


def weights(jm, seed=0):
    """JAX's tree with each header's objectness biases raised by 1."""
    v = random_variables(jm, X_SHAPE, seed=seed)
    for t, no in NO.items():
        for lvl in range(3):
            v["params"][f"header_{t}"][f"det{lvl}"]["bias"][4::no] += 1.0
    return v


def targets(seed):
    """Both tasks' targets; ``det`` valid on image 0 only, ``detSC`` on image 1 only."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, nc, img in (("det", 7, 0), ("detSC", 4, 1)):
        xy = rng.uniform(0.1, 0.6, (B, T, 2))
        wh = rng.uniform(0.08, 0.3, (B, T, 2))
        valid = np.zeros((B, T), bool)
        valid[img, :6] = True
        yy, xx = np.mgrid[0:28, 0:28] + 0.5
        rad = rng.uniform(6, 13, (B, T, 1, 1))
        out[t] = {"boxes": np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32),
                  "labels": rng.integers(1, nc + 1, (B, T)).astype(np.int64),
                  "masks": (((yy - 14) ** 2 + (xx - 14) ** 2) < rad ** 2).astype(np.float32),
                  "valid": valid}
    return out


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel.from_cfg(CFG, hyp(), **KW)
    variables = weights(jm)
    tm = Model.from_cfg(CFG, hyp(), **KW)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    x = np.random.default_rng(3).uniform(0, 1, X_SHAPE).astype(np.float32)
    return jm, variables, tm.eval(), x


def compare(got, want):
    for k in ("valid", "labels", "levels", "mask_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("boxes", "scores", "score_vector"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=1e-4)


def test_outputs_of_both_tasks_match_jax(pair):
    jm, variables, tm, x = pair
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False)[1])(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) == set(want) == {"det", "detSC"}
    assert got["det"]["score_vector"].shape[-1] == 8 and got["detSC"]["score_vector"].shape[-1] == 5
    for t in NO:
        assert np.asarray(want[t]["valid"]).sum() > 10, t
        compare(got[t], want[t])


def test_losses_and_gradients_with_one_task_an_image(pair):
    jm, variables, tm, x = pair
    tg = targets(5)

    def loss_fn(params):
        (losses, _), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), jax.tree.map(jnp.asarray, tg), train=True,
                                  compute_masks=True, mutable=["batch_stats"])
        return jm.total_loss(losses), {t: losses[t]["loss_items"] for t in NO}

    (jl, jitems), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tm.train()
    tm.zero_grad()
    try:
        losses, outputs = tm.losses(torch.from_numpy(x),
                                    {t: {k: torch.from_numpy(v) for k, v in d.items()}
                                     for t, d in tg.items()})
        total = tm.total_loss(losses)
        total.backward()
    finally:
        tm.eval()
    assert outputs == {"det": {}, "detSC": {}}
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    for t in NO:
        assert float(jitems[t]["mask"]) > 0, t
        for k, v in jitems[t].items():
            np.testing.assert_allclose(float(losses[t]["loss_items"][k]), float(v), rtol=1e-4,
                                       err_msg=f"{t}/{k}")
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jg),
                                 "batch_stats": variables["batch_stats"]}, tm.spec)
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * np.abs(w).max()
        assert np.abs(p.grad.numpy() - w).max() <= tol, name
    tm.zero_grad(set_to_none=True)


def test_detector_task_filter_and_serving(pair, tmp_path):
    jm, variables, _, _ = pair
    path = tmp_path / "w.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector(CFG, "hyp-nuclei", weights=str(path), input_size=SIZE, dtype=torch.float32,
                   device="cpu", **KW)
    jdet = JaxDetector(CFG, "hyp-nuclei", input_size=SIZE, dtype=jnp.float32, **KW)
    jdet.variables = jax.tree.map(jnp.asarray, variables)
    im = np.random.default_rng(6).integers(0, 256, (100, 140, 3)).astype(np.uint8)
    both = det(im)[0]
    assert set(both) == {"det", "detSC"}
    for t in NO:
        got, want = det(im, task=t)[0], jdet(im, task=t)[0]
        assert set(got) == set(want) == {t}
        np.testing.assert_array_equal(got[t]["labels"], want[t]["labels"])
        np.testing.assert_allclose(got[t]["boxes"], want[t]["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[t]["scores"], want[t]["scores"], rtol=0, atol=1e-3)
        assert len(got[t]["labels"]) > 0
        # the request path: ?task= keeps that header's rows only
        serving._detector = det
        try:
            code, rows = serving._respond(im, False, t)
        finally:
            serving._detector = None
        assert code == 200 and rows and all(r["task"] == t for r in rows)
        assert len(rows) == len(got[t]["labels"])
