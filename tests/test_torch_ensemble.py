"""PyTorch port: ensembles (``hd_yolo_tpu_torch/models/ensemble.py``) against
the JAX package on the CPU.

* ``merge_outputs`` on synthetic member outputs (clustered boxes, so the
  class-agnostic NMS suppresses across members): without masks, with
  masks, and with masks capped below the detection axis (the padding
  branch, a member without ``mask_valid``) — ``valid``, ``labels`` and
  ``mask_valid`` equal, boxes, scores and masks exact (the same rows are
  gathered);
* ``Ensemble`` of two ``yolov5s-test`` models with JAX's weights at 128 px
  in f32 against JAX's ``Ensemble`` of the same two: ``valid``, ``labels``
  and ``mask_valid`` equal, boxes and scores within 1e-3, masks 1e-4
  (``tests/test_torch_per_image_masks.py``'s tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hd_yolo_tpu_torch
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.models.ensemble import Ensemble as JaxEnsemble
from hd_yolo_tpu.models.ensemble import merge_outputs as jax_merge
from hd_yolo_tpu_torch.models.ensemble import merge_outputs
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

B, SIZE = 2, 128


def member(rng, D, R=None, mask_valid=True):
    """One member's padded outputs: D rows, boxes around 6 cluster centres,
    about 3/4 valid; with ``R`` masks for its first R rows."""
    centres = rng.uniform(20, 100, (6, 2))
    c = centres[rng.integers(0, 6, (B, D))] + rng.normal(0, 2, (B, D, 2))
    wh = rng.uniform(8, 16, (B, D, 2))
    valid = rng.uniform(0, 1, (B, D)) > 0.25
    out = {"boxes": np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32),
           "scores": (rng.uniform(0, 1, (B, D)) * valid).astype(np.float32),
           "labels": np.where(valid, rng.integers(1, 5, (B, D)), -100).astype(np.int32),
           "valid": valid}
    if R is not None:
        out["masks"] = rng.uniform(0, 1, (B, R, 28, 28)).astype(np.float32)
        if mask_valid:
            out["mask_valid"] = valid[:, :R] & (rng.uniform(0, 1, (B, R)) > 0.1)
    return out


def check_merge(members, **kw):
    want = jax.tree.map(np.asarray, jax_merge(
        [{k: jnp.asarray(v) for k, v in m.items()} for m in members], **kw))
    got = merge_outputs([{k: torch.from_numpy(v) for k, v in m.items()} for m in members], **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    return want


@pytest.mark.parametrize("masks", ["none", "full", "capped"])
def test_merge_outputs_matches_jax(masks):
    rng = np.random.default_rng({"none": 0, "full": 1, "capped": 2}[masks])
    R = {"none": (None, None), "full": (40, 30), "capped": (12, 9)}[masks]
    members = [member(rng, 40, R[0]), member(rng, 30, R[1], mask_valid=masks != "capped")]
    want = check_merge(members, conf_thres=0.2, iou_thres=0.45, max_det=32)
    n = want["valid"].sum(1)
    assert (n > 4).all() and (n < 0.75 * 70).all()         # the NMS suppressed rows
    assert ("masks" in want) == (masks != "none")


def test_merge_outputs_keeps_at_most_max_det():
    rng = np.random.default_rng(3)
    want = check_merge([member(rng, 64), member(rng, 64)], conf_thres=0.0, iou_thres=0.9,
                       max_det=10)
    assert want["valid"].shape == (B, 10) and want["valid"].all()


def test_ensemble_matches_jax(rng):
    kw = dict(max_masks=16, pre_nms_topk=128)
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", **kw)
    trees = [random_variables(jm, (B, SIZE, SIZE, 3), seed=s, obj_bias=1.0) for s in (1, 2)]
    ports = []
    for v in trees:
        tm = Model.from_cfg("yolov5s-test", "hyp-nuclei", **kw)
        tm.load_state_dict(state_dict_from_flax(v, tm.spec), strict=True)
        ports.append(tm.eval())
    x = rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    jens = JaxEnsemble([(jm, jax.tree.map(jnp.asarray, v)) for v in trees])
    want = jax.tree.map(np.asarray, jax.jit(lambda xx: jens(xx))(jnp.asarray(x)))["det"]
    got = hd_yolo_tpu_torch.Ensemble(ports)(torch.from_numpy(x))["det"]
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "masks", "mask_valid"}
    assert want["masks"].shape == (B, 300, 28, 28)            # padded from each member's 16
    assert want["valid"].sum() > 20 and want["mask_valid"].sum() > 8
    for k in ("valid", "labels", "mask_valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0, atol=1e-4)
