"""PyTorch port, the per-image mask branch (no ``mask_budget``): the port's
``Model`` and ``Detector`` against the JAX ones on the same converted
weights, in f32, with the objectness biases raised so that more detections
are mask-eligible than a small packed budget would hold.

Both pooling forms of the branch are held: the exact canvas form (no
``mask_window``, the default) and the gathered-window form
(``mask_window=16``).  ``Detector()`` at its defaults (``mask_budget`` None,
``max_masks`` 100, no window) is held against the JAX ``Detector()``.
Tolerances as ``tests/test_torch_slice.py``: ``valid``, ``labels``,
``levels`` and ``mask_valid`` equal; boxes and scores atol 1e-3; masks atol
1e-4.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.detector import Detector as JaxDetector
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.detector import Detector
from torch_port_common import random_variables

SIZE = 128
X_SHAPE = (2, SIZE, SIZE, 3)
SMALL_BUDGET = 20          # the packed branch's cut that the per-image branch must not make


def _weights(jm, tmp_path, seed=1):
    variables = random_variables(jm, X_SHAPE, seed=seed, obj_bias=1.0)
    path = tmp_path / "weights.pkl"
    path.write_bytes(pickle.dumps(variables))
    return variables, str(path)


def _compare(got, want):
    for k in ("valid", "labels", "levels", "mask_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mask_window", [None, 16])
def test_per_image_branch_matches_jax(rng, tmp_path, mask_window):
    """Every mask-eligible slot of each image's top R gets its mask, past
    what a small packed budget would keep; masks equal JAX's."""
    kw = dict(max_masks=16, pre_nms_topk=256, mask_window=mask_window)
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", **kw)
    variables, path = _weights(jm, tmp_path)
    det = Detector("yolov5s-test", "hyp-nuclei", weights=path, input_size=SIZE,
                   dtype=torch.float32, device="cpu", **kw)
    assert det.model.headers["det"].mask_budget is None
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False)[1])(variables, jnp.asarray(x))["det"]
    got = det.tiles(x)["det"]
    _compare(got, want)
    R = kw["max_masks"]
    head = det.model.headers["det"]
    mask_idx = torch.tensor(head.mask_indices_list)
    eligible = got["valid"][:, :R] & (mask_idx[got["labels"][:, :R].clamp(0, head.nc)] >= 0)
    assert int(eligible.sum()) > SMALL_BUDGET
    assert torch.equal(got["mask_valid"], eligible)
    m = got["masks"]
    assert bool((m[~got["mask_valid"]] == 0).all())
    assert bool((m.amax((-2, -1))[got["mask_valid"]] > 0).all())


def test_detector_defaults_match_jax_detector(rng, tmp_path):
    """``Detector()`` and the JAX ``Detector()`` at their defaults (per-image
    mask branch, 100 masks an image, canvas pooling), same weights: the
    records of ``__call__`` on an odd-sized image agree, and every kept
    detection of the top 100 carries its mask."""
    jdet = JaxDetector("yolov5s-test", "hyp-nuclei", input_size=SIZE, dtype=jnp.float32)
    assert jdet.model.mask_budget is None
    variables, path = _weights(jdet.model, tmp_path, seed=2)
    jdet.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    det = Detector("yolov5s-test", "hyp-nuclei", weights=path, input_size=SIZE,
                   dtype=torch.float32, device="cpu")
    head = det.model.headers["det"]
    assert head.mask_budget is None and head.mask_window is None and head.max_masks == 100
    im = rng.integers(0, 256, (97, 150, 3)).astype(np.uint8)
    got, want = det(im)[0]["det"], jdet(im)[0]["det"]
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["has_mask"], want["has_mask"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)
    n = len(got["labels"])
    assert n > SMALL_BUDGET
    assert got["has_mask"][:min(n, 100)].all()
