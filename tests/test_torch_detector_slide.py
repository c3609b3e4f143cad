"""PyTorch port, ``Detector.slide`` on the CPU against the JAX
``Detector.slide`` on the same converted weights: ``yolov5s-test`` at
128 px tiles, overlap 64, on a ~200 x 330 slide (15 tiles, so the default
batch of 8 pads the grid by one tile in the default fused mode) and on a
slide smaller than one tile (padded to it), streaming.  The objectness
biases are raised to +1, so the large slide's band population saturates
``max_band`` (both sides warn and drop the same rows) and the small one's
does not.

Tolerances (f32 on both sides), as the tile slice holds them: labels,
``has_mask`` and the row count equal; boxes and scores atol 1e-3; masks
atol 1e-4.
"""

import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.detector import Detector as JaxDetector
from hd_yolo_tpu_torch.detector import Detector
from torch_port_common import random_variables

SIZE = 128
KW = dict(max_masks=16, pre_nms_topk=256, mask_window=16, mask_budget=20)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    jdet = JaxDetector("yolov5s-test", "hyp-nuclei", input_size=SIZE, dtype=jnp.float32, **KW)
    variables = random_variables(jdet.model, (1, SIZE, SIZE, 3), seed=3, obj_bias=1.0)
    jdet.variables = variables
    path = tmp_path_factory.mktemp("w") / "weights.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector("yolov5s-test", "hyp-nuclei", weights=str(path), input_size=SIZE,
                   dtype=torch.float32, device="cpu", **KW)
    return jdet, det


def _compare(got, want):
    assert set(got) == set(want)
    assert len(want["boxes"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["has_mask"], want["has_mask"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,kw", [((200, 330, 3), {}),
                                      ((100, 120, 3), {"fused": False, "batch": 2})])
def test_detector_slide_matches_jax(detectors, rng, shape, kw):
    jdet, det = detectors
    slide = rng.integers(0, 256, shape).astype(np.uint8)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jdet.slide(slide, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = det.slide(slide, **kw)
    saturated = [str(m.message) for m in tw if "max_band" in str(m.message)]
    assert saturated == [str(m.message) for m in jw if "max_band" in str(m.message)]
    assert bool(saturated) == (shape[0] > SIZE)
    assert len(got) == 1 and list(got[0]) == ["det"]
    g, w = got[0]["det"], want[0]["det"]
    _compare(g, w)
    h, wd = shape[:2]
    assert (g["boxes"][:, [0, 2]] <= wd).all() and (g["boxes"][:, [1, 3]] <= h).all()
    assert got.images[0].shape == shape
    assert len(got.pandas()) == len(g["boxes"])
