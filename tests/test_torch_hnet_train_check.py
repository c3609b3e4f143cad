"""PyTorch port: the hnet quality tool
(``hd_yolo_tpu_torch/tools/hnet_train_check.py``) on the CPU.

* ``render_tile`` with ``class_probs`` and ``axes_scale`` draws the JAX
  tool's tiles from the same seed, pixel for pixel;
* ``build_split`` gives the JAX tool's arrays for one seed, exactly;
* the tool trains a small hnet for two epochs and writes JAX's JSON keys,
  with the trained model's zero-gradient ROI counts at each ROI-align
  backward call of one micro-step.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from hd_yolo_tpu_torch.tools import flagship_train_check as flagship
from hd_yolo_tpu_torch.tools import hnet_train_check as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return mod


@pytest.mark.parametrize("probs,scale", [((0.1, 0.6, 0.2, 0.1), 1.0), (None, 1.5),
                                         ((0.25, 0.25, 0.25, 0.25), 0.7)])
def test_render_tile_options_draw_the_jax_tiles(probs, scale):
    ref = jax_tool("flagship_train_check")
    p = None if probs is None else np.asarray(probs)
    a = flagship.render_tile(np.random.default_rng(4), 160, 14, class_probs=p, axes_scale=scale)
    b = ref.render_tile(np.random.default_rng(4), 160, 14, class_probs=p, axes_scale=scale)
    np.testing.assert_array_equal(a[0], b[0])
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1])) and a[2] == b[2]
    for u, v in zip(a[3], b[3]):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("seg_stride", [16, 4])
def test_build_split_equals_the_jax_tools(seg_stride):
    ref = jax_tool("hnet_train_check")
    imgs, tg = tool.build_split(1, 3, 192, 20, seg_stride)
    want_imgs, want = ref.build_split(1, 3, 192, 20, seg_stride)
    np.testing.assert_array_equal(imgs, want_imgs)
    for task, d in want.items():
        for k, v in d.items():
            assert tg[task][k].dtype == v.dtype, (task, k)
            np.testing.assert_array_equal(tg[task][k], v, err_msg=f"{task}/{k}")
    assert tg["det40x"]["valid"].sum() == 3 * 20


def test_tool_trains_and_reports_on_the_cpu(tmp_path):
    out = tmp_path / "hnet.json"
    res = tool.main(["--device", "cpu", "--small", "--img", "128", "--n-train", "2",
                     "--n-val", "2", "--batch", "2", "--epochs", "2", "--nuclei", "6",
                     "--cl-weight", "4", "--seg-scale", "4", "--seg-gt-stride", "4",
                     "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    ref_keys = set(json.loads(open(os.path.join(REPO, "HNET_QUALITY.json")).read()))
    assert ref_keys <= set(res)
    assert res["config"]["cl_weight"] == 4.0 and res["config"]["seg_gt_stride"] == 4
    for k in ("det_map50", "det_fitness", "seg_miou", "cl_acc"):
        assert 0.0 <= res[k] <= 1.0, k
    z = res["zero_gradient_rois"]
    assert len(z["roi_align_bwd"]) == 4 and len(z["roi_align_single_bwd"]) == 3
    for calls in z.values():
        for c in calls:
            assert c["rois"] > 0 and 0 <= c["zero_gradient"] <= c["rois"]
