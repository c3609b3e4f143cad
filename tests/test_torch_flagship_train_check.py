"""PyTorch port: the flagship quality tool
(``hd_yolo_tpu_torch/tools/flagship_train_check.py``) on the CPU at a tiny
size — its generator draws the same tiles as ``tools/flagship_train_check.py``
from the same seed, and the tool trains through the CLI with
``--device-augment`` and reports finite box and mask fitness, a
whole-slide check and the trained model's share of zero-gradient mask ROIs.
"""

import importlib.util
import json
import os

import numpy as np

from hd_yolo_tpu_torch.tools import flagship_train_check as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_flagship_train_check", os.path.join(REPO, "tools", "flagship_train_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_generator_draws_the_jax_tools_tiles():
    ref = jax_tool()
    for seed in (0, 3):
        a = tool.render_tile(np.random.default_rng(seed), 160, 12)
        b = ref.render_tile(np.random.default_rng(seed), 160, 12)
        np.testing.assert_array_equal(a[0], b[0])
        assert np.array_equal(np.asarray(a[1]), np.asarray(b[1])) and a[2] == b[2]
        for p, q in zip(a[3], b[3]):
            np.testing.assert_array_equal(p, q)


def test_tool_trains_and_reports_on_the_cpu(tmp_path):
    report = tmp_path / "report.json"
    summary = tool.main(["--device", "cpu", "--cfg", "yolov5s-test", "--img-size", "128",
                         "--images", "2", "--val-images", "2", "--epochs", "1",
                         "--batch-size", "2", "--workers", "2", "--slide-px", "256",
                         "--out", str(tmp_path / "work"), "--report", str(report),
                         "--device-augment"])
    assert json.loads(report.read_text()) == json.loads(json.dumps(summary))
    assert summary["device_augment"] is True
    for k in ("box_fitness", "best_box_fitness", "mask_fitness", "train_s", "wall_s"):
        assert np.isfinite(summary[k]) and summary[k] >= 0, k
    z = summary["zero_gradient_rois"]
    assert z["rois"] == 2 * 32 and 0 <= z["zero_gradient"] <= z["rois"]
    w = summary["wsi_eval"]
    assert w["gt"] == 300 and w["wsi_slide_px"] == 256 and 0 <= w["recall@0.5"] <= 1
