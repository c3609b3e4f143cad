"""PyTorch port: the anchor-free detector's entry points and its quality
tool on the CPU.

* ``yolov6s-af`` with JAX's weights through ``Detector.__call__`` against
  JAX's ``Detector`` (labels equal, boxes and scores within 1e-3),
  ``Detector.slide`` and an exported program (bit for bit the eager
  forward);
* ``hd_yolo_tpu_torch/tools/af_quality.py`` trained through the CLI for
  two epochs at 128 px, validated each epoch, to JAX's JSON keys.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hd_yolo_tpu.detector import Detector as JaxDetector
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.detector import Detector
from hd_yolo_tpu_torch.engines import evaluate
from hd_yolo_tpu_torch.tools import af_quality
from torch_port_common import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128


def test_entry_points_run_the_anchor_free_model(tmp_path):
    """``Detector.__call__`` against JAX's ``Detector`` on the same weights
    (labels equal, boxes and scores within 1e-3), ``Detector.slide`` (rows
    inside the slide, no masks), and an exported program bit for bit the
    eager forward."""
    jm = JaxModel.from_cfg("yolov6s-af", "hyp-nuclei", pre_nms_topk=64)
    variables = random_variables(jm, (1, SIZE, SIZE, 3), seed=3)
    for lvl in range(3):            # objectness up, for a few dozen detections
        variables["params"]["header_det"][f"obj_pred{lvl}"]["bias"] += 2.0
    path = tmp_path / "w.pkl"
    path.write_bytes(pickle.dumps(variables))
    det = Detector("yolov6s-af", "hyp-nuclei", weights=str(path), input_size=SIZE,
                   dtype=torch.float32, device="cpu", pre_nms_topk=64)
    jdet = JaxDetector("yolov6s-af", "hyp-nuclei", input_size=SIZE, dtype=jnp.float32,
                       pre_nms_topk=64)
    jdet.variables = jax.tree.map(jnp.asarray, variables)
    im = np.random.default_rng(8).integers(0, 256, (100, 150, 3)).astype(np.uint8)
    got, want = det(im)[0]["det"], jdet(im)[0]["det"]
    assert set(got) == set(want) == {"boxes", "scores", "labels"}
    assert len(want["labels"]) > 10
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-3)

    slide = np.random.default_rng(9).integers(0, 256, (300, 260, 3)).astype(np.uint8)
    rec = det.slide(slide, tile=SIZE, overlap=32, batch=4)[0]["det"]
    assert set(rec) == {"boxes", "scores", "labels"} and len(rec["labels"]) > 10
    assert (rec["boxes"][:, [0, 2]] <= 260).all() and (rec["boxes"][:, [1, 3]] <= 300).all()

    x = torch.from_numpy(np.random.default_rng(10).integers(0, 256, (1, SIZE, SIZE, 3),
                                                            dtype=np.uint8))
    program = evaluate.load_exported(evaluate.export(det.model, tuple(x.shape),
                                                     str(tmp_path / "af.pt2")))
    eager, out = det.tiles(x)["det"], program(x)["det"]
    assert set(out) == set(eager)
    for k, v in eager.items():
        assert torch.equal(out[k], v), k


def test_af_quality_tool_trains_and_reports_on_the_cpu(tmp_path):
    out = tmp_path / "af.json"
    row = af_quality.main(["--device", "cpu", "--img-size", "128", "--images", "2",
                           "--val-images", "2", "--batch-size", "2", "--epochs", "2",
                           "--workers", "2", "--dir", str(tmp_path / "work"), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(row))
    with open(os.path.join(REPO, "AF_QUALITY.json")) as f:
        ref_keys = set(json.load(f))
    assert ref_keys <= set(row), ref_keys - set(row)
    assert row["epochs"] == 2 and row["img_size"] == 128
    for k in ("best_fitness", "det/map50", "det/fitness"):
        assert 0.0 <= row[k] <= 1.0, k
    assert (tmp_path / "work" / "run" / "final.pt").exists()
