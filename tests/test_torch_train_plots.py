"""PyTorch port: the training plots (``hd_yolo_tpu_torch/engines/plots.py``
``feature_visualization``, ``plot_labels``, ``plot_evolve``,
``plot_results``) against the JAX package's on the same seeded inputs:
the same files, the same pixels."""

import csv
import json
import os

import cv2
import numpy as np
import pytest

from hd_yolo_tpu.engines import plots as jax_plots
from hd_yolo_tpu_torch.engines import plots


def _inputs(root, rng):
    """Each plot's arguments, its inputs written under ``root``."""
    os.makedirs(root, exist_ok=True)
    evolve_csv = os.path.join(root, "evolve.csv")
    with open(evolve_csv, "w", newline="") as f:
        w = csv.DictWriter(f, ["generation", "fitness", "lr0", "momentum", "box"])
        w.writeheader()
        for g in range(6):
            w.writerow({"generation": g, "fitness": rng.uniform(), "lr0": rng.uniform(0.001, 0.02),
                        "momentum": rng.uniform(0.8, 0.98), "box": rng.uniform(0.02, 0.1)})
    results_json = os.path.join(root, "results.json")
    with open(results_json, "w") as f:
        for e in range(4):
            f.write(json.dumps({"epoch": e, "loss": 3.0 - e * 0.5 + rng.uniform(),
                                "det/map50": e * 0.2, "fitness": e * 0.1, "lr": 0.01}) + "\n")
    labels = np.concatenate([rng.integers(1, 5, (300, 1)), rng.uniform(0.05, 0.95, (300, 2)),
                             rng.uniform(0.01, 0.2, (300, 2))], 1)
    return {
        "feature_visualization": ((rng.standard_normal((12, 12, 20)).astype(np.float32),
                                   os.path.join(root, "features", "stage3.png")), {}),
        "plot_labels": ((labels,), {"names": ["tumor", "stroma", "lympho", "other"],
                                    "save_dir": root}),
        "plot_evolve": ((evolve_csv,), {}),
        "plot_results": ((results_json,), {}),
    }


def _images(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".png", ".jpg")):
                out[os.path.relpath(os.path.join(d, f), root)] = cv2.imread(os.path.join(d, f))
    return out


@pytest.mark.parametrize("name", ["feature_visualization", "plot_labels", "plot_evolve",
                                  "plot_results"])
def test_training_plot_writes_jax_files(tmp_path, name):
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    a, k = _inputs(got_dir, np.random.default_rng(0))[name]
    got = getattr(plots, name)(*a, **k)
    a, k = _inputs(want_dir, np.random.default_rng(0))[name]
    want = getattr(jax_plots, name)(*a, **k)
    if want is not None:
        assert os.path.relpath(got, got_dir) == os.path.relpath(want, want_dir)
    gi, wi = _images(got_dir), _images(want_dir)
    assert gi and set(gi) == set(wi)
    for f in gi:
        assert gi[f] is not None and gi[f].shape == wi[f].shape, f
        np.testing.assert_array_equal(gi[f], wi[f], err_msg=f)
