"""The benchmark's CPU tests: the harness's modules on the path, and a
scratch checkout that holds a copy of the benchmark with tiny cells of the
port's test model (``data/tiny.json``, 128 px) beside the real ones."""

import json
import os
import shutil
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAFFIC = {
    "tiny-tiles": {"entry": "tiles", "why": "2 x 128 px", "batch": 2, "pool": 2,
                   "detector": {"mask_budget": 24}, "calibrate": {"per_tile": 8, "tiles": 2},
                   "warmup": 1, "judge": 2, "profile_requests": 1,
                   "spans": ["bench.tiles", "bench.trunk", "bench.detect", "bench.masks"]},
    "tiny-slide": {"entry": "slide", "why": "a 1504 px slide", "slide_px": 1504, "pool": 1,
                   "detector": {},
                   "slide": {"tile": 512, "overlap": 16, "batch": 3, "fused": True,
                             "iou_thres": 0.45, "max_total": 256, "band_margin": 32,
                             "max_band": 1024, "mask_rows": 1024, "max_masks": 64},
                   "slide_args": ["tile", "overlap", "batch", "fused", "iou_thres", "max_total"],
                   "calibrate": {"per_tile": 6, "tiles": 2}, "warmup": 1, "judge": 1,
                   "profile_requests": 1,
                   "spans": ["bench.slide", "bench.trunk", "bench.detect", "bench.masks",
                             "bench.stitch", "bench.fetch"]},
}

TINY_CONFIG = {"tiny-tiles": "tiny", "tiny-slide": "tiny_small"}


def make_root(tmp, limits=None):
    """A checkout in ``tmp``: the benchmark copied, the tiny configuration
    and traffic added as files, and a ``BENCHMARK.json`` whose cells are
    the real ones and two tiny ones."""
    dst = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(BENCH, "tests", "data", "tiny.json"),
                os.path.join(dst, "configs", "tiny.json"))
    # the slide's: anchors a quarter of the size, so that most boxes lie
    # inside their tile's core (the test model's P5 anchors reach 373 px)
    small = json.load(open(os.path.join(BENCH, "tests", "data", "tiny.json")))
    small["model"]["anchors"] = [[v // 4 for v in row] for row in small["model"]["anchors"]]
    with open(os.path.join(dst, "configs", "tiny_small.json"), "w") as f:
        json.dump(small, f)
    for name, t in TINY_TRAFFIC.items():
        with open(os.path.join(dst, "workloads", name + ".json"), "w") as f:
            json.dump(t, f)
        if limits:
            with open(os.path.join(dst, "limits", name + ".json"), "w") as f:
                json.dump({"limits": limits}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cfg in ("tiny", "tiny_small"):
        bench["configs"].append({"name": cfg, "source": "tests",
                                 "file": f"benchmark/configs/{cfg}.json", "reduced": [],
                                 "why": "CPU test"})
    for name in TINY_TRAFFIC:
        bench["workloads"].append({"name": name, "config": TINY_CONFIG[name], "traffic": name,
                                   "chips": 1, "why": "CPU test"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(tmp)


@pytest.fixture
def tiny_root(tmp_path):
    torch.manual_seed(0)
    return make_root(tmp_path)
