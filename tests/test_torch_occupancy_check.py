"""PyTorch port: ``hd_yolo_tpu_torch/tools/occupancy_check.py`` against the
JAX package's ``tools/occupancy_check.py`` in a tiny CPU run on the same
weights and tiles.

The JAX tool builds ``yolov5l6-mask`` in bf16 and loads a run's orbax
weights; here its ``Model.from_cfg`` builds ``yolov5s-test`` in f32 and its
``load_inference`` returns seeded numpy weights (``random_variables``, an
objectness bias of -2 so that the random model detects up to the 16 masks
a tile the per-image branch keeps), the same weights the port's tool loads
from a ``.pt`` (``utils/convert.state_dict_from_flax``).  Both sweep 6 and
12 nuclei a tile, 4 tiles of 128 px a density, batch 2 and a budget of 24
ROIs a call: the random model's eligible ROIs (29 and 24 at 12 nuclei, 32
at 6) exceed the budget in three of the four batches and meet it in one.

Held: every sweep row's eligible counts a batch and drops exactly; the
mask mAPs (rounded to 4 places by both tools) within 1e-3; the masks both
branches keep equal within 1e-6 in each package; the envelope equal.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import pytest
import torch

import hd_yolo_tpu.engines.checkpoint as jax_checkpoint
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.engines.checkpoint import save_inference
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.tools import occupancy_check
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--batch", "2", "--tiles", "4", "--img-size", "128", "--sweep", "6,12", "--budget", "24",
        "--max-masks", "16"]


def run_jax_tool(variables, tmp_path):
    spec = importlib.util.spec_from_file_location("jax_occupancy_check",
                                                  os.path.join(ROOT, "tools",
                                                               "occupancy_check.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    orig = JaxModel.from_cfg
    out = tmp_path / "jax.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxModel, "from_cfg",
                   lambda cfg, hyp=None, **kw: orig("yolov5s-test", hyp,
                                                    **{**kw, "dtype": jnp.float32}))
        mp.setattr(jax_checkpoint, "load_inference", lambda path: variables)
        mp.setattr(sys, "argv", ["occupancy_check.py", "--run", str(tmp_path), *ARGS,
                                 "--out", str(out)])
        tool.main()
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("occupancy")
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", max_masks=16, pre_nms_topk=1024,
                           mask_window=16)
    variables = random_variables(jm, (1, 128, 128, 3), seed=3, obj_bias=-2.0)
    want = run_jax_tool(variables, tmp)
    tm = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec))
    weights = save_inference(str(tmp / "final.pt"), tm)
    torch.set_num_threads(2)
    got = occupancy_check.main(["--device", "cpu", "--cfg", "yolov5s-test", "--weights", weights,
                                *ARGS, "--out", str(tmp / "port.json")])
    return got, want


def test_occupancy_rows_match_jax(both):
    got, want = both
    assert [r["nuclei_per_tile"] for r in got["sweep"]] == [6, 12]
    for g, w in zip(got["sweep"], want["sweep"]):
        assert set(g) == set(w)
        for k in ("eligible_per_batch", "eligible_max", "dropped_total", "drop_rate"):
            assert g[k] == w[k], (g["nuclei_per_tile"], k, g[k], w[k])
        for k in ("mask_map50_unpacked", "mask_map50_packed", "mask_map_unpacked",
                  "mask_map_packed"):
            assert abs(g[k] - w[k]) <= 1e-3, (g["nuclei_per_tile"], k, g[k], w[k])
        assert g["max_abs_mask_diff_kept"] <= 1e-6 and w["max_abs_mask_diff_kept"] <= 1e-6
    dense = got["sweep"][-1]
    assert dense["eligible_max"] > 24 and dense["dropped_total"] > 0
    assert min(dense["eligible_per_batch"]) <= 24          # a batch within the budget
    assert got["envelope"] == want["envelope"]
    assert {k: got[k] for k in ("batch", "tiles_per_density", "budget", "max_masks_unpacked")} \
        == {k: want[k] for k in ("batch", "tiles_per_density", "budget", "max_masks_unpacked")}


def test_occupancy_drops_are_the_budget_excess(both):
    """Each batch keeps min(eligible, budget) masks: the tool's drops are the
    excess of its batches over the budget."""
    for row in both[0]["sweep"]:
        assert row["dropped_total"] == sum(max(0, c - 24) for c in row["eligible_per_batch"])
