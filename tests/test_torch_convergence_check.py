"""PyTorch port: ``hd_yolo_tpu_torch/tools/convergence_check.py`` against the
JAX package's ``tools/convergence_check.py`` in a tiny CPU run on the same
weights and data (2 steps; the full checks run on the card).

The JAX tool initialises its models with flax's ``init``; here that
``init`` returns seeded numpy weights (``random_variables``), which the
port's tool loads through ``utils/convert.py``.  The JAX tool prints its
numbers; they are read from its output.

* ``--hnet``: the 2-square batch equal to the JAX tool's (what its ``init``
  is called with), the loss after 2 steps rtol 1e-4 (+ atol 1e-6, as
  ``tests/test_torch_hnet_train.py``'s step, whose JAX side also takes the
  ROI-aligns' boxes under ``stop_gradient``: ROADMAP C.2), and the eval
  detections' count and labels equal;
* yolo: the 4-image set written by the port's tool equal to the JAX
  test helper's (``tests/test_train_cli.make_dataset``) file by file.  The
  two tools' training draws are not comparable (the JAX loader augments on
  2 threads from the global ``random`` state, unseeded, so its batches
  differ from run to run), so the port's tool trains its seeded init for
  100 steps on the CPU, its loader on one thread so that the augmentation
  draws come in order and the run repeats (the loss falls), and both tools
  score those weights (carried to JAX by its ``utils/import_torch``)
  without a step: box and mask fitness within 2e-4 (the JAX tool prints 4
  decimals), both above 0.1 (0.2435 and 0.1882), both checks failing their
  floors.
"""

import contextlib
import filecmp
import importlib.util
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet import HNet as JaxHNet
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.utils.import_torch import import_state_dict
import hd_yolo_tpu_torch.data.dataset as dataset_mod
from hd_yolo_tpu_torch.tools import convergence_check as tool
from hd_yolo_tpu_torch.utils.convert import hnet_state_dict_from_flax
from test_torch_hnet_train import boxes_stopped
from test_train_cli import make_dataset as jax_make_dataset
from torch_port_common import random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLO_STEPS = 100


def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_convergence_check",
                                                  os.path.join(ROOT, "tools",
                                                               "convergence_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(fn, cls, variables, seen, stop_boxes=False):
    """``fn()`` with ``cls.init`` returning ``variables`` (its inputs kept in
    ``seen``) and, with ``stop_boxes``, the ROI-aligns' boxes under
    ``stop_gradient``; returns what it printed."""
    def init(self, key, *args, **kw):
        seen.append(jax.tree.map(lambda a: None if isinstance(a, jax.core.Tracer)
                                 else np.asarray(a), args))
        return variables

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(cls, "init", init)
        if stop_boxes:
            boxes_stopped(mp)
        fn()
    return out.getvalue()


@pytest.fixture(scope="module")
def hnet_runs():
    assert tool.hnet_cfg("cpu") == tool.HNET_CFG
    variables = random_variables(JaxHNet.from_cfg(tool.HNET_CFG), (2, 128, 128, 3), seed=2)
    seen = []
    text = run_jax(lambda: jax_tool().hnet_check(2), JaxHNet, variables, seen, stop_boxes=True)
    torch.set_num_threads(2)
    got = tool.hnet_check(2, "cpu", state_dict=hnet_state_dict_from_flax(variables,
                                                                         tool.HNET_CFG))
    return got, text, seen


def test_hnet_check_matches_jax(hnet_runs):
    got, text, seen = hnet_runs
    x, t = tool.hnet_batch()
    np.testing.assert_array_equal(seen[0][0], x)
    for k, v in t["det"].items():
        np.testing.assert_array_equal(seen[0][1]["det"][k], v, err_msg=k)
    want = float(re.search(r"final loss: (\S+)", text).group(1))
    assert abs(got["final_loss"] - want) <= 1e-4 * abs(want) + 1e-6, (got["final_loss"], want)
    m = re.search(r"detections: (\d+) labels: \[([\d, ]*)\]", text)
    assert got["detections"] == int(m.group(1))
    assert got["labels"] == [int(v) for v in m.group(2).split(",") if v.strip()]
    assert got["ok"] == ("PASS" in text)


def test_hnet_check_config_has_no_anchor_at_the_rpn_fg_threshold():
    """ROADMAP C.10: the check's squares (44.8 px) overlap no anchor of the
    config's sizes at the RPN's fg IoU of 0.7, in either package, so each
    square trains one promoted positive anchor."""
    from hd_yolo_tpu.hnet.mask_rcnn import generate_anchors as jax_anchors
    from hd_yolo_tpu_torch.hnet import HNet
    from hd_yolo_tpu_torch.ops.boxes import box_iou

    m = HNet(tool.HNET_CFG, device="cpu").headers["det"]
    shapes = [(32, 32), (16, 16), (8, 8), (4, 4)]
    anchors = m.anchors(shapes, "cpu")
    want = np.concatenate([np.asarray(a) for a in jax_anchors(
        shapes, m.strides, m.anchor_sizes, (0.5, 1.0, 2.0))])
    np.testing.assert_allclose(anchors.numpy(), want, rtol=0, atol=1e-4)
    gt = torch.from_numpy(tool.hnet_batch()[1]["det"]["boxes"][0] * 128)
    best = box_iou(anchors, gt).max(0).values
    assert (best < 0.7).all() and (best > 0.45).all(), best


@pytest.fixture(scope="module")
def yolo_runs(tmp_path_factory):
    """The port's tool trains its seeded init for ``YOLO_STEPS`` steps and
    scores it; the JAX tool scores the same weights (imported by JAX's
    ``utils/import_torch``) without a step."""
    tmp = tmp_path_factory.mktemp("convergence")
    torch.set_num_threads(2)
    (tmp / "port").mkdir()
    data = tool.make_dataset(tmp / "port", n_images=4)
    m = tool.yolo_model("cpu")

    class OneThread(dataset_mod.DataLoader):          # one loader thread: the draws in order
        def __init__(self, *a, **k):
            super().__init__(*a, **{**k, "workers": 1})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dataset_mod, "DataLoader", OneThread)
        losses, _ = tool.yolo_train(m, data, YOLO_STEPS)
    got = tool.yolo_fitness(m, data)
    jm = JaxModel.from_cfg("yolov5s-test", tool.yolo_hyp(), mask_rois=8, max_masks=16,
                           pre_nms_topk=256)
    variables = import_state_dict({k: v.numpy() for k, v in m.state_dict().items()}, jm.spec)
    text = run_jax(lambda: jax_tool().main(["--steps", "0"]), JaxModel, variables, [])
    again = tool.yolo_check(0, "cpu", state_dict=m.state_dict())
    return got, text, tmp, losses, again


def test_yolo_dataset_matches_the_jax_helper(yolo_runs):
    tmp = yolo_runs[2]
    (tmp / "jax").mkdir()
    jax_make_dataset(tmp / "jax", n_images=4)
    names = sorted(os.listdir(tmp / "jax"))
    assert names == sorted(os.listdir(tmp / "port")) and len(names) == 10
    for name in names:
        if name == "data.yaml":                     # names its own paths
            continue
        if name.endswith(".npz"):
            a, b = np.load(tmp / "jax" / name, allow_pickle=True), \
                np.load(tmp / "port" / name, allow_pickle=True)
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert str(a[k].tolist()) == str(b[k].tolist()), (name, k)
        else:
            assert filecmp.cmp(tmp / "jax" / name, tmp / "port" / name, shallow=False), name


def test_yolo_check_matches_jax(yolo_runs):
    got, text, _, losses, again = yolo_runs
    m = re.search(r"box fitness: (\S+)\s+mask fitness: (\S+)", text)
    want = float(m.group(1)), float(m.group(2))
    assert want[0] > 0.1 and want[1] > 0.1                  # the trained weights find boxes
    assert abs(got[0] - want[0]) <= 2e-4 and abs(got[1] - want[1]) <= 2e-4, (got, want)
    assert (again["box_fitness"], again["mask_fitness"]) == got and again["losses"] == []
    assert [i for i, _ in losses] == [0, YOLO_STEPS - 1] and losses[-1][1] < losses[0][1]
    assert not again["ok"] and "FAIL" in text
