"""PyTorch port: ``parallel/mesh.py``'s ``shard_params_tp`` (port of
``hd_yolo_tpu/parallel/mesh.py:75-102``) and the step on a (data, model)
``DeviceMesh``, on the CPU with gloo.

* The placement against JAX's, leaf by leaf: JAX's ``shard_params_tp`` on a
  (4, 2) mesh of its 8 virtual CPU devices places the parameters of
  ``yolov5s-test`` (at ``min_size`` 1 << 12 and the default 1 << 16) and of
  ``tests/test_torch_hnet.py``'s small hnet (1 << 12: its linear layers,
  relative-position tables and the mask head's transposed conv); each leaf
  is filled with its index along the last axis where JAX shards it (the
  flax layout puts the out channels last) and with 0 elsewhere, and carried
  to the port's names and layout by ``utils/convert.py``.  The port's
  ``tp_placement`` with 2 model ranks must shard exactly the tensors that
  came out nonzero, on the one axis along which their values vary.
* The step: two processes (``tests/torch_parallel_workers.py``, case
  ``mesh``, a global batch of 4 at 128 px with masks, ``yolov5s-test``'s
  weights from seeded numpy), one ``make_mesh_train_step`` micro-step on a
  (2, 1) mesh (pure data parallel) and one on a (1, 2) mesh (each weight
  of at least 1 << 12 elements sharded on its out channels over the model
  axis, every rank on the whole batch), each beside the same step with
  every parameter whole on the same mesh (``make_train_step`` over its
  ``data`` group).  Between steps each rank holds only its shard of a
  sharded weight.  The placement changes no number: each placed step equals
  its whole-parameter step bit for bit, on both ranks.  The (1, 2) step
  against the (2, 1) one, which splits the batch over two data ranks: the
  loss items within 1e-6 relative; the parameters after the update within
  ``tests/test_torch_parallel.py``'s tolerance of the update (1e-3 of each
  tensor's largest change, 2e-2 in the mask branch, plus 1e-6 of its
  weights), since the two sum their BatchNorm statistics and gradients in
  another order, which the fresh model's first update amplifies: a
  1e-6-relative bound on the parameters does not hold (the first BatchNorm
  bias differs by 6.7e-6, 4.7e-5 of its largest value).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.hnet import HNet as JaxHNet
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.parallel import create_mesh as jax_create_mesh
from hd_yolo_tpu.parallel.mesh import shard_params_tp as jax_shard_params_tp
from hd_yolo_tpu_torch import parallel
from hd_yolo_tpu_torch.hnet import HNet
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import hnet_state_dict_from_flax, state_dict_from_flax
from test_torch_hnet import CFG as HNET_CFG
from test_torch_hnet import X_SHAPE as HNET_X
from test_torch_parallel import (B, MASK_TENSORS, R, SIZE, WORKER, _env, _run, _torch_tree,
                                 make_global_batch)
from torch_port_common import random_variables

MIN_SIZE = 1 << 12


def jax_marks(params, min_size):
    """Each leaf: its index along the last axis (+1) where JAX's placement
    shards it over ``model``, else 0."""
    mesh = jax_create_mesh((4, 2))
    placed = jax_shard_params_tp(params, mesh, min_size)

    def mark(x, p):
        if any(s is not None for s in x.sharding.spec):
            assert x.sharding.spec[-1] == "model" and all(s is None for s in x.sharding.spec[:-1])
            return np.broadcast_to(np.arange(1, p.shape[-1] + 1, dtype=np.float32),
                                   p.shape).copy()
        return np.zeros(p.shape, np.float32)

    return jax.tree.map(mark, placed, params)


def check_placement(place, marks, params):
    sharded = 0
    for name, p in params:
        m = marks[name].numpy()
        ax = place[name]
        if ax is None:
            assert not m.any(), name
            continue
        sharded += 1
        ref = m
        for d in range(m.ndim):
            if d != ax:
                ref = ref.take([0], axis=d)
        assert (m == ref).all() and np.unique(ref).size == m.shape[ax] > 1, (name, ax)
    return sharded


@pytest.mark.parametrize("min_size", [MIN_SIZE, 1 << 16])
def test_yolo_placement_matches_jax(min_size):
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei")
    v = random_variables(jm, (1, SIZE, SIZE, 3), seed=1)
    tm = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    marks = state_dict_from_flax({"params": jax_marks(v["params"], min_size),
                                  "batch_stats": v["batch_stats"]}, tm.spec)
    place = parallel.tp_placement(tm, 2, min_size)
    assert set(place) == {n for n, _ in tm.named_parameters()}
    n = check_placement(place, marks, tm.named_parameters())
    assert n > (10 if min_size == MIN_SIZE else 0)
    deconv = [k for k in place if k.endswith("conv5_mask.weight")]
    assert deconv and all(place[k] == 1 for k in deconv)      # ConvTranspose2d: (in, out, kh, kw)


def test_hnet_placement_matches_jax():
    jm = JaxHNet.from_cfg(HNET_CFG)
    v = random_variables(jm, HNET_X, seed=0)
    tm = HNet(HNET_CFG, device="cpu")
    marks = hnet_state_dict_from_flax({"params": jax_marks(v["params"], MIN_SIZE)}, HNET_CFG)
    place = parallel.tp_placement(tm, 2, MIN_SIZE)
    assert check_placement(place, marks, tm.named_parameters()) > 10
    kinds = {type(m).__name__ for name, m in tm.named_modules()
             if any(place.get(f"{name}.{p}") is not None for p, _ in m.named_parameters(recurse=False))}
    assert {"Conv2d", "Linear", "ConvTranspose2d"} <= kinds
    assert parallel.tp_placement(tm, 1, MIN_SIZE) == {n: None for n in place}


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    io = tmp_path_factory.mktemp("mesh")
    hyp = jax_load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    jm = JaxModel.from_cfg("yolov5s-test", hyp, mask_rois=R)
    variables = random_variables(jm, (B, SIZE, SIZE, 3), seed=1)
    tm = Model.from_cfg("yolov5s-test", hyp, mask_rois=R)
    x, t = make_global_batch()
    sd = state_dict_from_flax(variables, tm.spec)
    torch.save({"hyp": hyp, "mask_rois": R, "state_dict": sd, "batch": _torch_tree(x, t),
                "min_size": MIN_SIZE, "shapes": [(2, 1), (1, 2)]}, io / "mesh_in.pt")
    cmds = [[sys.executable, WORKER, "--cases", "mesh", "--rank", str(r), "--world", "2",
             "--store", str(io / "store"), "--io", str(io)] for r in range(2)]
    _run(cmds, [_env(), _env()])
    return {"ranks": [torch.load(io / f"mesh_out_{r}.pt", weights_only=False) for r in range(2)],
            "place": parallel.tp_placement(tm, 2, MIN_SIZE), "init": sd}


def test_mesh_ranks_hold_their_shards(mesh_steps):
    place, init = mesh_steps["place"], mesh_steps["init"]
    assert sum(a is not None for a in place.values()) > 10
    for out in mesh_steps["ranks"]:
        for name, ax in place.items():
            whole = tuple(init[name].shape)
            assert out[(2, 1)]["held"][name] == out[(2, 1)]["after"][name] == whole
            want = whole if ax is None else whole[:ax] + (whole[ax] // 2,) + whole[ax + 1:]
            assert out[(1, 2)]["held"][name] == out[(1, 2)]["after"][name] == want, name


def test_mesh_placement_changes_no_number(mesh_steps):
    for out in mesh_steps["ranks"]:
        for shape in ((2, 1), (1, 2)):
            got = out[shape]
            assert got["metrics"] == got["whole_metrics"], shape
            for name, p in got["whole_params"].items():
                assert torch.equal(got["params"][name], p), (shape, name)
    a, b = mesh_steps["ranks"]
    for shape in ((2, 1), (1, 2)):
        for name in a[shape]["params"]:
            assert torch.equal(a[shape]["params"][name], b[shape]["params"][name]), name


def test_mesh_step_equals_the_data_parallel_step(mesh_steps):
    dp, tp = mesh_steps["ranks"][0][(2, 1)], mesh_steps["ranks"][0][(1, 2)]
    init = mesh_steps["init"]
    assert set(dp["metrics"]) == set(tp["metrics"]) and dp["metrics"]["det/mask"] > 0
    for k, w in dp["metrics"].items():
        assert abs(tp["metrics"][k] - w) <= 1e-6 * abs(w), (k, tp["metrics"][k], w)
    moved = 0
    for name, p in dp["params"].items():
        p0 = init[name].numpy()
        scale = max(float(np.abs(p.numpy() - p0).max()), 1e-12)
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * scale + 1e-6 * np.abs(p0).max()
        np.testing.assert_allclose(tp["params"][name].numpy(), p.numpy(), rtol=0, atol=tol,
                                   err_msg=name)
        moved += int(scale > 1e-6)
    assert moved > 10
