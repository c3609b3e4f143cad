"""PyTorch port: training and slide inference across processes
(``hd_yolo_tpu_torch/parallel/``, ``engines/train_step.py``'s distributed
step, ``engines/train.py`` under torchrun's environment,
``wsi/tiling.slide_inference_sharded``) on the CPU with gloo, against the JAX
package.

* The loader: ``DataLoader(shard=(rank, world))`` slices are disjoint,
  cover each epoch and equal JAX's ``_epoch_indices`` for the same seed,
  rank and world.
* Two processes (``tests/torch_parallel_workers.py``, a ``FileStore`` under
  ``tmp_path``, a 60 s group timeout and a 120 s process timeout), each on
  half of a global batch of 4 (``yolov5s-test`` at 128 px, f32, masks on,
  weights from seeded numpy through ``utils/convert.py``):

  - one ``make_train_step(distributed=True)`` micro-step against JAX's
    ``make_train_step`` on the whole batch, at
    ``tests/test_torch_train_step.py``'s tolerances: loss items rtol 1e-4,
    BatchNorm running statistics atol 1e-5, parameters and EMA after the
    update within 1e-3 of the update's largest entry (2e-2 in the mask
    branch) plus 1e-6 of the weights'; both ranks' parameters, EMA and
    statistics bit-identical;
  - the device recipe of that step (mixup on): each rank's rows equal the
    one-process recipe's rows of the global batch (atol 1e-6);
  - ``slide_inference_sharded`` at world 2 (4 tiles a rank a batch) against
    JAX's on its 8 virtual CPU devices (1 a device), with the per-image
    mask branch and with the packed one at a budget of 12 ROIs a call,
    which the 8-tile calls' eligible detections exceed (JAX ranks them
    with one ``top_k`` over the global batch; the port over every rank's
    scores, each rank pooling its own), at
    ``tests/test_torch_detector_slide.py``'s tolerances: labels, validity
    and mask flags equal, boxes and scores atol 1e-3, masks atol 1e-4.
* The train CLI at world 2 (torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT``, a port bound to 0): one epoch on 4
  images writes its files from rank 0 only, then ``--resume
  --cache-device`` restores on both ranks, falls back to the streaming
  loader with a warning and runs a second epoch (the device recipe across
  ranks).
* NCCL without a card raises; no environment, no group.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.data.dataset import DataLoader as JaxDataLoader
from hd_yolo_tpu.engines import optim as joptim
from hd_yolo_tpu.engines.train_step import TrainState as JaxTrainState
from hd_yolo_tpu.engines.train_step import make_train_step as jax_make_train_step
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.parallel import create_mesh
from hd_yolo_tpu.wsi import slide_inference_sharded as jax_slide_inference_sharded
from hd_yolo_tpu_torch import parallel
from hd_yolo_tpu_torch.data.dataset import DataLoader
from hd_yolo_tpu_torch.data.device_augment import apply_augment, make_device_augment
from hd_yolo_tpu_torch.engines.train_step import augment_rng
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_train import make_dataset
from torch_port_common import random_variables

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_workers.py")
SIZE, B, T, R = 128, 4, 16, 4
MASK_TENSORS = ("headers.det.seg.", "headers.det.seg_h.")
SLIDE_KW = dict(max_masks=8, pre_nms_topk=256)          # the per-image mask branch
PACKED_KW = dict(SLIDE_KW, mask_budget=12, mask_window=16)   # the packed one, 12 ROIs a call
PROC_TIMEOUT = 120


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(cmds, envs):
    """Start every rank's process, wait for all (``PROC_TIMEOUT`` each), kill
    the rest on a failure; raise with the output of a failed rank."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- the loader
class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,world,bs,drop_last", [(10, 2, 2, True), (11, 3, 2, True),
                                                  (7, 2, 3, False), (16, 4, 4, True)])
def test_loader_shards_match_jax(n, world, bs, drop_last):
    ds = _Sized(n)
    seen = []
    for epoch in (0, 1):
        idx_all = []
        for rank in range(world):
            got = DataLoader(ds, bs, shuffle=True, drop_last=drop_last, seed=5,
                             shard=(rank, world))._epoch_indices(epoch)
            want = JaxDataLoader(ds, bs, shuffle=True, drop_last=drop_last, seed=5,
                                 shard=(rank, world))._epoch_indices(epoch)
            assert got == want
            assert len(DataLoader(ds, bs, drop_last=drop_last, shard=(rank, world))) == \
                len(JaxDataLoader(ds, bs, drop_last=drop_last, shard=(rank, world)))
            idx_all += got
        assert len(idx_all) == len(set(idx_all))            # disjoint
        if not drop_last:
            assert sorted(idx_all) == list(range(n))        # exhaustive
        seen.append(idx_all)
    assert seen[0] != seen[1]                               # each epoch reshuffles


# ------------------------------------------------- world 2: step, recipe, slide
def make_global_batch(seed: int = 20):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    xy = rng.uniform(0.05, 0.8, (B, T, 2))
    wh = rng.uniform(0.05, 0.2, (B, T, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32)
    valid = np.zeros((B, T), bool)
    for b, k in enumerate((11, 7, 16, 3)):
        valid[b, :k] = True
    labels = rng.integers(0, 5, (B, T)).astype(np.int64)
    yy, xx = np.mgrid[0:28, 0:28] + 0.5
    rad = rng.uniform(6, 13, (B, T, 1, 1))
    masks = (((yy - 14) ** 2 + (xx - 14) ** 2) < rad ** 2).astype(np.float32)
    return x, {"boxes": boxes, "labels": labels, "masks": masks, "valid": valid}


def _torch_tree(x, t):
    return {"image": torch.from_numpy(x),
            "targets": {"det": {k: torch.from_numpy(v) for k, v in t.items()}}}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX references and the two ranks' results of one launch."""
    io = tmp_path_factory.mktemp("world2")
    hyp = jax_load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    jm = JaxModel.from_cfg("yolov5s-test", hyp, mask_rois=R)
    variables = random_variables(jm, (B, SIZE, SIZE, 3), seed=1)
    tm = Model.from_cfg("yolov5s-test", hyp, mask_rois=R)
    x, t = make_global_batch()
    torch.save({"hyp": hyp, "mask_rois": R, "state_dict": state_dict_from_flax(variables, tm.spec),
                "batch": _torch_tree(x, t)}, io / "step_in.pt")

    aug_hyp = {**jax_load_cfg("hyp-nuclei"), "mixup": 1.0}
    rng = np.random.default_rng(3)
    S = 64
    xs = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    tb = rng.uniform(0.1, 0.5, (B, 8, 2)).astype(np.float32)
    traw = {"boxes": np.concatenate([tb, tb + 0.3], -1), "labels": rng.integers(1, 4, (B, 8)),
            "masks": (rng.uniform(0, 1, (B, 8, 28, 28)) > 0.5).astype(np.float32),
            "valid": rng.uniform(0, 1, (B, 8)) > 0.3, "active": np.ones(B, bool)}
    aug_batch = _torch_tree(xs, traw)
    torch.save({"hyp": aug_hyp, "batch": aug_batch, "seed": 3, "step": 5}, io / "augment_in.pt")

    jslide = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", dtype=jnp.float32, **SLIDE_KW)
    svars = random_variables(jslide, (1, SIZE, SIZE, 3), seed=3, obj_bias=-1.0)
    slide = np.random.default_rng(7).integers(0, 256, (200, 330, 3)).astype(np.uint8)
    skw = dict(tile=SIZE, overlap=64)
    sm = Model.from_cfg("yolov5s-test", "hyp-nuclei", **SLIDE_KW)
    torch.save({"model_kw": SLIDE_KW, "state_dict": state_dict_from_flax(svars, sm.spec),
                "slide": torch.from_numpy(slide), "batch_per_device": 4, "kw": skw},
               io / "slide_in.pt")
    torch.save({"model_kw": PACKED_KW, "state_dict": state_dict_from_flax(svars, sm.spec),
                "slide": torch.from_numpy(slide), "batch_per_device": 4, "kw": skw},
               io / "packed_in.pt")

    store = io / "store"
    cmds = [[sys.executable, WORKER, "--cases", "step,augment,slide,packed", "--rank", str(r),
             "--world", "2", "--store", str(store), "--io", str(io)] for r in range(2)]
    _run(cmds, [_env(), _env()])
    outs = {c: [torch.load(io / f"{c}_out_{r}.pt", weights_only=False) for r in range(2)]
            for c in ("step", "augment", "slide", "packed")}

    # JAX: the whole batch's step, the one-process recipe, the 8-device slide
    tx = joptim.build_optimizer(variables["params"], hyp, 2, 8, accumulate=1)
    jstate, jmet = jax_make_train_step(jm, tx, mask_weight=1.0)(
        JaxTrainState.create(variables, tx),
        {"image": jnp.asarray(x), "targets": {"det": {k: jnp.asarray(v) for k, v in t.items()}}})
    fn = make_device_augment(aug_hyp, k_mosaic=2)
    whole = apply_augment(aug_batch, {k: torch.from_numpy(np.asarray(v)) for k, v in
                                      fn.draw(augment_rng(3, 5), B, S).items()})
    fwd = jax.jit(lambda tiles: jslide.apply(svars, tiles, train=False)[1]["det"])
    jout = jax_slide_inference_sharded(fwd, jnp.asarray(slide), create_mesh(),
                                       batch_per_device=1, **skw)
    jpacked = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", dtype=jnp.float32, **PACKED_KW)
    fwd_p = jax.jit(lambda tiles: jpacked.apply(svars, tiles, train=False)[1]["det"])
    jout_p = jax_slide_inference_sharded(fwd_p, jnp.asarray(slide), create_mesh(),
                                         batch_per_device=1, **skw)
    return {"variables": variables, "tm": tm, "jstate": jax.tree.map(np.asarray, jstate),
            "jmet": {k: float(v) for k, v in jmet.items()}, "whole": whole, "jslide": jout,
            "jpacked": jout_p, "outs": outs}


def _flax(tree, variables, tm, stats=None):
    return state_dict_from_flax({"params": tree, "batch_stats": stats or variables["batch_stats"]},
                                tm.spec)


def test_world2_step_matches_jax_whole_batch(world2):
    ranks, variables, tm, js = world2["outs"]["step"], world2["variables"], world2["tm"], \
        world2["jstate"]
    got = ranks[0]
    assert got["step"] == 1 and got["ema_updates"] == int(js.ema.updates) == 1
    assert set(world2["jmet"]) == set(got["metrics"])
    for k, w in world2["jmet"].items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-4, err_msg=k)
    assert world2["jmet"]["det/mask"] > 0
    want_s = _flax(variables["params"], variables, tm, js.batch_stats)
    init = state_dict_from_flax(variables, tm.spec)
    moved = 0
    for name, buf in got["buffers"].items():
        np.testing.assert_allclose(buf.numpy(), want_s[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        moved += int(np.abs(buf.numpy() - init[name].numpy()).max() > 1e-6)
    assert moved > 10
    want_p, want_e = _flax(js.params, variables, tm), _flax(js.ema.params, variables, tm)
    changed = 0
    for name, p in got["params"].items():
        p0 = init[name].numpy()
        scale = max(np.abs(want_p[name].numpy() - p0).max(), 1e-12)
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * scale + 1e-6 * np.abs(p0).max()
        np.testing.assert_allclose(p.numpy(), want_p[name].numpy(), rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(got["ema"][name].numpy(), want_e[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)
        changed += int(scale > 1e-6)
    assert changed > 10


def test_world2_ranks_hold_identical_state(world2):
    a, b = world2["outs"]["step"]
    assert a["metrics"] == b["metrics"]
    for key in ("params", "ema", "buffers"):
        assert set(a[key]) == set(b[key])
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def _tree_rows(tree, lo, hi):
    return {k: _tree_rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi] for k, v in tree.items()}


def test_world2_device_recipe_rows_equal_the_global_recipe(world2):
    whole = world2["whole"]
    n = B // 2
    for r, got in enumerate(world2["outs"]["augment"]):
        want = _tree_rows(whole, r * n, (r + 1) * n)
        np.testing.assert_allclose(got["image"].numpy(), want["image"].numpy(), rtol=0, atol=1e-6)
        for k, w in want["targets"]["det"].items():
            g = got["targets"]["det"][k]
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert int(whole["targets"]["det"]["valid"].sum()) > 0


def test_world2_sharded_slide_matches_jax(world2):
    check_sharded_slide(world2, "slide")


def test_world2_packed_sharded_slide_matches_jax(world2):
    check_sharded_slide(world2, "packed")


def check_sharded_slide(world2, branch):
    want = {k: np.asarray(v) for k, v in world2["jslide" if branch == "slide" else
                                             "jpacked"].items()}
    a, b = world2["outs"][branch]
    assert set(a) == set(want)
    for k in a:                                   # every rank stitches the same result
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    got = {k: np.asarray(v) for k, v in a.items()}
    assert want["valid"].sum() > 8
    for k in ("valid", "labels", "mask_valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    v = want["valid"]
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"][v], want["masks"][v], rtol=0, atol=1e-4)
    if branch == "packed":
        # the budget binds: the packed branch keeps fewer masks than the
        # per-image one on the same detections
        per_image = np.asarray(world2["jslide"]["mask_valid"])
        assert 0 < want["mask_valid"].sum() < per_image.sum()


# ------------------------------------------------------- the CLI at world 2
def _cli(tmp_path, data, save_dir, extra):
    io = tmp_path / f"cli{len(list(tmp_path.glob('cli*')))}"
    io.mkdir()
    argv = ["--data", data, "--cfg", "yolov5s-test", "--hyp", "hyp-nuclei", "--device", "cpu",
            "--batch-size", "4", "--nominal-batch-size", "4", "--img-size", "64",
            "--patch-size", "64", "--masks", "--no-bf16", "--workers", "1", "--max-targets", "8",
            "--mask-rois", "2", "--max-masks", "4", "--save-dir", save_dir,
            "--dist-timeout", "60", *extra]
    (io / "cli_args.json").write_text(json.dumps(argv))
    port = str(_free_port())
    envs = []
    for r in range(2):
        e = _env()
        e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        envs.append(e)
    _run([[sys.executable, WORKER, "--cases", "cli", "--io", str(io)]] * 2, envs)
    return [json.loads((io / f"cli_out_{r}.json").read_text()) for r in range(2)]


def test_train_cli_world2_rank0_writes_and_both_resume(tmp_path):
    data = make_dataset(tmp_path, n_images=4)
    save_dir = str(tmp_path / "run")
    r0, r1 = _cli(tmp_path, data, save_dir, ["--epochs", "1"])
    assert r1["writes"] == [] and r0["restores"] == r1["restores"] == []
    assert {w[0] for w in r0["writes"]} == {"Loggers", "save_cfg", "torch.save"}
    assert {w[1] for w in r0["writes"] if w[0] == "torch.save"} == \
        {"last.pt.tmp", "best.pt.tmp", "final.pt"}
    assert r0["result"]["save_dir"] == r1["result"]["save_dir"] == save_dir
    assert r0["group_left"] and r1["group_left"]
    for name in ("last.pt", "best.pt", "final.pt", "hyp.yaml", "results.json"):
        assert os.path.isfile(os.path.join(save_dir, name)), name
    saved = torch.load(os.path.join(save_dir, "last.pt"), weights_only=False)
    assert int(saved["step"]) == 1          # 4 images, a global batch of 4

    r0, r1 = _cli(tmp_path, data, save_dir, ["--epochs", "2", "--resume", "--cache-device"])
    for rr in (r0, r1):
        assert [x[0] for x in rr["restores"]] == ["restore_train_state"]
        assert any("--cache-device is single-process" in w for w in rr["warnings"])
    assert r1["writes"] == [] and r0["writes"]
    rows = [json.loads(line) for line in open(os.path.join(save_dir, "results.json"))]
    assert [row["epoch"] for row in rows] == [0, 1]
    saved = torch.load(os.path.join(save_dir, "last.pt"), weights_only=False)
    assert int(saved["step"]) == 2 and int(saved["opt"]["count"]) == 2


# ------------------------------------------------------------- the group
def test_nccl_without_a_card_raises_and_no_env_makes_no_group(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.maybe_initialize_distributed("cuda") == (0, 1)
    assert not parallel.is_initialized() and parallel.world_size() == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            parallel.maybe_initialize_distributed("cuda")
    assert not parallel.is_initialized()
    assert parallel.auto_mesh(8, 4) == 4
    with pytest.raises(ValueError, match="does not split"):
        parallel.auto_mesh(6, 4)
    b = {"image": torch.arange(8).reshape(4, 2), "t": {"v": np.arange(4)}}
    part = parallel.local_slice(b, 1, 2)
    assert part["image"].tolist() == [[4, 5], [6, 7]] and part["t"]["v"].tolist() == [2, 3]

