"""PyTorch port: ``hd_yolo_tpu_torch/engines/evaluate.py`` and the inference
checkpoints of ``engines/checkpoint.py`` against the JAX package, on the
same seeded numpy weights (``yolov5s-test``, f32 on the CPU).

* ``inference_on_loader``: the same per-image records as JAX's (boxes in
  the original frames and scores to 1e-3, labels and ``has_mask`` equal,
  masks to 1e-4, as ``test_torch_slice.py`` holds the forward);
* ``run``: writes ``<name>_results.pkl`` and ``<name>_stats.json`` as JAX's
  does, reuses them only when both exist, recomputes under ``force``;
* ``export``: the ``torch.export`` program saved and loaded on the CPU
  equals the eager forward exactly on another input;
* an orbax ``save_inference`` directory of the JAX package reaches the port
  through a ``.pt`` (JAX ``load_inference`` → ``state_dict_from_flax`` →
  the port's ``save_inference``) and the two forwards agree;
* the custom ops' fake implementations give the shapes and dtypes of the
  plain versions' outputs (meta tensors: the kernels themselves run only on
  the card, ``tests/test_torch_kernels_gpu.py``).
"""

import json
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.engines import evaluate as jeval
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.detector import Detector
from hd_yolo_tpu_torch.engines import checkpoint, evaluate
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

SIZE = 128
X_SHAPE = (2, SIZE, SIZE, 3)
KW = dict(max_masks=16, pre_nms_topk=64)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX model, weights and jitted forward (``build_model``'s form,
    compiled once), and the same weights as the port's ``.pt``."""
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei", **KW)
    variables = random_variables(jm, X_SHAPE, seed=2, obj_bias=1.0)
    fwd = jax.jit(lambda v, x, compute_masks: jm.apply(v, x, train=False,
                                                       compute_masks=compute_masks)[1],
                  static_argnames=("compute_masks",))
    tm = Model.from_cfg("yolov5s-test", "hyp-nuclei", **KW)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec))
    path = str(tmp_path_factory.mktemp("w") / "model.pt")
    checkpoint.save_inference(path, tm)
    return jm, variables, fwd, path


def loader(seed=0):
    """Two batches of 2 uint8 tiles at 160 px (resized to 128 on the way in)
    with their original sizes."""
    rng = np.random.default_rng(seed)
    for sizes in ([(300, 200), (160, 160)], [(128, 96), (500, 700)]):
        yield rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8), sizes


def compare_records(got, want):
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"det"}
        g, w = g["det"], w["det"]
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["has_mask"], w["has_mask"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["masks"], w["masks"], rtol=0, atol=1e-4)
        n += len(g["boxes"])
    assert n > 0


def test_inference_on_loader_matches_jax(models):
    jm, variables, fwd, path = models
    want = jeval.inference_on_loader(fwd, variables, loader(), input_size=SIZE)
    _, tfwd = evaluate.build_model("yolov5s-test", "hyp-nuclei", path, dtype=torch.float32,
                                   device="cpu", **KW)
    got = evaluate.inference_on_loader(tfwd, loader(), input_size=SIZE, device="cpu")
    compare_records(got["outputs"], want["outputs"])
    assert got["time_per_image"] > 0
    one = evaluate.inference_on_loader(tfwd, loader(), input_size=SIZE, task="det", device="cpu")
    compare_records(one["outputs"], want["outputs"])


def test_run_caches_as_jax_does(models, tmp_path, monkeypatch):
    jm, variables, fwd, path = models
    monkeypatch.setattr(jeval, "build_model", lambda *a, **k: (jm, variables, fwd))
    exp = {"small": {"cfg": "yolov5s-test", "hyp": "hyp-nuclei", "weights": path,
                     "model_kwargs": dict(dtype=torch.float32, **KW)}}
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    want = jeval.run(exp, loader, output_dir=str(jax_dir), input_size=SIZE)
    got = evaluate.run(exp, loader, output_dir=str(port_dir), input_size=SIZE, device="cpu")
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == [
        "small_results.pkl", "small_stats.json"]
    assert set(got["small"]) == set(want["small"])
    assert got["small"]["n_images"] == want["small"]["n_images"] == 4
    with open(port_dir / "small_results.pkl", "rb") as f, open(jax_dir / "small_results.pkl",
                                                                "rb") as g:
        compare_records(pickle.load(f), pickle.load(g))

    # a hit needs both files; it returns the stored stats without a forward
    stats_file = port_dir / "small_stats.json"
    stats_file.write_text(json.dumps({**got["small"], "marker": 1}))
    assert evaluate.run(exp, loader, output_dir=str(port_dir), input_size=SIZE,
                        device="cpu")["small"]["marker"] == 1
    assert "marker" not in evaluate.run(exp, loader, output_dir=str(port_dir), input_size=SIZE,
                                        device="cpu", force=True)["small"]
    stats_file.unlink()
    again = evaluate.run(exp, loader, output_dir=str(port_dir), input_size=SIZE, device="cpu")
    assert again["small"]["n_images"] == 4 and stats_file.exists()


def test_export_round_trip_equals_eager(models, tmp_path):
    _, _, _, path = models
    model, fwd = evaluate.build_model("yolov5s-test", "hyp-nuclei", path, dtype=torch.float32,
                                      device="cpu", **KW)
    out_path = evaluate.export(model, X_SHAPE, str(tmp_path / "model.pt2"))
    program = evaluate.load_exported(out_path)
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 256, X_SHAPE, dtype=np.uint8))
    want = fwd(x)
    got = program(x)
    assert set(got) == set(want) == {"det"}
    assert set(got["det"]) == set(want["det"])
    for k, v in want["det"].items():
        assert torch.equal(got["det"][k], v), k
    assert int(want["det"]["valid"].sum()) > 0 and int(want["det"]["mask_valid"].sum()) > 0


def test_orbax_checkpoint_reaches_the_port(models, tmp_path):
    """JAX ``save_inference`` (orbax) → JAX ``load_inference`` →
    ``state_dict_from_flax`` → the port's ``save_inference`` (.pt) →
    ``Detector(weights=...)``: the forwards agree."""
    from hd_yolo_tpu.engines import checkpoint as jckpt

    jm, variables, fwd, _ = models
    state = SimpleNamespace(ema=SimpleNamespace(params=variables["params"]),
                            params=variables["params"], batch_stats=variables["batch_stats"])
    jckpt.save_inference(str(tmp_path / "orbax"), state)
    restored = jax.tree.map(np.asarray, jckpt.load_inference(str(tmp_path / "orbax")))
    model = Model.from_cfg("yolov5s-test", "hyp-nuclei", **KW)
    model.load_state_dict(state_dict_from_flax(restored, model.spec))
    pt = checkpoint.save_inference(str(tmp_path / "from_orbax.pt"), model)
    det = Detector("yolov5s-test", "hyp-nuclei", weights=pt, input_size=SIZE,
                   dtype=torch.float32, device="cpu", **KW)
    x = np.random.default_rng(6).uniform(0, 1, X_SHAPE).astype(np.float32)
    want = jax.tree.map(np.asarray, fwd(restored, jnp.asarray(x), compute_masks=True))["det"]
    got = det.tiles(x)["det"]
    for k in ("valid", "labels", "levels", "mask_valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0, atol=1e-4)
    assert want["valid"].sum() > 0
    # the port's .pt also loads through load_inference into a fresh model
    again = checkpoint.load_inference(pt, Model.from_cfg("yolov5s-test", "hyp-nuclei", **KW))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_custom_op_fakes_match_the_plain_shapes():
    """Each kernel's custom op on meta tensors (its fake implementation)
    gives the shape and dtype of its plain version's output."""
    from hd_yolo_tpu_torch.models.detect_head import MaskHead
    from hd_yolo_tpu_torch.ops import pallas_mask_head as pm
    from hd_yolo_tpu_torch.ops import pallas_nms as pn
    from hd_yolo_tpu_torch.ops import pallas_roi_align as pr
    from hd_yolo_tpu_torch.ops import pallas_stem as ps

    ops = torch.ops.hd_yolo_tpu_torch

    def meta(t):
        return torch.empty_like(t, device="meta")

    def same(got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]

    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 20, 24, 3), generator=g)
    w = torch.randn((6, 6, 3, 16), generator=g)
    s, b = torch.rand(16, generator=g), torch.randn(16, generator=g)
    same(ops.stem_tc(meta(x), meta(w), meta(s), meta(b)),
         ps.stem_conv_plain(x, w, s, b, stride=2, padding=2, out_dtype=torch.bfloat16))
    for out_dtype in (torch.float32, torch.bfloat16):
        same(ops.stem(meta(x), meta(w), meta(s), meta(b), 2, 2, out_dtype == torch.bfloat16),
             ps.stem_conv_plain(x, w, s, b, stride=2, padding=2, out_dtype=out_dtype))

    xy = torch.rand((3, 50, 2), generator=g) * 100
    boxes = torch.cat([xy, xy + 10], -1)
    valid = torch.rand((3, 50), generator=g) > 0.3
    same(ops.nms_keep(meta(boxes), meta(valid), 0.45, 20),
         pn.nms_keep_sorted_plain(boxes, valid, 0.45, 20))

    levels = [torch.randn((2, 16 >> i, 16 >> i, 8), generator=g).to(torch.bfloat16)
              for i in range(2)]
    K, M, n = 5, 7, 2
    rmeta = torch.zeros((K, 4), dtype=torch.int32)
    ys, xs = torch.rand((K, M * n), generator=g) * 8, torch.rand((K, M * n), generator=g) * 8
    bounds = torch.tensor([[0.0, 16.0, 0.0, 16.0]]).repeat(K, 1)
    active = torch.tensor(3)
    same(ops.roi_align_bounded([meta(f) for f in levels], meta(rmeta), meta(ys), meta(xs),
                               meta(bounds), 16, 16, M, n, meta(active)),
         pr.roi_align_bounded_plain(levels, rmeta, ys, xs, bounds, (16, 16), M, n, active))

    head = MaskHead(3, 256)
    pooled = torch.randn((2, 14, 14, 256), generator=g).to(torch.bfloat16)
    labels = torch.tensor([0, 2])
    wf, bf, wd, bd = pm.kernel_weights(head)
    stream = pm.mask_head_stream(wf, wd)
    wl = head.maskrcnn_preds.mask_fcn_logits.weight[:, :, 0, 0].to(torch.bfloat16)
    bl = head.maskrcnn_preds.mask_fcn_logits.bias.float()
    same(ops.mask_head(*(meta(t.detach()) for t in (pooled, stream, bf, bd, wl, bl, labels)),
                       None),
         pm.fused_mask_probs_plain(head, pooled, labels))
