"""PyTorch port: the training CLI's device data path and the rest of its
flags (``hd_yolo_tpu_torch/engines/train.py``) on the CPU at a tiny size,
on ``test_torch_train.py``'s synthetic set and arguments:
``--device-augment`` with ``--multi-scale`` and ``--cache-device`` with
``--batch-size -1`` (the fallback off the card) and ``--autoanchor`` each
training an epoch, a resident micro-step equal to a streamed one on the
same rows and draws, the multi-scale resize against ``jax.image.resize``,
``--evolve``'s files, raw samples cached whole, and a reference checkpoint
fixture as ``--weights`` (by path, and by bare name through
``$HD_YOLO_WEIGHTS_DIR``) with ``--plots`` for an epoch of ``tiny2l``.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch
import yaml

from hd_yolo_tpu_torch.engines.train import main, multi_scale_sizes
from hd_yolo_tpu_torch.models.yolo import Model
from test_torch_train import args, make_dataset


@pytest.mark.parametrize("flags", [["--device-augment", "--multi-scale"],
                                   ["--cache-device", "--batch-size", "-1", "--autoanchor"]],
                         ids=["device-augment-multi-scale", "cache-device-autobatch-autoanchor"])
def test_device_recipe_flags_train_an_epoch(tmp_path, caplog, flags):
    data = make_dataset(tmp_path)
    save_dir = str(tmp_path / "run")
    with caplog.at_level("INFO", logger="hd_yolo_tpu_torch"):
        result = main(args(data, save_dir, "--epochs", "1", *flags))
    assert os.path.isfile(os.path.join(save_dir, "last.pt"))
    saved = torch.load(os.path.join(save_dir, "last.pt"), weights_only=False)
    assert int(saved["step"]) == 2                     # 4 tiles at batch 2
    rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    assert "device augmentation: the recipe runs inside the train step" in caplog.text
    if "--cache-device" in flags:
        assert result["resident_upload"]["images"] == 4
        assert "device-resident dataset: 4 images" in caplog.text
        assert "autobatch: no memory stats on cpu; using fallback 2" in caplog.text
        assert "autobatch: batch_size=2" in caplog.text
        assert "autoanchor: BPR=" in caplog.text
    else:
        assert "multi-scale buckets: [64, 96, 128, 160, 192]" in caplog.text


def test_resident_step_equals_streamed_step():
    """The same rows and draws give the same update whether the batch is
    gathered from the resident set or streamed."""
    import copy

    from hd_yolo_tpu_torch.data.dataset import collate_padded
    from hd_yolo_tpu_torch.data.device_augment import make_device_augment
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device

    rng = np.random.default_rng(3)
    T, size = 8, 64
    samples = []
    for _ in range(4):
        xy = rng.uniform(0, 0.6, (T, 2))
        samples.append({"image": rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                        "targets": {"det": {
                            "boxes": np.concatenate([xy, xy + 0.35], -1).astype(np.float32),
                            "labels": rng.integers(1, 5, T),
                            "masks": (rng.uniform(0, 1, (T, 28, 28)) > 0.5).astype(np.float32),
                            "valid": rng.uniform(0, 1, T) < 0.7, "active": np.asarray(True)}}})
    hyp = load_hyp()
    model = Model.from_cfg("yolov5s-test", hyp, mask_rois=4, max_masks=8)
    model.init_weights(torch.Generator().manual_seed(0))
    aug = make_device_augment(hyp, k_mosaic=2)
    rows = [2, 0]
    out = []
    for resident in (True, False):
        m = copy.deepcopy(model)
        state = TrainState.create(m, build_optimizer(m, hyp, 1, 1))
        step = make_train_step(seed=5, augment_fn=aug, resident_data=resident)
        if resident:
            _, metrics = step(state, to_device(collate_padded(samples), "cpu"), np.asarray(rows))
        else:
            _, metrics = step(state, to_device(collate_padded([samples[r] for r in rows]), "cpu"))
        out.append((metrics, [p.detach().clone() for p in state.opt.params]))
    (m_res, p_res), (m_str, p_str) = out
    assert set(m_res) == set(m_str) and np.isfinite(float(m_res["loss"]))
    for k in m_res:
        assert torch.equal(m_res[k], m_str[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p_res, p_str))


def load_hyp():
    from hd_yolo_tpu_torch.config import load_cfg
    from hd_yolo_tpu_torch.engines.train import scale_task_hyp
    from hd_yolo_tpu_torch.models.builder import parse_model_cfg

    return scale_task_hyp(load_cfg("hyp-nuclei"), parse_model_cfg("yolov5s-test", None), 64)


@pytest.mark.parametrize("size", [64, 160], ids=["shrink", "enlarge"])
def test_multi_scale_resize_matches_jax_image_resize(size):
    import jax
    import jax.numpy as jnp

    from hd_yolo_tpu_torch.data.preproc import model_input

    assert multi_scale_sizes(128, 32) == [64, 96, 128, 160, 192]
    img = np.random.default_rng(4).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = jax.image.resize(jnp.asarray(img, jnp.float32) / 255.0, (2, size, size, 3),
                            "bilinear")
    got = model_input(torch.from_numpy(img), size, "cpu")
    assert got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_evolve_writes_its_generations(tmp_path):
    data = make_dataset(tmp_path, 2)
    save_dir = str(tmp_path / "evo")
    best = main(args(data, save_dir, "--epochs", "1", "--evolve", "2", "--img-size", "64"))
    rows = list(csv.DictReader(open(os.path.join(save_dir, "evolve", "evolve.csv"))))
    assert [r["generation"] for r in rows] == ["0", "1"]
    assert all("fitness" in r and "lr0" in r for r in rows)
    evolved = yaml.safe_load(open(os.path.join(save_dir, "hyp_evolved.yaml")))
    assert evolved["lr0"] == pytest.approx(best["lr0"])
    gens = [d for d in os.listdir(save_dir) if d.startswith("gen_")]
    assert len(gens) == 2 and all(os.path.isfile(os.path.join(save_dir, g, "last.pt"))
                                  for g in gens)


def test_raw_samples_are_cached_whole(tmp_path):
    """Raw mode with ``cache_images`` caches the padded sample itself, as
    the JAX dataset does; without it every call builds a new one."""
    from hd_yolo_tpu_torch.data.dataset import DetectionDataset

    make_dataset(tmp_path, 2)
    for cache in (True, False):
        ds = DetectionDataset(str(tmp_path / "index.csv"), {"img_size": 128}, train=True,
                              max_targets=16, host_augment=False, cache_images=cache)
        a, b = ds[1], ds[1]
        assert (a is b) == cache
        assert a["image"].shape == (128, 128, 3) and a["image"].dtype == np.uint8
        np.testing.assert_array_equal(a["targets"]["det"]["boxes"], b["targets"]["det"]["boxes"])


FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("fixture,by_name", [("metayolo_tiny", False), ("ultralytics_tiny", True)],
                         ids=["metayolo-path", "ultralytics-bare-name"])
def test_reference_weights_and_plots_train_an_epoch(tmp_path, caplog, monkeypatch, fixture,
                                                    by_name):
    """``--weights`` loads every tensor of the model from a reference
    checkpoint; ``--plots`` writes the JAX package's files: the display
    dumps and ``labels.jpg`` at the start, ``results.png`` at the end."""
    data = make_dataset(tmp_path)
    save_dir = str(tmp_path / "run")
    weights = os.path.join(FIXDIR, f"{fixture}.pt")
    if by_name:
        monkeypatch.setenv("HD_YOLO_WEIGHTS_DIR", FIXDIR)
        weights = f"{fixture}.pt"
    a = args(data, save_dir, "--epochs", "1", "--weights", weights, "--plots")
    a[a.index("yolov5s-test")] = os.path.join(FIXDIR, "tiny2l.yaml")
    with caplog.at_level("INFO", logger="hd_yolo_tpu_torch"):
        main(a)
    n = len(Model.from_cfg(os.path.join(FIXDIR, "tiny2l.yaml"), "hyp-nuclei").state_dict())
    assert f"{fixture}.pt ({n} tensors)" in caplog.text
    files = {os.path.relpath(os.path.join(d, f), save_dir)
             for d, _, fs in os.walk(save_dir) for f in fs}
    assert {"labels.jpg", "results.png", "final.pt"} <= files
    assert {f"display_dataset/val_{i:04d}.png" for i in range(4)} <= files

