"""PyTorch port: the evaluation data path against the JAX package —
``hd_yolo_tpu_torch/data/mask.py`` (the numpy RLE codec and ``Mask``) and
``hd_yolo_tpu_torch/data/dataset.py`` (``DetectionDataset(train=False)``,
``collate_padded``, ``DataLoader``).  Everything is numpy on both sides, so
every comparison is exact."""

import cv2
import numpy as np
import pytest

from hd_yolo_tpu.data import dataset as jds
from hd_yolo_tpu.data import mask as jmask
from hd_yolo_tpu_torch.data import dataset as tds
from hd_yolo_tpu_torch.data import mask as tmask


def assert_tree_equal(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
        assert np.asarray(got).dtype == np.asarray(want).dtype, path


@pytest.mark.parametrize("first_set", [False, True])
def test_rle_codec_equals_jax(rng, first_set):
    """Round trip, and the same runs as the JAX codec (its C++ one when
    ``native/`` is built, else its numpy one), with the first pixel unset
    and set."""
    for shape in [(1, 1), (7, 5), (33, 64)]:
        m = rng.uniform(size=shape) > 0.5
        m[0, 0] = first_set
        rle = tmask.rle_encode(m)
        assert rle == jmask.rle_encode(m)
        assert (rle["counts"][0] == 0) == first_set
        np.testing.assert_array_equal(tmask.rle_decode(rle), m.astype(np.uint8))
        np.testing.assert_array_equal(tmask.rle_decode(rle), jmask.rle_decode(rle))
    empty = np.zeros((4, 6), bool)
    assert tmask.rle_encode(empty) == jmask.rle_encode(empty)


def _as_array(m):
    return np.asarray(m.m) if m.mode == "mask" else m.data


def test_mask_methods_equal_jax():
    """Every ``Mask`` conversion and geometry method, from each mode."""
    size = (40, 50)
    poly = [np.array([[5, 4], [30, 6], [28, 30], [8, 25]], np.float32)]
    pm = np.zeros(size, np.uint8)
    pm[10:20, 12:40] = 1
    matrix = np.array([[1.1, 0.05, -3], [0.02, 0.9, 2], [0, 0, 1]], np.float32)
    for data, mode in ((poly, "poly"), (pm, "mask"), (jmask.rle_encode(pm), "rle")):
        t, j = tmask.Mask(data, size, mode), jmask.Mask(data, size, mode)
        np.testing.assert_array_equal(t.mask().m, j.mask().m)
        assert t.rle().data == j.rle().data
        for a, b in zip(t.poly().data, j.poly().data):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.box(), j.box())
        assert t.area() == j.area()
        for call in (lambda m: m.pad(3, 4, (50, 60)), lambda m: m.crop(-2, 5, 30, 30),
                     lambda m: m.rescale(0.7, 1.3, (28, 65)), lambda m: m.flip(True, True),
                     lambda m: m.flip(horizontal=True), lambda m: m.transpose(),
                     lambda m: m.warp(matrix, (45, 55))):
            a, b = call(t), call(j)
            assert (a.mode, a.size) == (b.mode, b.size)
            if a.mode == "poly":
                for pa, pb in zip(a.data, b.data):
                    np.testing.assert_array_equal(pa, pb)
            else:
                np.testing.assert_array_equal(_as_array(a), _as_array(b))
        for order in (0, 1, 3):
            np.testing.assert_array_equal(t.box_crop(t.box(), 28, order),
                                          j.box_crop(j.box(), 28, order))
    tiny = tmask.Mask(np.ones((3, 3), np.uint8), (10, 10), "mask")
    np.testing.assert_array_equal(tiny.box_crop(np.array([0, 0, 3, 3])),
                                  jmask.Mask(np.ones((3, 3), np.uint8), (10, 10), "mask")
                                  .box_crop(np.array([0, 0, 3, 3])))


@pytest.fixture
def eval_set(tmp_path, rng):
    """5 PNG images of three sizes; a 'det' task with polygon masks (two
    annotation files for one image, merged), a 'cls' task with boxes only,
    an RLE-mask file, and an image with no 'cls' annotation."""
    rows = []
    sizes = [(96, 96), (120, 80), (70, 130), (96, 96), (64, 64)]
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"img{i}.png"), img)
        n = 3 + i % 3
        xy = rng.uniform(0, 0.6, (n, 2)) * [w, h]
        wh = rng.uniform(0.15, 0.4, (n, 2)) * [w, h]
        boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)
        polys = np.empty(n, object)
        for j, b in enumerate(boxes):
            polys[j] = [np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]],
                                 np.float32)]
        np.savez(tmp_path / f"det{i}.npz", boxes=boxes, labels=rng.integers(1, 5, n),
                 masks=polys, size=np.array([h, w]))
        rows.append(dict(image_path=f"img{i}.png", image_id=f"im{i}", ann_id=f"d{i}",
                         ann_path=f"det{i}.npz", task_id="det", mask_mode="poly"))
        if i == 1:                                    # a second 'det' group, RLE masks
            m = np.zeros((h, w), np.uint8)
            m[10:40, 20:60] = 1
            rles = np.empty(1, object)
            rles[0] = jmask.rle_encode(m)
            np.savez(tmp_path / "det1b.npz", boxes=np.array([[20, 10, 60, 40]], np.float32),
                     labels=np.array([2]), masks=rles, size=np.array([h, w]))
            rows.append(dict(image_path="img1.png", image_id="im1", ann_id="d1b",
                             ann_path="det1b.npz", task_id="det", mask_mode="rle"))
        if i != 3:
            np.savez(tmp_path / f"cls{i}.npz", boxes=boxes[:2], labels=np.array([1, 3]),
                     size=np.array([h, w]))
            rows.append(dict(image_path=f"img{i}.png", image_id=f"im{i}", ann_id=f"c{i}",
                             ann_path=f"cls{i}.npz", task_id="cls", mask_mode="poly"))
    import pandas as pd

    csv = tmp_path / "index.csv"
    pd.DataFrame(rows).to_csv(csv, index=False)
    return str(csv)


@pytest.mark.parametrize("keep_res", [-1.0, 0.8, 1.4])
def test_eval_samples_and_batches_equal_jax(eval_set, keep_res):
    """Both ``keep_res`` branches (resize to img_size; rescale + center
    pad / crop), every sample and every collated batch."""
    hyp = {"img_size": 96, "keep_res": keep_res}
    t = tds.DetectionDataset(eval_set, hyp, train=False, max_targets=8)
    j = jds.DetectionDataset(eval_set, hyp, train=False, max_targets=8)
    assert len(t) == len(j) == 5 and t.task_ids == j.task_ids == ["cls", "det"]
    samples = {}
    for i in range(len(t)):
        try:
            want = j[i]
        except ValueError:
            # the JAX package cannot crop a raster (RLE) mask in the keep_res
            # crop branch (Mask.pad with negative offsets); the port carries
            # the fault over and raises the same way (ROADMAP C.3)
            assert keep_res > 1 and i == 1
            with pytest.raises(ValueError):
                t[i]
            continue
        samples[i] = t[i]
        assert_tree_equal(samples[i], want, f"sample {i}")
    assert len(samples) >= 4 and not samples[3]["targets"]["cls"]["active"]
    assert all(s["targets"]["det"]["valid"].sum() >= 1 for s in samples.values())
    idx = [i for i in (0, 2, 3) if i in samples]
    assert_tree_equal(tds.collate_padded([samples[i] for i in idx]),
                      jds.collate_padded([j[i] for i in idx]))


@pytest.mark.parametrize("drop_last,workers", [(False, 2), (True, 1)])
def test_loader_batches_equal_jax(eval_set, drop_last, workers):
    hyp = {"img_size": 64}
    t = tds.DetectionDataset(eval_set, hyp, train=False, max_targets=8)
    j = jds.DetectionDataset(eval_set, hyp, train=False, max_targets=8)
    kw = dict(batch_size=2, workers=workers, drop_last=drop_last)
    got = list(tds.DataLoader(t, **kw))
    want = list(jds.DataLoader(j, shuffle=False, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        assert_tree_equal(a, b)


def test_loader_raises_a_worker_failure(eval_set, tmp_path):
    ds = tds.DetectionDataset(eval_set, {"img_size": 64}, train=False, max_targets=8)
    (tmp_path / "img2.png").unlink()
    with pytest.raises(FileNotFoundError):
        list(tds.DataLoader(ds, batch_size=2, workers=2, drop_last=False))


def test_train_dataset_waits_for_training(eval_set):
    """``train=True`` no longer waits: it serves augmented mosaic samples of
    the padded schema (held against JAX in ``test_torch_augment.py``)."""
    ds = tds.DetectionDataset(eval_set, {"img_size": 64}, train=True, max_targets=8)
    s = ds[0]
    assert s["image"].shape == (64, 64, 3) and s["image"].dtype == np.uint8
    assert s["targets"]["det"]["boxes"].shape == (8, 4)
    assert s["targets"]["det"]["masks"].shape == (8, 28, 28)


def test_annotation_files_equal_jax(tmp_path):
    import torch

    boxes = np.array([[1, 2, 30, 40]], np.float32)
    torch.save({"boxes": torch.from_numpy(boxes), "labels": torch.tensor([2]),
                "size": torch.tensor([50, 60])}, tmp_path / "a.pt")
    np.savez(tmp_path / "a.npz", boxes=boxes, labels=np.array([2]), size=np.array([50, 60]))
    for name in ("a.pt", "a.npz"):
        assert_tree_equal(tds.load_annotation_file(str(tmp_path / name)),
                          jds.load_annotation_file(str(tmp_path / name)))
    with pytest.raises(ValueError):
        tds.load_annotation_file(str(tmp_path / "a.json"))
