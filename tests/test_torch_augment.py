"""PyTorch port: the host training augmentations (``hd_yolo_tpu_torch/data/
augment.py``) and the training samples of ``DetectionDataset(train=True)``
against the JAX package under the same seeds: the JAX side's global
``random`` / ``np.random`` seeded with ``s``, the port's ``AugRng(s)``.
Images equal byte for byte; boxes, labels and masks equal.
"""

import random

import cv2
import numpy as np
import pytest

from hd_yolo_tpu.data import augment as ja
from hd_yolo_tpu.data import dataset as jds
from hd_yolo_tpu.data.mask import Mask as JMask
from hd_yolo_tpu_torch.data import augment as ta
from hd_yolo_tpu_torch.data import dataset as tds
from hd_yolo_tpu_torch.data.mask import Mask as TMask

HYP = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 10.0, "translate": 0.1,
       "scale": 0.5, "shear": 2.0, "perspective": 0.0005, "flipud": 0.5, "fliplr": 0.5,
       "transpose": 0.5, "photometric": 0.5, "hsv_p": 0.5}


def seed_jax(s):
    random.seed(s)
    np.random.seed(s)


def sample_ann(rng, h, w, n, cls):
    xy = rng.uniform(0, 0.6, (n, 2)) * [w, h]
    wh = rng.uniform(0.15, 0.35, (n, 2)) * [w, h]
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)
    polys = [[np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]], np.float32)]
             for b in boxes]
    return {"boxes": boxes, "labels": rng.integers(1, 5, n),
            "masks": [cls(p, (h, w), "poly") for p in polys]}


def pair(seed=0, h=96, w=96, n=5):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    return img, sample_ann(np.random.default_rng(seed), h, w, n, JMask), \
        sample_ann(np.random.default_rng(seed), h, w, n, TMask)


def assert_ann_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a["boxes"]), np.asarray(b["boxes"]))
    np.testing.assert_array_equal(np.asarray(a["labels"]), np.asarray(b["labels"]))
    assert len(a["masks"]) == len(b["masks"])
    for ma, mb in zip(a["masks"], b["masks"]):
        assert (ma is None) == (mb is None)
        if ma is not None:
            np.testing.assert_array_equal(ma.mask().m, mb.mask().m)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_ops_equal(seed):
    img, _, _ = pair(seed)
    for jf, tf in ((lambda: ja.random_hsv(img, p=0.5), lambda r: ta.random_hsv(img, r, p=0.5)),
                   (lambda: ja.color_jitter(img), lambda r: ta.color_jitter(img, r)),
                   (lambda: ja.color_dodge(img), lambda r: ta.color_dodge(img, r)),
                   (lambda: ja.random_photometric(img, HYP),
                    lambda r: ta.random_photometric(img, HYP, r))):
        seed_jax(seed)
        want = jf()
        got = tf(ta.AugRng(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_geometry_equal(seed):
    img, jann, tann = pair(seed)
    seed_jax(seed)
    r = ta.AugRng(seed)
    np.testing.assert_array_equal(ta.projective_matrix((96, 96), r, 10, 0.1, 0.5, 2, 0.001),
                                  ja.projective_matrix((96, 96), 10, 0.1, 0.5, 2, 0.001))
    for jf, tf in ((lambda: ja.random_projective(img, jann, HYP),
                    lambda: ta.random_projective(img, tann, HYP, r)),
                   (lambda: ja.random_flips(img, jann), lambda: ta.random_flips(img, tann, r)),
                   (lambda: ja.apply_transpose(img, jann), lambda: ta.apply_transpose(img, tann)),
                   (lambda: ja.copy_paste(img, jann, 1.0), lambda: ta.copy_paste(img, tann, r, 1.0))):
        wi, wa = jf()
        gi, ga = tf()
        np.testing.assert_array_equal(gi, wi)
        assert_ann_equal(ga, wa)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_train_chain_and_mixup_equal(seed):
    img, jann, tann = pair(seed)
    seed_jax(seed)
    r = ta.AugRng(seed)
    for hyp in (HYP, {**HYP, "color_aug": "jitter", "copy_paste": 0.5},
                {**HYP, "color_aug": "dodge"}):
        wi, wa = ja.train_proc_multi(img, {"det": jann, "cls": jann}, hyp)
        gi, ga = ta.train_proc_multi(img, {"det": tann, "cls": tann}, hyp, r)
        np.testing.assert_array_equal(gi, wi)
        for t in wa:
            assert_ann_equal(ga[t], wa[t])
    img2, jann2, tann2 = pair(seed + 10)
    wi, wa = ja.mixup(img, {"det": jann}, img2, {"det": jann2, "x": jann2})
    gi, ga = ta.mixup(img, {"det": tann}, img2, {"det": tann2, "x": tann2}, r)
    np.testing.assert_array_equal(gi, wi)
    for t in wa:
        assert_ann_equal(ga[t], wa[t])


@pytest.fixture
def train_set(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate([(96, 96), (120, 80), (70, 130), (96, 96)]):
        cv2.imwrite(str(tmp_path / f"img{i}.png"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        a = sample_ann(rng, h, w, 4 + i, JMask)
        polys = np.empty(len(a["boxes"]), object)
        for j, m in enumerate(a["masks"]):
            polys[j] = m.data
        np.savez(tmp_path / f"det{i}.npz", boxes=a["boxes"], labels=a["labels"], masks=polys,
                 size=np.array([h, w]))
        rows.append(f"img{i}.png,im{i},d{i},det{i}.npz,det,poly")
    csv = tmp_path / "index.csv"
    csv.write_text("image_path,image_id,ann_id,ann_path,task_id,mask_mode\n" + "\n".join(rows) + "\n")
    return str(csv)


def assert_sample_equal(a, b):
    np.testing.assert_array_equal(a["image"], b["image"])
    for t in b["targets"]:
        for k in b["targets"][t]:
            np.testing.assert_array_equal(np.asarray(a["targets"][t][k]),
                                          np.asarray(b["targets"][t][k]), err_msg=f"{t}/{k}")


@pytest.mark.parametrize("extra", [{}, {"mixup": 0.5, "k_mosaic": 3},
                                   {"keep_res": 0.7, "patch_size": 64}])
def test_dataset_train_samples_equal(train_set, extra):
    hyp = {**HYP, "img_size": 96, "k_mosaic": 2, **extra}
    seed_jax(4)
    jd = jds.DetectionDataset(train_set, hyp, train=True, max_targets=24)
    want = [jd[i] for i in (0, 2, 1, 3, 0)]
    td = tds.DetectionDataset(train_set, hyp, train=True, max_targets=24, seed=4)
    got = [td[i] for i in (0, 2, 1, 3, 0)]
    for a, b in zip(got, want):
        assert_sample_equal(a, b)
    assert sum(int(s["targets"]["det"]["valid"].sum()) for s in got) > 0


def test_raw_samples_and_shuffled_infinite_loader_equal(train_set):
    hyp = {"img_size": 64}
    jd = jds.DetectionDataset(train_set, hyp, train=True, max_targets=16, host_augment=False)
    td = tds.DetectionDataset(train_set, hyp, train=True, max_targets=16, host_augment=False)
    for i in range(4):
        assert_sample_equal(td[i], jd[i])
    jit = iter(jds.DataLoader(jd, 2, workers=2, infinite=True, seed=3))
    tit = iter(tds.DataLoader(td, 2, workers=2, infinite=True, shuffle=True, seed=3))
    for _ in range(5):                       # crosses into the third epoch
        assert_sample_equal(next(tit), next(jit))
