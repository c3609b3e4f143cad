"""PyTorch port: the NuCLS converters (``hd_yolo_tpu_torch/data/nucls.py``)
against the JAX package's on one synthetic NuCLS ``trainval`` layout
(``rgb/*.png``, ``csv/*.csv`` with the columns ``parse_fov_csv`` reads,
``train_test_splits/fold_1_{train,test}.csv``; a slide in each split and
one of ``EXCLUDE_SLIDE_IDS``): equal npz contents, split CSVs and
``data.yaml``, COCO json, YOLO txt files and detectron2 records; and the
CLI as ``python -m hd_yolo_tpu_torch.data.nucls``.
"""

import json
import os
import pickle
import subprocess
import sys

import cv2
import numpy as np
import pandas as pd
import pytest
import yaml

from hd_yolo_tpu.data import nucls as jax_nucls
from hd_yolo_tpu_torch.data import nucls

TRAIN, TEST, EXCLUDED = "TCGA-AR-A0TR-DX1", "TCGA-E2-A1B1-DX1", nucls.EXCLUDE_SLIDE_IDS[1]
GROUPS = ["tumor", "fibroblast", "lymphocyte", "correction_tumor", "unlabeled", "plasma_cell",
          "ductal_epithelium", "blood", "mitotic_figure", "not a class"]


def write_layout(root, fovs_per_slide=2, size=64, per_fov=6, seed=0):
    rng = np.random.default_rng(seed)
    for d in ("rgb", "csv", "train_test_splits"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for slide in (TRAIN, TEST, EXCLUDED):
        for k in range(fovs_per_slide):
            fov = f"{slide}_id-{seed}{k:04x}_left-{100 * k}_top-{200 * k}"
            cv2.imwrite(os.path.join(root, "rgb", f"{fov}.png"),
                        rng.integers(0, 255, (size, size, 3), dtype=np.uint8))
            rows = []
            for j in range(per_fov):
                cx, cy = rng.uniform(8, size - 8, 2)
                r = rng.uniform(3, 7)
                kind = "rectangle" if j % 4 == 3 else "polyline"
                if kind == "polyline" and j % 5 == 4:        # a corrupt polyline: 3 x values
                    xs, ys = [cx - r, cx, cx + r, cx], [cy, cy - r, cy, cy + r]
                elif kind == "polyline":
                    t = np.linspace(0, 2 * np.pi, 9)[:-1]
                    xs, ys = cx + r * np.cos(t), cy + r * np.sin(t)
                else:
                    xs, ys = [cx - r, cx + r, cx + r, cx - r], [cy - r, cy - r, cy + r, cy + r]
                g = GROUPS[int(rng.integers(len(GROUPS)))]
                rows.append({"raw_classification": g, "main_classification": g,
                             "super_classification": g, "group": g, "type": kind,
                             "xmin": int(min(xs)), "ymin": int(min(ys)), "xmax": int(max(xs)) + 1,
                             "ymax": int(max(ys)) + 1,
                             "coords_x": ",".join(str(int(v)) for v in xs),
                             "coords_y": ",".join(str(int(v)) for v in ys)})
            pd.DataFrame(rows).to_csv(os.path.join(root, "csv", f"{fov}.csv"))
    for split, slides in (("train", [TRAIN, EXCLUDED]), ("test", [TEST])):
        pd.DataFrame({"slide_name": slides}).to_csv(
            os.path.join(root, "train_test_splits", f"fold_1_{split}.csv"))
    return root


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The layout, converted by both packages into sibling folders (so the
    relative paths inside agree)."""
    base = tmp_path_factory.mktemp("nucls")
    layout = write_layout(str(base / "trainval"))
    out = {}
    for name, mod in (("port", nucls), ("jax", jax_nucls)):
        out[name] = (mod.convert_nucls_dataset(layout, str(base / name)), str(base / name))
    return base, out


def test_native_npz_csv_and_yaml_equal_jax(converted):
    _, out = converted
    (pp, proot), (jp, jroot) = out["port"], out["jax"]
    for split in ("train", "val"):
        a, b = pd.read_csv(pp[split]), pd.read_csv(jp[split])
        pd.testing.assert_frame_equal(a, b)
        assert len(a) == 2                                  # one slide each; the excluded gone
        assert not any(EXCLUDED in v for v in a["image_id"])
    names = sorted(os.listdir(os.path.join(proot, "anns")))
    assert names == sorted(os.listdir(os.path.join(jroot, "anns"))) and len(names) == 4
    for f in names:
        a = np.load(os.path.join(proot, "anns", f), allow_pickle=True)
        b = np.load(os.path.join(jroot, "anns", f), allow_pickle=True)
        assert set(a.files) == set(b.files) == {"boxes", "labels", "masks", "size"}
        for k in ("boxes", "labels", "size"):
            np.testing.assert_array_equal(a[k], b[k])
        assert len(a["masks"]) == len(b["masks"])
        for ma, mb in zip(a["masks"], b["masks"]):
            assert len(ma) == len(mb)
            for pa, pb in zip(ma, mb):
                np.testing.assert_array_equal(pa, pb)
    ya = yaml.safe_load(open(pp["data"]))
    yb = yaml.safe_load(open(jp["data"]))
    for split in ("train", "val"):
        assert os.path.relpath(ya.pop(split), proot) == os.path.relpath(yb.pop(split), jroot)
    assert ya == yb and ya["tasks"] == ["detSC"]


def test_coco_equals_jax(converted):
    base, out = converted
    for split in ("train", "val"):
        got = nucls.convert_to_coco(out["port"][0][split], str(base / f"p_{split}.json"))
        want = jax_nucls.convert_to_coco(out["jax"][0][split], str(base / f"j_{split}.json"))
        assert got == want and got["annotations"]
        assert any("segmentation" in a for a in got["annotations"])
        with open(base / f"p_{split}.json") as a, open(base / f"j_{split}.json") as b:
            assert json.load(a) == json.load(b)


def test_yolo_txt_equals_jax(converted):
    base, out = converted
    for split in ("train", "val"):
        d = {}
        for name, mod in (("port", nucls), ("jax", jax_nucls)):
            d[name] = str(base / f"yolo_{name}_{split}")
            mod.convert_to_yolo(out[name][0][split], d[name], masks_dir=d[name] + "_masks")
        for sub in ("images", "labels"):
            assert sorted(os.listdir(os.path.join(d["port"], sub))) == \
                sorted(os.listdir(os.path.join(d["jax"], sub)))
        for f in os.listdir(os.path.join(d["port"], "labels")):
            assert open(os.path.join(d["port"], "labels", f)).read() == \
                open(os.path.join(d["jax"], "labels", f)).read()
        for f in os.listdir(d["port"] + "_masks"):
            a = pickle.load(open(os.path.join(d["port"] + "_masks", f), "rb"))
            b = pickle.load(open(os.path.join(d["jax"] + "_masks", f), "rb"))
            assert len(a) == len(b)


def test_detectron2_records_equal_jax(converted):
    base, out = converted
    for split in ("train", "val"):
        got = nucls.convert_to_detectron2(out["port"][0][split], str(base / f"p_{split}.pkl"))
        want = jax_nucls.convert_to_detectron2(out["jax"][0][split])
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert os.path.relpath(a.pop("file_name"), out["port"][1]) == \
                os.path.relpath(b.pop("file_name"), out["jax"][1])
            assert a == b
        assert pickle.load(open(base / f"p_{split}.pkl", "rb"))[0]["annotations"]


def test_cli_runs_as_a_module(tmp_path):
    layout = write_layout(str(tmp_path / "trainval"), seed=1)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
    r = subprocess.run([sys.executable, "-m", "hd_yolo_tpu_torch.data.nucls", "--data_dir", layout,
                        "--output_dir", str(tmp_path / "out"), "--format", "coco"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    paths = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(paths) == {"native", "coco_train", "coco_val"}
    assert os.path.isfile(paths["native"]["data"]) and os.path.isfile(paths["coco_val"])
