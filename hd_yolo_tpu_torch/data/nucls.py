"""NuCLS breast-cancer nuclei dataset: class maps and converters (port of
``hd_yolo_tpu/data/nucls.py``).

The class transfer map, label / colour / text tables and slide-id fold
splits; per-FOV csv parsing (group label, xyxy box, polyline mask
coordinates); and the exporters.  The native output is the index format
``data.dataset.DetectionDataset`` reads: one ``.npz`` per FOV ({boxes,
labels, masks, size}), ``train.csv`` / ``val.csv`` and a ``data.yaml`` with
per-task ``meta_info``.  cv2 and pandas are imported inside the functions
that use them.

    python -m hd_yolo_tpu_torch.data.nucls --data_dir NuCLS/trainval \\
        --output_dir out [--format native|yolo|coco|detectron2] [--trainval_fold 1]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import LOGGER
from ..config import save_cfg

CLASSES = [
    "tumor nuclei", "stroma nuclei", "lymphocyte nuclei",
    "macrophage nuclei", "dead nuclei", "ductal epithelium", "blood cell",
]

CLASSES_TRANSFER_MAP = {
    "apoptotic_body": "dead nuclei", "correction_apoptotic_body": "dead nuclei",
    "fibroblast": "stroma nuclei", "correction_fibroblast": "stroma nuclei",
    "lymphocyte": "lymphocyte nuclei", "correction_lymphocyte": "lymphocyte nuclei",
    "macrophage": "macrophage nuclei", "correction_macrophage": "macrophage nuclei",
    "mitotic_figure": "tumor nuclei", "correction_mitotic_figure": "tumor nuclei",
    "plasma_cell": "lymphocyte nuclei", "correction_plasma_cell": "lymphocyte nuclei",
    "tumor": "tumor nuclei", "correction_tumor": "tumor nuclei",
    "unlabeled": "unlabeled", "correction_unlabeled": "unlabeled",
    "ductal_epithelium": "ductal epithelium",
    "eosinophil": "lymphocyte nuclei",
    "myoepithelium": "stroma nuclei",
    "neutrophil": "lymphocyte nuclei",
    "vascular_endothelium": "stroma nuclei",
    "blood_cell": "blood cell", "blood": "blood cell",
}

# text → int label; unlabeled → −100 (ignore_index convention)
VAL_TO_LABEL: Dict[str, int] = {}
for k, v in {**CLASSES_TRANSFER_MAP, **{c: c for c in CLASSES}}.items():
    lab = CLASSES.index(v) + 1 if v in CLASSES else -100
    VAL_TO_LABEL[" ".join(k.split("_"))] = lab
    VAL_TO_LABEL["_".join(k.split(" "))] = lab

LABELS_TEXT = {**{i + 1: c for i, c in enumerate(CLASSES)}, -100: "unlabeled"}
LABELS_COLOR = {
    1: [255, 0, 0], 2: [0, 255, 0], 3: [0, 0, 255], 4: [255, 255, 0],
    5: [255, 0, 255], 6: [100, 0, 255], 7: [0, 255, 255], -100: [148, 148, 148],
}

EXCLUDE_SLIDE_IDS = [
    "TCGA-A1-A0SP-DX1", "TCGA-A7-A0DA-DX1", "TCGA-AR-A1AR-DX1",
    "TCGA-C8-A12V-DX1", "TCGA-E2-A158-DX1",
]


def get_slide_id(image_id: str, source: str = "trainval") -> str:
    """The slide id of a FOV name (the TCGA id)."""
    assert source in ("test", "trainval")
    if source == "trainval":
        return image_id.split("_")[0]
    tmp = image_id.split("_")[1].split("-")
    return "-".join([tmp[0], tmp[1], tmp[2], tmp[5]])


def parse_fov_csv(csv_path: str) -> Dict[str, object]:
    """One NuCLS FOV gt csv → {boxes, labels (int), masks (a polygon or
    None)}."""
    import pandas as pd

    df = pd.read_csv(csv_path, index_col=0)
    boxes = df[["xmin", "ymin", "xmax", "ymax"]].values.astype(np.float32)
    labels = np.asarray(
        [VAL_TO_LABEL.get(str(g), -100) for g in df["group"].values], np.int64
    )
    masks: List[Optional[np.ndarray]] = []
    for _, entry in df[["type", "coords_x", "coords_y"]].iterrows():
        if entry["type"] == "polyline":
            xs = [float(v) for v in str(entry["coords_x"]).split(",")]
            ys = [float(v) for v in str(entry["coords_y"]).split(",")]
            if len(np.unique(xs)) < 4:  # corrupt polyline annotations
                masks.append(None)
            else:
                masks.append(np.stack([xs, ys], axis=-1).astype(np.float32))
        else:
            masks.append(None)
    return {"boxes": boxes, "labels": labels, "masks": masks}


def read_fold_slides(split_folder: str, fold: int) -> Tuple[set, set]:
    """Train / val slide-name sets of a fold."""
    import pandas as pd

    tr = pd.read_csv(os.path.join(split_folder, f"fold_{fold}_train.csv"), index_col=0)
    va = pd.read_csv(os.path.join(split_folder, f"fold_{fold}_test.csv"), index_col=0)
    return set(tr["slide_name"]), set(va["slide_name"])


def convert_nucls_dataset(
    data_folder: str,
    out_folder: str,
    fold: int = 1,
    task_id: str = "detSC",
    image_size_hint: Tuple[int, int] = (0, 0),
) -> Dict[str, str]:
    """NuCLS trainval layout (rgb/ + csv/ + train_test_splits/) → native format.

    Emits ``{out}/anns/*.npz``, ``{out}/{train,val}.csv`` indices and
    ``{out}/data.yaml``; returns the paths dict.
    """
    import cv2
    import pandas as pd

    rgb = os.path.join(data_folder, "rgb")
    gt = os.path.join(data_folder, "csv")
    splits = os.path.join(data_folder, "train_test_splits")
    train_slides, val_slides = read_fold_slides(splits, fold)

    ann_dir = os.path.join(out_folder, "anns")
    os.makedirs(ann_dir, exist_ok=True)
    rows = {"train": [], "val": []}
    fovs = sorted(f[:-4] for f in os.listdir(gt) if f.endswith(".csv")
                  and not f.startswith("ALL_"))
    for fov in fovs:
        slide = get_slide_id(fov)
        if slide in EXCLUDE_SLIDE_IDS:
            continue
        split = "train" if slide in train_slides else ("val" if slide in val_slides else None)
        if split is None:
            continue
        img_path = os.path.join(rgb, f"{fov}.png")
        if not os.path.exists(img_path):
            LOGGER.warning(f"missing image for {fov}")
            continue
        ann = parse_fov_csv(os.path.join(gt, f"{fov}.csv"))
        img = cv2.imread(img_path)
        size = img.shape[:2] if img is not None else image_size_hint
        masks_obj = np.empty(len(ann["masks"]), object)
        for i, m in enumerate(ann["masks"]):
            masks_obj[i] = [m] if m is not None else []
        npz_path = os.path.join(ann_dir, f"{fov}.npz")
        np.savez(npz_path, boxes=ann["boxes"], labels=ann["labels"],
                 masks=masks_obj, size=np.asarray(size))
        rows[split].append(
            dict(image_path=os.path.relpath(img_path, out_folder),
                 image_id=fov, ann_id=f"{fov}_{task_id}",
                 ann_path=os.path.relpath(npz_path, out_folder),
                 task_id=task_id, mask_mode="poly")
        )

    paths = {}
    for split, rws in rows.items():
        p = os.path.join(out_folder, f"{split}.csv")
        pd.DataFrame(rws).to_csv(p, index=False)
        paths[split] = p
        LOGGER.info(f"{split}: {len(rws)} FOVs")
    data_yaml = os.path.join(out_folder, "data.yaml")
    save_cfg(
        {
            "train": paths["train"], "val": paths["val"], "tasks": [task_id],
            "meta_info": {task_id: {"labels_text": LABELS_TEXT,
                                    "labels_color": LABELS_COLOR}},
        },
        data_yaml,
    )
    paths["data"] = data_yaml
    return paths


def convert_to_coco(index_csv: str, out_json: str, root: Optional[str] = None):
    """Native index → COCO detection json."""
    import pandas as pd

    from .dataset import load_annotation_file
    from .mask import Mask

    root = root or os.path.dirname(index_csv)
    df = pd.read_csv(index_csv)
    images, annotations = [], []
    ann_id = 1
    image_ids = {}
    for _, row in df.iterrows():
        if row["image_id"] not in image_ids:
            image_ids[row["image_id"]] = len(image_ids) + 1
            images.append({"id": image_ids[row["image_id"]],
                           "file_name": row["image_path"]})
        img_id = image_ids[row["image_id"]]
        raw = load_annotation_file(os.path.join(root, row["ann_path"]))
        size = tuple(int(s) for s in np.asarray(raw["size"]).reshape(-1)[:2])
        boxes = np.asarray(raw["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(raw["labels"]).reshape(-1)
        masks = list(raw.get("masks", [None] * len(boxes)))
        for i, (b, l) in enumerate(zip(boxes, labels)):
            a = {
                "id": ann_id, "image_id": img_id, "category_id": int(l),
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                "area": float((b[2] - b[0]) * (b[3] - b[1])),
                "iscrowd": 0,
            }
            m = masks[i] if i < len(masks) else None
            if m is not None and len(np.atleast_1d(m)):
                mask = Mask(m, size, str(row.get("mask_mode", "poly")))
                a["segmentation"] = {
                    k: (v if k == "size" else list(v))
                    for k, v in mask.rle().data.items()
                }
            annotations.append(a)
            ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": c} for i, c in enumerate(CLASSES)],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(coco, f)
    return coco


def convert_to_yolo(index_csv: str, out_dir: str, root: Optional[str] = None,
                    masks_dir: Optional[str] = None):
    """Native index → ultralytics yolo-txt layout (images/ + labels/): class
    ids shift to 0-based, boxes become normalized cxcywh; optional per-image
    mask pickles."""
    import pickle
    import shutil

    import pandas as pd

    from .dataset import load_annotation_file

    root = root or os.path.dirname(index_csv)
    img_dir = os.path.join(out_dir, "images")
    lbl_dir = os.path.join(out_dir, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    if masks_dir:
        os.makedirs(masks_dir, exist_ok=True)

    df = pd.read_csv(index_csv)
    for _, row in df.iterrows():
        image_id = str(row["image_id"])
        src = os.path.join(root, row["image_path"])
        shutil.copy2(src, os.path.join(img_dir, f"{image_id}.png"))
        raw = load_annotation_file(os.path.join(root, row["ann_path"]))
        h, w = (int(s) for s in np.asarray(raw["size"]).reshape(-1)[:2])
        boxes = np.asarray(raw["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(raw["labels"]).reshape(-1)
        lines = []
        for (x0, y0, x1, y1), label in zip(boxes, labels):
            cls = (int(label) - 1) if label > 0 else int(label)
            lines.append(
                f"{cls} {(x0 + x1) / 2 / w} {(y0 + y1) / 2 / h} "
                f"{(x1 - x0) / w} {(y1 - y0) / h}"
            )
        with open(os.path.join(lbl_dir, f"{image_id}.txt"), "w") as f:
            f.write("\n".join(lines))
        if masks_dir:
            with open(os.path.join(masks_dir, f"{image_id}.pkl"), "wb") as f:
                pickle.dump(list(raw.get("masks", [])), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
    return out_dir


def convert_to_detectron2(index_csv: str, out_file: Optional[str] = None,
                          root: Optional[str] = None):
    """Native index → detectron2 dataset-dict records, without detectron2
    itself: ``bbox_mode`` is the XYXY_ABS enum value (0), ``segmentation``
    the flattened-xy polygon list.  Returns the records; optionally pickles
    them."""
    import pickle

    import pandas as pd

    from .dataset import load_annotation_file
    from .mask import Mask

    root = root or os.path.dirname(index_csv)
    df = pd.read_csv(index_csv)
    records = []
    for image_idx, (_, row) in enumerate(df.iterrows()):
        raw = load_annotation_file(os.path.join(root, row["ann_path"]))
        size = tuple(int(s) for s in np.asarray(raw["size"]).reshape(-1)[:2])
        h, w = size
        rec = {
            "file_name": os.path.join(root, row["image_path"]),
            "image_id": image_idx,
            "height": h,
            "width": w,
            "annotations": [],
        }
        boxes = np.asarray(raw["boxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(raw["labels"]).reshape(-1)
        masks = list(raw.get("masks", [None] * len(boxes)))
        for i, (b, label) in enumerate(zip(boxes, labels)):
            x0, x1 = sorted((float(b[0]), float(b[2])))
            y0, y1 = sorted((float(b[1]), float(b[3])))
            x0, x1 = max(0.0, x0), min(float(w), x1)
            y0, y1 = max(0.0, y0), min(float(h), y1)
            if x0 >= x1 or y0 >= y1:
                continue
            ann = {
                "bbox": [x0, y0, x1, y1],
                "bbox_mode": 0,  # detectron2 BoxMode.XYXY_ABS
                "category_id": (int(label) - 1) if label > 0 else int(label),
                "segmentation": [],
            }
            m = masks[i] if i < len(masks) else None
            if m is not None and len(np.atleast_1d(m)):
                polys = Mask(m, size, str(row.get("mask_mode", "poly"))).poly().data
                ann["segmentation"] = [
                    np.asarray(p, np.float64).reshape(-1).tolist() for p in polys
                ]
            rec["annotations"].append(ann)
        records.append(rec)

    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "wb") as f:
            pickle.dump(records, f, protocol=pickle.HIGHEST_PROTOCOL)
    return records


def main(argv=None):
    """Dataset-builder CLI: converts a NuCLS trainval layout to the native
    format, then optionally re-exports the train / val indices in another
    layout, and prints the paths as one JSON line:

        python -m hd_yolo_tpu_torch.data.nucls --data_dir NuCLS/trainval \
            --output_dir out [--format yolo|coco|detectron2|native] \
            [--trainval_fold 1] [--masks_folder out/masks]
    """
    import argparse
    import json

    p = argparse.ArgumentParser("hd_yolo_tpu_torch nucls dataset builder")
    p.add_argument("--format", choices=["native", "yolo", "coco", "detectron2"],
                   default="native")
    p.add_argument("--data_dir", "--data-dir", dest="data_dir", required=True,
                   help="NuCLS trainval folder (rgb/ + csv/ + train_test_splits/)")
    p.add_argument("--output_dir", "--output-dir", dest="output_dir",
                   required=True)
    p.add_argument("--trainval_fold", "--fold", dest="fold", type=int, default=1)
    p.add_argument("--masks_folder", dest="masks_folder", default=None,
                   help="yolo format: folder for per-image mask pickles")
    p.add_argument("--task_id", "--task-id", dest="task_id", default="detSC",
                   help="task name the indices carry (must match the model "
                        "config's header name, e.g. detSC)")
    opt = p.parse_args(argv)

    paths = convert_nucls_dataset(opt.data_dir, opt.output_dir, fold=opt.fold,
                                  task_id=opt.task_id)
    out = {"native": paths}
    for split in ("train", "val"):
        if opt.format == "yolo":
            d = os.path.join(opt.output_dir, f"yolo_{split}")
            convert_to_yolo(paths[split], d, root=opt.output_dir,
                            masks_dir=opt.masks_folder
                            and os.path.join(opt.masks_folder, split))
            out[f"yolo_{split}"] = d
        elif opt.format == "coco":
            j = os.path.join(opt.output_dir, f"coco_{split}.json")
            convert_to_coco(paths[split], j, root=opt.output_dir)
            out[f"coco_{split}"] = j
        elif opt.format == "detectron2":
            f = os.path.join(opt.output_dir, f"detectron2_{split}.pkl")
            convert_to_detectron2(paths[split], f, root=opt.output_dir)
            out[f"detectron2_{split}"] = f
    print(json.dumps(out))


if __name__ == "__main__":
    main()
