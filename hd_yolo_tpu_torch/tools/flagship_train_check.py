"""Flagship quality check (port of ``tools/flagship_train_check.py``): train
the full ``yolov5l6-mask`` through the training CLI (``engines/train.main``)
on a generated NuCLS-format set, then report the final box fitness, the
mask fitness of the saved inference weights (``engines/val.run`` with mask
IoU), a whole-slide check (``wsi_eval``: ``Detector.slide`` on a synthetic
slide, stitched detections matched to its nuclei at IoU 0.5) and the
share of the mask loss's ROIs with an all-zero gradient at the trained
weights (``zero_gradient_share``).

The generator writes the NuCLS converters' on-disk schema (an index csv,
a PNG and an ``.npz`` of polygon masks a tile): H&E-looking tiles with
elliptical nuclei of 4 classes that differ in color and size, so that the
model can learn them.  The validation tiles come from an independent
stream.

    python -m hd_yolo_tpu_torch.tools.flagship_train_check [--device-augment]
        [--epochs 80 --images 32 --batch-size 8] [--report out.json]
    python -m hd_yolo_tpu_torch.tools.flagship_train_check --device cpu \\
        --cfg yolov5s-test --img-size 128 --images 2 --val-images 2 --epochs 1 \\
        --batch-size 2 --slide-px 256                       # a tiny CPU run

On the card by default (bf16); ``--device cpu`` runs in f32.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

CLASS_COLORS = {  # class → mean stain color
    1: (120, 60, 160),   # tumor: large purple
    2: (160, 120, 190),  # stromal: elongated light
    3: (90, 40, 110),    # sTILs: small dark
    4: (140, 100, 150),  # other
}
CLASS_AXES = {1: (22, 18), 2: (26, 10), 3: (10, 9), 4: (16, 14)}
LABELS_TEXT = {1: "tumor", 2: "stromal", 3: "sTILs", 4: "other"}


def render_nucleus(rng, img: np.ndarray, size: int, class_probs=None, axes_scale: float = 1.0):
    """Draw one nucleus of a random class into ``img``; returns (box, label,
    polygon).  ``class_probs`` (length 4, classes 1..4) biases the class
    draw, ``axes_scale`` scales the ellipse's axes."""
    import cv2

    c = (int(rng.choice(4, p=class_probs)) + 1 if class_probs is not None
         else int(rng.integers(1, 5)))
    ax, ay = CLASS_AXES[c]
    ax = max(int(ax * axes_scale * rng.uniform(0.8, 1.25)), 4)
    ay = max(int(ay * axes_scale * rng.uniform(0.8, 1.25)), 4)
    cx = int(rng.integers(ax + 2, size - ax - 2))
    cy = int(rng.integers(ay + 2, size - ay - 2))
    poly = cv2.ellipse2Poly((cx, cy), (ax, ay), int(rng.integers(0, 180)), 0, 360, 12)
    cv2.fillPoly(img, [poly], tuple(int(v + rng.integers(-15, 15)) for v in CLASS_COLORS[c]))
    x1, y1 = poly.min(0)
    x2, y2 = poly.max(0)
    return [x1, y1, x2, y2], c, poly


def render_tile(rng, img_size: int, nuclei_per_tile: int, class_probs=None,
                axes_scale: float = 1.0):
    """One synthetic H&E tile: (img uint8 RGB, boxes, labels, polygons).
    ``class_probs`` and ``axes_scale`` go to each ``render_nucleus``; without
    them the draws are the uniform class and the class's own axes."""
    img = np.full((img_size, img_size, 3), 230, np.uint8)
    img += rng.integers(-12, 12, img.shape).astype(np.uint8)
    boxes, labels, polys = [], [], []
    for _ in range(nuclei_per_tile):
        b, c, p = render_nucleus(rng, img, img_size, class_probs, axes_scale)
        boxes.append(b)
        labels.append(c)
        polys.append(p)
    return img, boxes, labels, polys


def _write_split(root: Path, prefix: str, n_images: int, img_size: int, nuclei_per_tile: int,
                 rng, task_id: str) -> Path:
    """One split in the index format: a PNG and an ``.npz`` a tile."""
    import cv2

    rows = []
    for i in range(n_images):
        img, boxes, labels, polys = render_tile(rng, img_size, nuclei_per_tile)
        name = f"{prefix}{i}"
        cv2.imwrite(str(root / f"{name}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        parr = np.empty(len(polys), object)
        for j, pl in enumerate(polys):
            parr[j] = [pl.astype(np.float64)]
        np.savez(root / f"{name}.npz", boxes=np.asarray(boxes, np.float32),
                 labels=np.asarray(labels, np.int64), masks=parr,
                 size=np.array([img_size, img_size]))
        rows.append(f"{name}.png,{prefix}_t{i},{prefix}_a{i},{name}.npz,{task_id},poly")
    csv_path = root / f"index_{prefix}.csv"
    csv_path.write_text("image_path,image_id,ann_id,ann_path,task_id,mask_mode\n"
                        + "\n".join(rows) + "\n")
    return csv_path


def make_nucls_dataset(root: Path, n_images: int = 32, img_size: int = 640,
                       nuclei_per_tile: int = 40, seed: int = 0, task_id: str = "detSC",
                       n_val: int = 0) -> str:
    """A synthetic NuCLS set under ``root``; returns its data yaml.  With
    ``n_val`` > 0 the validation tiles are drawn from an independent
    stream; with 0 the training tiles are validated on."""
    import yaml

    root.mkdir(parents=True, exist_ok=True)
    train_csv = _write_split(root, "tile", n_images, img_size, nuclei_per_tile,
                             np.random.default_rng(seed), task_id)
    val_csv = (_write_split(root, "val", n_val, img_size, nuclei_per_tile,
                            np.random.default_rng(seed + 10_000), task_id)
               if n_val > 0 else train_csv)
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(
        {"train": str(train_csv), "val": str(val_csv), "tasks": [task_id],
         "meta_info": {task_id: {"labels_text": LABELS_TEXT}}}))
    return str(data_yaml)


def compute_dtype(device: str):
    """bf16 on the card (the mask-head kernel's dtype), f32 on the CPU."""
    import torch

    return torch.float32 if device == "cpu" else torch.bfloat16


def mask_fitness(run_dir: Path, data: str, cfg: str, img_size: int, batch_size: int,
                 device: str) -> tuple:
    """The saved inference weights' fitness with mask IoU on the val split."""
    import torch

    from ..config import load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..engines import val as val_engine
    from ..engines.checkpoint import load_inference
    from ..models.yolo import Model

    info = load_dataset_info(data)
    model = Model.from_cfg(cfg, "hyp-nuclei", dtype=compute_dtype(device), max_masks=64,
                           mask_rois=32)
    load_inference(str(run_dir / "final.pt"), model)
    model.eval().to(torch.device(device))
    vds = DetectionDataset(info["val"], {"img_size": img_size}, train=False, max_targets=64)
    vdl = DataLoader(vds, batch_size, workers=4, drop_last=False)
    fit, stats, _ = val_engine.run(model, ((b["image"], b["targets"]) for b in vdl),
                                   meta_info=info.get("meta_info", {}), compute_masks=True,
                                   iou_type="masks", input_size=img_size, verbose=False)
    return fit, stats


def zero_gradient_share(run_dir: Path, data: str, cfg: str, img_size: int, batch_size: int,
                        device: str) -> dict:
    """At the trained weights, on one host-augmented training batch: how
    many of the mask loss's ROIs get an all-zero output gradient (the
    canvas ROI-align's backward passes over those)."""
    import torch

    from ..config import load_cfg, load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..engines.checkpoint import load_inference
    from ..engines.train import scale_task_hyp
    from ..engines.train_step import to_device
    from ..models.builder import parse_model_cfg
    from ..models.yolo import Model
    from ..ops import pallas_roi_align

    hyp = scale_task_hyp(load_cfg("hyp-nuclei"), parse_model_cfg(cfg, None), img_size)
    model = Model.from_cfg(cfg, hyp, dtype=compute_dtype(device), max_masks=64, mask_rois=32)
    load_inference(str(run_dir / "final.pt"), model)
    model.to(torch.device(device)).train()
    ds = DetectionDataset(load_dataset_info(data)["train"],
                          {**hyp, "img_size": img_size, "k_mosaic": 1}, train=True,
                          max_targets=64, seed=1)
    batch = to_device(next(iter(DataLoader(ds, batch_size, workers=1))), device)
    seen = []
    orig = pallas_roi_align.roi_align_bounded_bwd

    def spy(g, *args):
        seen.append(g.detach())
        return orig(g, *args)

    pallas_roi_align.roi_align_bounded_bwd = spy
    try:
        losses, _ = model.losses(batch["image"], batch["targets"])
        model.total_loss(losses).backward()
    finally:
        pallas_roi_align.roi_align_bounded_bwd = orig
    zero = (seen[0].flatten(1) == 0).all(1)
    return {"rois": int(zero.numel()), "zero_gradient": int(zero.sum()),
            "share": float(zero.float().mean())}


def wsi_eval(run_dir: Path, cfg: str = "yolov5l6-mask", img_size: int = 640,
             slide_px: int = 2560, nuclei: int = 300, seed: int = 7, device: str = "cuda"):
    """A synthetic slide from the same nucleus renderer through
    ``Detector.slide`` with the trained weights; the stitched detections
    matched greedily (by score) to the nuclei at IoU 0.5."""
    from ..detector import Detector

    rng = np.random.default_rng(seed)
    img = np.full((slide_px, slide_px, 3), 230, np.uint8)
    img += rng.integers(-12, 12, img.shape).astype(np.uint8)
    gt_boxes, gt_labels = [], []
    for _ in range(nuclei):
        b, c, _ = render_nucleus(rng, img, slide_px)
        gt_boxes.append(b)
        gt_labels.append(c)
    gt_boxes = np.asarray(gt_boxes, np.float64)

    det = Detector(cfg, "hyp-nuclei", weights=str(run_dir / "final.pt"), input_size=img_size,
                   dtype=compute_dtype(device), device=device, max_masks=64, pre_nms_topk=1024)
    rec = det.slide(img, tile=img_size, overlap=64, batch=8, max_total=4096)[0]
    out = next(iter(rec.values()))
    pb, pl, ps = out["boxes"], out["labels"], out["scores"]
    matched = np.zeros(len(gt_boxes), bool)
    tp = tp_cls = 0
    area_gt = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    for i in np.argsort(-ps):
        x1 = np.maximum(pb[i, 0], gt_boxes[:, 0])
        y1 = np.maximum(pb[i, 1], gt_boxes[:, 1])
        x2 = np.minimum(pb[i, 2], gt_boxes[:, 2])
        y2 = np.minimum(pb[i, 3], gt_boxes[:, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        ap = (pb[i, 2] - pb[i, 0]) * (pb[i, 3] - pb[i, 1])
        iou = inter / np.maximum(area_gt + ap - inter, 1e-9)
        iou[matched] = 0.0
        j = int(np.argmax(iou))
        if iou[j] >= 0.5:
            matched[j] = True
            tp += 1
            tp_cls += int(pl[i] == gt_labels[j])
    n_pred = len(pb)
    res = {"wsi_slide_px": slide_px, "gt": len(gt_boxes), "pred": n_pred,
           "recall@0.5": round(tp / len(gt_boxes), 4),
           "precision@0.5": round(tp / max(n_pred, 1), 4),
           "label_acc_on_matched": round(tp_cls / max(tp, 1), 4)}
    print(json.dumps({"wsi_eval": res}), flush=True)
    return res


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hd_yolo_tpu_torch flagship_train_check")
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--val-interval", type=int, default=10)
    p.add_argument("--images", type=int, default=32)
    p.add_argument("--val-images", type=int, default=16,
                   help="independent val tiles (0: validate on the training tiles)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--cfg", default="yolov5l6-mask")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--slide-px", type=int, default=2560)
    p.add_argument("--out", default=None, help="dataset and run dir (default: a temp dir)")
    p.add_argument("--device-augment", action="store_true",
                   help="the augmentation recipe on the device, inside the train step")
    p.add_argument("--weights", default=None, help="warm-start weights (a .pt state_dict)")
    p.add_argument("--report", default=None, help="also write the summary JSON here")
    return p


def main(argv=None) -> dict:
    opt0 = argument_parser().parse_args(argv)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="nucls_synth_") as tmp:
        from ..models.builder import parse_model_cfg

        root = Path(opt0.out or tmp)
        data = make_nucls_dataset(root / "data", n_images=opt0.images, img_size=opt0.img_size,
                                  n_val=opt0.val_images, seed=opt0.seed,
                                  task_id=parse_model_cfg(opt0.cfg, None).headers[0].tag)
        print(f"dataset: {data}", flush=True)

        from ..engines.train import main as train_main

        run = root / "run"
        argv_train = [
            "--data", data, "--cfg", opt0.cfg, "--hyp", "hyp-nuclei", "--device", opt0.device,
            "--epochs", str(opt0.epochs), "--batch-size", str(opt0.batch_size),
            "--img-size", str(opt0.img_size), "--masks", "--workers", str(opt0.workers),
            "--max-targets", "64", "--mask-rois", "32", "--max-masks", "64",
            "--k-mosaic", "1", "--patience", "10000", "--cache-images",
            "--val-interval", str(opt0.val_interval), "--save-interval", str(opt0.val_interval),
            "--nominal-batch-size", str(opt0.batch_size),  # no accumulation: an update a step
            "--seed", str(opt0.seed), "--save-dir", str(run), "--exist-ok"]
        if opt0.device == "cpu":
            argv_train.append("--no-bf16")
        if opt0.device_augment:
            argv_train.append("--device-augment")
        if opt0.weights:
            argv_train += ["--weights", opt0.weights]
        t_train = time.time()
        result = train_main(argv_train)
        t_train = time.time() - t_train
        print(json.dumps({"flagship_train": {k: v for k, v in result.items()
                                             if isinstance(v, (int, float, str))}}), flush=True)
        last = json.loads((run / "results.json").read_text().strip().splitlines()[-1])
        print("last epoch row:", json.dumps(last), flush=True)

        fit_m, stats_m = mask_fitness(run, data, opt0.cfg, opt0.img_size, opt0.batch_size,
                                      opt0.device)
        print(json.dumps({"mask_fitness": fit_m, "mask_stats": stats_m}), flush=True)
        wsi = wsi_eval(run, cfg=opt0.cfg, img_size=opt0.img_size, slide_px=opt0.slide_px,
                       device=opt0.device)
        zero = zero_gradient_share(run, data, opt0.cfg, opt0.img_size, opt0.batch_size,
                                   opt0.device)
        print(json.dumps({"zero_gradient_rois": zero}), flush=True)
    summary = {"device_augment": opt0.device_augment, "epochs": opt0.epochs,
               "images": opt0.images, "batch_size": opt0.batch_size, "seed": opt0.seed,
               "box_fitness": last["fitness"], "best_box_fitness": result["best_fitness"],
               "mask_fitness": fit_m, "wsi_eval": wsi, "zero_gradient_rois": zero,
               "train_s": t_train,
               "wall_s": time.time() - t0}
    if opt0.device != "cpu":
        import torch

        summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"summary": summary}), flush=True)
    if opt0.report:
        Path(opt0.report).parent.mkdir(parents=True, exist_ok=True)
        Path(opt0.report).write_text(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
