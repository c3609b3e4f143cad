"""Validation loop: the model on the card → streaming APMeter per task
(port of ``hd_yolo_tpu/engines/val.py``).

* ``flatten_onehot_objects``: one-hot labels → one flat object per set label;
* per-task APMeter + ``summarize_stats`` (max-F1 point; fitness =
  0.1·mAP@.5 + 0.9·mAP@.5:.95 over the first 4 classes);
* timing buckets [data, inference, metrics] in ms per image.  The
  inference bucket ends with the outputs fetched to the host, as the JAX
  loop's ``np.asarray`` does.

The model emits padded (B, D, ...) detection arrays; valid slots are sliced
out on the host before they enter the meter.  ``run`` takes the port's
``Model`` (an ``nn.Module`` holding its weights on its device) where the JAX
loop takes ``(model, variables)``.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import LOGGER
from ..data.preproc import model_input
from ..models.metrics import APMeter


def flatten_onehot_objects(x: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """One-hot / multi-label objects → one flat object per set label.
    Column 0 (unlabeled) maps to −100."""
    labels = np.asarray(x["labels"])
    if labels.ndim != 2:
        raise ValueError(f"labels must be one-hot, got {labels.shape}")
    nbox, nc = labels.shape
    keep = labels.reshape(-1) > 0.0

    res = dict(x)
    flat = np.tile(np.arange(nc), nbox)[keep]
    flat[flat == 0] = -100
    res["labels"] = flat
    res["boxes"] = np.repeat(np.asarray(x["boxes"]), nc, 0)[keep]
    if "scores" in res:
        res["scores"] = np.asarray(x["scores"]).reshape(-1)[keep]
    if "masks" in res:
        res["masks"] = np.repeat(np.asarray(x["masks"]), nc, 0)[keep]
    return res


def summarize_stats(ap_meter: APMeter, task_id: str, core_classes: int = 4,
                    verbose: bool = True) -> Dict[str, float]:
    """Max-F1 operating point + fitness."""
    stats = ap_meter.ap_per_class(ignore=[-100, -1])
    names = ap_meter.labels_text
    if stats["ap"].shape[0] == 0:
        return {"mp": 0.0, "mr": 0.0, "f1": 0.0, "map50": 0.0, "map": 0.0, "fitness": 0.0}

    idx = stats["f1"].mean(0).argmax()
    p, r, f1 = stats["p"][:, idx], stats["r"][:, idx], stats["f1"][:, idx]
    ap50, ap = stats["ap"][:, 0], stats["ap"].mean(1)

    k = core_classes
    map50, map_ = ap50[:k].mean(), ap[:k].mean()
    mp, mr, mf1 = p[:k].mean(), r[:k].mean(), f1[:k].mean()
    fitness = map50 * 0.1 + map_ * 0.9

    if verbose:
        LOGGER.info(("%10s" * 2 + "%12s" * 5) % (task_id, "Labels", "P", "R", "F1", "mAP@.5", "mAP@.5:.95"))
        pf = "%10s" + "%10i" + "%12.3g" * 5
        LOGGER.info(pf % ("all", sum(stats["counts"]), mp, mr, mf1, map50, map_))
        for i, c in enumerate(stats["labels"]):
            LOGGER.info(pf % (names.get(c, c), stats["counts"][i], p[i], r[i], f1[i], ap50[i], ap[i]))

    return {"mp": mp, "mr": mr, "f1": mf1, "map50": map50, "map": map_, "fitness": fitness}


def _unpad_output(out: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    v = np.asarray(out["valid"][i])
    res = {
        "boxes": np.asarray(out["boxes"][i])[v],
        "scores": np.asarray(out["scores"][i])[v],
        "labels": np.asarray(out["labels"][i])[v],
    }
    if "masks" in out:
        R = out["masks"].shape[1]
        if v[:R].sum() == v.sum():  # all valid dets have mask slots
            res["masks"] = np.asarray(out["masks"][i])[v[:R]]
    return res


def paste_for_mask_eval(entry: Dict[str, np.ndarray], im_h: int, im_w: int,
                        thresh: float = 0.5) -> Dict[str, np.ndarray]:
    """In-box (N, M, M) masks + boxes → full-frame binary masks for mask-IoU
    scoring (``ops/paste.paste_masks_in_image`` on the CPU)."""
    from ..ops.paste import paste_masks_in_image

    out = dict(entry)
    if "masks" in entry and len(entry["masks"]):
        pasted = paste_masks_in_image(
            torch.as_tensor(np.asarray(entry["masks"], np.float32)),
            torch.as_tensor(np.asarray(entry["boxes"], np.float32)), im_h, im_w)
        out["masks"] = pasted.numpy() >= thresh
    return out


def _unpad_target(t: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    v = np.asarray(t["valid"][i])
    res = {
        "boxes": np.asarray(t["boxes"][i])[v],
        "labels": np.asarray(t["labels"][i])[v],
    }
    if "masks" in t:
        res["masks"] = np.asarray(t["masks"][i])[v]
    return res


def to_host(out: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, np.ndarray]]:
    """{task: {name: tensor}} → numpy on the host (bf16 as float32)."""
    return {t: {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                for k, v in o.items()} for t, o in out.items()}


def run(
    model,
    data_iter: Iterable[Tuple[np.ndarray, Dict[str, Dict[str, np.ndarray]]]],
    meta_info: Optional[Dict[str, Dict]] = None,
    compute_masks: bool = False,
    iou_type: str = "boxes",
    input_size: Optional[int] = None,
    core_classes: int = 4,
    verbose: bool = True,
    plots_dir: Optional[str] = None,
    max_plot_images: int = 8,
):
    """Validate ``model`` (the port's ``Model``, on its device) over an
    iterator of (images, padded targets).

    Returns (fitness, per-task stats dict, (t_data, t_infer, t_metrics) ms/img).
    """
    meta_info = meta_info or {}
    meters: Dict[str, APMeter] = {}
    device = next(model.parameters()).device

    dt = [0.0, 0.0, 0.0]
    n_images = 0
    t_last = time.time()
    for images, targets in data_iter:
        dt[0] += time.time() - t_last
        t0 = time.time()
        # the loader ships raw uint8 tiles: normalize them here, before any
        # resize, as the JAX loop does
        x = model_input(images, input_size, device)
        outputs = to_host(model(x, compute_masks=compute_masks))
        dt[1] += time.time() - t0
        t0 = time.time()
        B = images.shape[0]
        n_images += B
        h, w = x.shape[1:3]
        for task_id, out in outputs.items():
            if task_id not in meters:
                labels_text = dict(meta_info.get(task_id, {}).get("labels_text", {}))
                meters[task_id] = APMeter(labels_text)
            tgt = targets[task_id]
            for i in range(B):
                o = _unpad_output(out, i)
                t = _unpad_target(tgt, i)
                # targets are normalized xyxy; scale to the model input frame
                t["boxes"] = np.asarray(t["boxes"], np.float64) * [w, h, w, h]
                if np.asarray(t["labels"]).ndim == 2:
                    t = flatten_onehot_objects(t)
                if plots_dir is not None and n_images - B + i < max_plot_images:
                    from .plots import save_detection_overlay

                    meta = dict(meta_info.get(task_id, {}))
                    save_detection_overlay(
                        f"{plots_dir}/{task_id}_img{n_images - B + i}.png",
                        x[i].cpu().numpy(), o, t,
                        meta={"labels_text": dict(meta.get("labels_text", {}))})
                if iou_type == "masks":
                    o = paste_for_mask_eval(o, int(h), int(w))
                    t = paste_for_mask_eval(t, int(h), int(w))
                meters[task_id].add(o, t, iou_type=iou_type)
        dt[2] += time.time() - t0
        t_last = time.time()

    stats = {
        task_id: summarize_stats(meter, task_id, core_classes, verbose)
        for task_id, meter in meters.items()
    }
    fitness = float(np.mean([s["fitness"] for s in stats.values()])) if stats else 0.0
    times = tuple(1000.0 * d / max(n_images, 1) for d in dt)
    if verbose:
        LOGGER.info("Speed: %.1f ms data, %.1f ms inference, %.1f ms metrics per image" % times)
    return fitness, stats, times


def main(argv=None):
    """Standalone validation CLI:

        python -m hd_yolo_tpu_torch.engines.val --data data.yaml --weights model.pt \
            [--cfg yolov5l6-mask] [--hyp hyp-nuclei] [--masks] [--iou-type masks] \
            [--device cpu]

    In bf16, on the card by default; ``--device cpu`` runs the plain path."""
    import argparse
    import json

    from ..config import load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..detector import resolve_device
    from ..models.yolo import Model
    from .checkpoint import load_inference

    p = argparse.ArgumentParser("hd_yolo_tpu_torch val")
    p.add_argument("--data", required=True, help="data yaml (uses its 'val' index)")
    p.add_argument("--cfg", default="yolov5l6-mask")
    p.add_argument("--hyp", default="hyp-nuclei")
    p.add_argument("--weights", required=True,
                   help="inference checkpoint (.pt of engines.checkpoint.save_inference, or a "
                        "pickled flax tree)")
    p.add_argument("--img-size", dest="img_size", type=int, default=640)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=8)
    p.add_argument("--masks", action="store_true", help="compute instance masks")
    p.add_argument("--iou-type", dest="iou_type", choices=["boxes", "masks"],
                   default="boxes", help="match criterion for the APMeter")
    p.add_argument("--max-targets", dest="max_targets", type=int, default=256)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--plots-dir", dest="plots_dir", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)

    device = resolve_device(opt.device)
    data_info = load_dataset_info(opt.data)
    ds = DetectionDataset(data_info["val"], {"img_size": opt.img_size},
                          train=False, max_targets=opt.max_targets)
    dl = DataLoader(ds, opt.batch_size, workers=opt.workers, drop_last=False)
    model = load_inference(opt.weights, Model.from_cfg(opt.cfg, opt.hyp, dtype=torch.bfloat16))
    model.eval().to(device)
    fitness, stats, times = run(
        model, ((b["image"], b["targets"]) for b in dl),
        meta_info=data_info.get("meta_info", {}),
        compute_masks=opt.masks or opt.iou_type == "masks",
        iou_type=opt.iou_type, input_size=opt.img_size,
        plots_dir=opt.plots_dir,
    )
    print(json.dumps({"fitness": fitness, "stats": stats,
                      "ms_per_image": {"data": times[0], "inference": times[1],
                                       "metrics": times[2]}}, default=float))


if __name__ == "__main__":
    main()
