"""End-to-end convergence check (port of ``tools/convergence_check.py``):
overfit 4 synthetic images and require that the whole stack (dataset →
matcher → losses → optimizer and EMA → NMS → mask branch → ``APMeter``)
reaches near-perfect fitness.

The yolo check trains ``yolov5s-test`` on 4 images of 128 px (2 boxes with
masks each, augmentation all but off) for 1000 steps at lr 0.02 and needs
box fitness >= 0.9 and mask fitness >= 0.8 on them.  ``--hnet`` overfits a
small Swin Mask R-CNN on 2 coloured squares for 700 steps at lr 2e-3
(the JAX tool's note: lr 0.01 diverges on the Swin backbone) and needs both
squares found with their labels; its FPN is 32 wide on the CPU, as the JAX
tool's, and 256 on the card, the width the mask-head kernel takes.

    python -m hd_yolo_tpu_torch.tools.convergence_check [--steps 1000] [--hnet]
    python -m hd_yolo_tpu_torch.tools.convergence_check --device cpu --steps 2   # tiny

On the card by default, in f32 as the JAX tool runs; ``--device cpu`` for
the plain path.  Exit code 0 when the check passes; on the card the result
JSON also holds the hand kernels' launches over the run.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

HNET_CFG = {
    "backbone": {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                 "num_heads": [1, 2, 4, 8], "window_size": 4},
    "fpn": {"out_channels": 32},
    "headers": {"det": {"type": "maskrcnn", "num_classes": 2, "pre_nms_topk": 256,
                        "num_proposals": 64, "num_detections": 16,
                        "anchor_sizes": [16.0, 32.0, 64.0, 128.0], "score_thresh": 0.3}},
}
# the FPN width on the card: the mask-head kernel takes 256-channel ROIs
CARD_FPN_CHANNELS = 256
HNET_HYP = {"lr0": 0.002, "momentum": 0.9, "warmup_epochs": 2.0}
HNET_SIZE = 128


def hnet_batch() -> tuple:
    """The 2 images of 2 coloured squares (a red one of label 1, a blue one
    of label 2) on dark noise, and their targets, as numpy."""
    rng = np.random.default_rng(0)
    B = 2
    img = rng.uniform(0, 0.3, (B, HNET_SIZE, HNET_SIZE, 3)).astype(np.float32)
    gt = np.array([[[0.1, 0.1, 0.45, 0.45], [0.55, 0.55, 0.9, 0.9]]] * B, np.float32)
    for b in range(B):
        for (x1, y1, x2, y2), c in zip((gt[b] * HNET_SIZE).astype(int),
                                       ((1.0, 0.2, 0.2), (0.2, 0.2, 1.0))):
            img[b, y1:y2, x1:x2] = c
    targets = {"det": {"boxes": gt, "labels": np.asarray([[1, 2]] * B),
                       "masks": np.ones((B, 2, 28, 28), np.float32),
                       "valid": np.ones((B, 2), bool)}}
    return img, targets


def hnet_cfg(device: str) -> Dict:
    """The check's hnet: the JAX tool's (FPN 32) on the CPU; on the card its
    FPN is ``CARD_FPN_CHANNELS`` wide, the width the mask-head kernel of the
    eval forward takes."""
    import copy

    cfg = copy.deepcopy(HNET_CFG)
    if str(device) != "cpu":
        cfg["fpn"]["out_channels"] = CARD_FPN_CHANNELS
    return cfg


def hnet_check(steps: int = 700, device: str = "cuda", state_dict: Optional[Dict] = None
               ) -> dict:
    """Overfit the 2-square batch for ``steps`` micro-steps of ``hnet_cfg``'s
    model; ``state_dict`` (else seeded weights) starts it.  Returns the first
    and final losses, the eval detections' count and labels, and ``ok``.

    The criterion is the JAX tool's, and its config misses it there as
    here (ROADMAP C.10): a 45 px square has no anchor of sizes 16-128 at
    IoU >= 0.7, so the RPN trains one promoted positive a square while the
    anchors at IoU 0.3-0.7 around it go untrained, and at eval those win
    the ranking; their proposals reach IoU < 0.5 and the box head calls
    them background.  The loss falls all the same."""
    import torch

    from ..engines.optim import build_optimizer
    from ..engines.train_step import TrainState, make_train_step, to_device
    from ..hnet import HNet

    m = HNet.from_cfg(hnet_cfg(device), device=device, seed=0)
    if state_dict is not None:
        m.load_state_dict(state_dict, strict=True)
    img, targets = hnet_batch()
    batch = to_device({"image": img, "targets": targets}, next(m.parameters()).device)
    opt = build_optimizer(m, HNET_HYP, 100, 10)
    state = TrainState.create(m, opt)
    step = make_train_step()
    t0 = time.time()
    first = float("nan")
    for i in range(steps):
        state, met = step(state, batch)
        if i == 0:
            first = float(met["loss"])
    loss = float(met["loss"]) if steps else float("nan")
    m.eval()
    with torch.no_grad():
        _, out = m(batch["image"])
    o = out["det"]
    val = o["valid"][0].cpu().numpy()
    labels = sorted(o["labels"][0].cpu().numpy()[val].tolist())
    ok = int(val.sum()) == 2 and labels == [1, 2]
    return {"check": "hnet", "steps": steps, "first_loss": first, "final_loss": loss,
            "detections": int(val.sum()), "labels": labels, "train_s": time.time() - t0, "ok": ok}


def make_dataset(root: Path, n_images: int = 4, task: str = "det") -> str:
    """4 noise images of 96 px with the same two boxes (labels 1 and 2,
    rectangle polygons as masks) in the index format; train and val are the
    same set.  Returns the data yaml."""
    import cv2
    import yaml

    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_images):
        img = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
        cv2.imwrite(str(root / f"img{i}.png"), img)
        boxes = np.array([[10, 10, 45, 45], [50, 50, 90, 88]], np.float32)
        polys = np.empty(2, object)
        for j, b in enumerate(boxes):
            polys[j] = [np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]])]
        np.savez(root / f"ann{i}.npz", boxes=boxes, labels=np.array([1, 2]),
                 masks=polys, size=np.array([96, 96]))
        rows.append(f"img{i}.png,im{i},a{i},ann{i}.npz,{task},poly")
    csv = root / "index.csv"
    csv.write_text("image_path,image_id,ann_id,ann_path,task_id,mask_mode\n"
                   + "\n".join(rows) + "\n")
    data_yaml = root / "data.yaml"
    meta = {task: {"labels_text": {1: "tumor", 2: "stromal", 3: "sTILs", 4: "other"}}}
    data_yaml.write_text(yaml.safe_dump({"train": str(csv), "val": str(csv), "tasks": [task],
                                         "meta_info": meta}))
    return str(data_yaml)


def yolo_hyp() -> dict:
    """``hyp-nuclei`` with the augmentation all but off."""
    from ..config import load_cfg

    hyp = load_cfg("hyp-nuclei")
    hyp.update({"flipud": 0.0, "fliplr": 0.0, "scale": 0.01, "translate": 0.01,
                "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "transpose": 0.0, "photometric": 0.0})
    return hyp


def yolo_model(device: str = "cuda", state_dict: Optional[Dict] = None):
    """``yolov5s-test`` as the check trains it, f32 on ``device``:
    ``state_dict`` or flax's default init seeded by 0."""
    import torch

    from ..detector import resolve_device
    from ..models.yolo import Model

    m = Model.from_cfg("yolov5s-test", yolo_hyp(), mask_rois=8, max_masks=16, pre_nms_topk=256)
    if state_dict is None:
        m.init_weights(torch.Generator().manual_seed(0))
    else:
        m.load_state_dict(state_dict, strict=True)
    return m.to(resolve_device(device))


def yolo_fitness(m, data: str) -> tuple:
    """(box fitness, mask fitness) of ``m`` on the check's 4 images (``m``
    left in eval mode)."""
    import torch

    from ..config import load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..engines import val as val_engine

    info = load_dataset_info(data)
    vds = DetectionDataset(info["val"], {"img_size": 128}, train=False, max_targets=16)
    fits = []
    m.eval()
    for iou_type in ("boxes", "masks"):
        vd = DataLoader(vds, 4, workers=1, shuffle=False, drop_last=False)
        with torch.no_grad():
            fit, _, _ = val_engine.run(m, ((b["image"], b["targets"]) for b in vd),
                                       compute_masks=True, iou_type=iou_type, verbose=False,
                                       core_classes=2)
        fits.append(float(fit))
    return tuple(fits)


def yolo_train(m, data: str, steps: int) -> tuple:
    """``steps`` micro-steps of ``m`` on the check's 4 images (batch 4, lr
    0.02, warmup 0.5 epochs of 10 steps, masks).  Returns ([step, loss]
    every 200 steps and at the last, train seconds)."""
    from ..config import load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..engines.optim import build_optimizer
    from ..engines.train_step import TrainState, make_train_step, to_device

    hyp = yolo_hyp()
    dev = next(m.parameters()).device
    ds = DetectionDataset(load_dataset_info(data)["train"],
                          {**hyp, "img_size": 128, "patch_size": 128, "k_mosaic": 1},
                          train=True, max_targets=16)
    dl = iter(DataLoader(ds, 4, workers=2, infinite=True))
    opt = build_optimizer(m, {**hyp, "lr0": 0.02, "warmup_epochs": 0.5}, epochs=100,
                          steps_per_epoch=10)
    state = TrainState.create(m, opt)
    step = make_train_step(mask_weight=1.0)
    losses = []
    t0 = time.time()
    for i in range(steps):
        state, met = step(state, to_device(next(dl), dev))
        if i % 200 == 0 or i == steps - 1:
            losses.append([i, float(met["loss"])])
            print(f"step {i}: loss={losses[-1][1]:.3f}", flush=True)
    return losses, time.time() - t0


def yolo_check(steps: int = 1000, device: str = "cuda", min_box_fitness: float = 0.9,
               min_mask_fitness: float = 0.8, state_dict: Optional[Dict] = None) -> dict:
    """Train ``yolov5s-test`` on the 4 images for ``steps`` micro-steps
    (``yolo_train``), then validate the trained weights (not the EMA, as the
    JAX tool): box and mask fitness against their floors."""
    with tempfile.TemporaryDirectory(prefix="convergence_") as tmp:
        data = make_dataset(Path(tmp), n_images=4)
        m = yolo_model(device, state_dict)
        losses, train_s = yolo_train(m, data, steps)
        fit, fit_m = yolo_fitness(m.eval(), data)
    ok = fit >= min_box_fitness and fit_m >= min_mask_fitness
    return {"check": "yolo", "steps": steps, "losses": losses, "box_fitness": fit,
            "mask_fitness": fit_m, "min_box_fitness": min_box_fitness,
            "min_mask_fitness": min_mask_fitness, "train_s": train_s, "ok": ok}


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hd_yolo_tpu_torch convergence_check")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--min-box-fitness", type=float, default=0.9)
    p.add_argument("--min-mask-fitness", type=float, default=0.8)
    p.add_argument("--hnet", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--report", default=None, help="also write the result JSON here")
    return p


def main(argv=None) -> int:
    from .. import kernels

    opt = argument_parser().parse_args(argv)
    kernels.reset_launches()
    if opt.hnet:
        res = hnet_check(min(opt.steps, 700), opt.device)
    else:
        res = yolo_check(opt.steps, opt.device, opt.min_box_fitness, opt.min_mask_fitness)
    if opt.device != "cpu":
        res["launches"] = dict(kernels.LAUNCHES)          # the hand kernels' launches
    print(json.dumps(res), flush=True)
    print("PASS" if res["ok"] else "FAIL", flush=True)
    if opt.report:
        Path(opt.report).parent.mkdir(parents=True, exist_ok=True)
        Path(opt.report).write_text(json.dumps(res) + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
