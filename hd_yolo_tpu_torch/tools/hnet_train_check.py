"""HNet quality check (port of ``tools/hnet_train_check.py``): train the
whole ``hnet-nucls`` stack (Swin-T + FPN + panoptic + Mask R-CNN det + cl +
the confliction constrain) on disjoint synthetic NuCLS train and val tiles
and report held-out metrics for every task.

Tiles come from the flagship tool's generator (``render_tile``, a
dominant class a tile); targets follow HNet's schema:

  det40x  normalized xyxy boxes, labels 1..4, 28x28 in-box masks (``MAX_T`` 64)
  seg10x  a tissue map (nucleus class c paints tissue class c) at ``--seg-gt-stride``
  cl5x    the tile's dominant nucleus class, capped at 3 classes

Training: ``HNet.from_cfg(cfg, dtype=torch.bfloat16)``, ``build_optimizer``
(lr ``--lr``, warmup 3 epochs, grad-norm clip 10), ``make_train_step`` and
its EMA, on batches resident on the device.  Eval on the held-out split
with the EMA weights: det box mAP@.5 / precision / recall (``APMeter``,
``summarize_stats(..., "det40x", core_classes=4)``), seg mIoU and cl
accuracy.  Then, at the trained weights, one training micro-step's share of
ROIs with an all-zero output gradient at each call of the two ROI-align
backwards (``zero_gradient_rois``).

    python -m hd_yolo_tpu_torch.tools.hnet_train_check --epochs 150 \\
        --num-detections 300 --cl-weight 4 --seg-scale 4 --seg-gt-stride 4 \\
        [--out report.json]
    python -m hd_yolo_tpu_torch.tools.hnet_train_check --device cpu --small \\
        --img 128 --n-train 2 --n-val 2 --batch 2 --epochs 1 --nuclei 6   # a tiny CPU run

On the card by default (bf16); ``--device cpu`` runs in f32.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from .flagship_train_check import render_tile

MAX_T = 64  # target capacity a tile


def build_split(seed: int, n_images: int, img_size: int, nuclei: int, seg_stride: int = 16):
    """Render tiles → (images uint8, {det40x, seg10x, cl5x} numpy targets)."""
    import cv2

    rng = np.random.default_rng(seed)
    imgs = np.zeros((n_images, img_size, img_size, 3), np.uint8)
    boxes = np.zeros((n_images, MAX_T, 4), np.float32)
    labels = np.zeros((n_images, MAX_T), np.int32)
    valid = np.zeros((n_images, MAX_T), bool)
    masks = np.zeros((n_images, MAX_T, 28, 28), np.float32)
    seg = np.zeros((n_images, img_size // seg_stride, img_size // seg_stride), np.int32)
    cl = np.zeros((n_images,), np.int32)
    for i in range(n_images):
        # a dominant class a tile (60% of the draws), so that the cl5x label
        # is learnable rather than the argmax of a uniform draw
        dom = int(rng.integers(0, 4))
        probs = np.full(4, 0.4 / 3)
        probs[dom] = 0.6
        img, bxs, lbs, polys = render_tile(rng, img_size, nuclei, class_probs=probs)
        imgs[i] = img
        tissue = np.zeros((img_size, img_size), np.uint8)
        for j, (b, lab, p) in enumerate(zip(bxs, lbs, polys)):
            cv2.fillPoly(tissue, [p], int(lab))
            if j >= MAX_T:
                continue
            x1, y1, x2, y2 = b
            boxes[i, j] = np.asarray(b, np.float32) / img_size
            labels[i, j] = lab
            valid[i, j] = True
            inst = np.zeros((img_size, img_size), np.uint8)
            cv2.fillPoly(inst, [p], 1)
            crop = inst[y1:y2 + 1, x1:x2 + 1]
            if crop.size:
                masks[i, j] = cv2.resize(crop.astype(np.float32), (28, 28),
                                         interpolation=cv2.INTER_LINEAR) > 0.5
        seg[i] = tissue[seg_stride // 2::seg_stride, seg_stride // 2::seg_stride]
        counts = np.bincount(list(lbs), minlength=5)
        cl[i] = min(int(np.argmax(counts[1:])), 2)
    targets = {"det40x": {"boxes": boxes, "labels": labels, "valid": valid, "masks": masks},
               "seg10x": {"seg_map": seg}, "cl5x": {"label": cl}}
    return imgs, targets


def slice_targets(t, sl):
    return {task: {k: v[sl] for k, v in d.items()} for task, d in t.items()}


def model_cfg(args) -> dict:
    """``hnet-nucls`` with the flags' overrides; ``--small`` swaps in a small
    Swin (embed 32, depths 1/1/1/1, window 4), 32-channel FPN and headers
    and one tile a window, for CPU runs."""
    from ..config import load_cfg

    cfg = load_cfg("hnet-nucls")
    det = cfg["headers"]["det40x"]
    if args.num_detections:
        det["num_detections"] = args.num_detections
        det["num_proposals"] = max(args.num_detections * 2, det.get("num_proposals", 512))
    if args.cl_weight:
        cfg["headers"]["cl5x"]["loss_weight"] = args.cl_weight
    if args.seg_weight:
        cfg["headers"]["seg10x"]["loss_weight"] = args.seg_weight
    if args.seg_scale:
        cfg["headers"]["seg10x"]["scale_factor"] = args.seg_scale
    if args.small:
        cfg["backbone"] = {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                           "num_heads": [1, 2, 4, 8], "window_size": 4}
        cfg["fpn"]["out_channels"] = 32
        cfg["headers"]["seg10x"]["channels"] = 32
        cfg["headers"]["cl5x"]["hidden"] = 32
        det.update(roi_size=args.img, pre_nms_topk=128,
                   num_proposals=min(det["num_proposals"], 64),
                   num_detections=min(det["num_detections"], 32))
    return cfg


def zero_gradient_rois(state, batch) -> dict:
    """One training micro-step at the state's weights (the state is left as
    it was): for each call of the canvas ROI-align's backward
    (``roi_align_bounded_bwd``) and the single-level one
    (``roi_align_levels_bwd``), the ROIs pooled and how many of them get an
    all-zero output gradient."""
    import torch

    from ..ops import pallas_roi_align

    model = state.model
    seen = {"roi_align_bwd": [], "roi_align_single_bwd": []}
    orig = {"roi_align_bounded_bwd": pallas_roi_align.roi_align_bounded_bwd,
            "roi_align_levels_bwd": pallas_roi_align.roi_align_levels_bwd}

    def bounded(g, *a):
        zero = (g.detach().flatten(1) == 0).all(1)
        seen["roi_align_bwd"].append((int(zero.numel()), int(zero.sum())))
        return orig["roi_align_bounded_bwd"](g, *a)

    def levels(grads, *a):
        zero = torch.stack([(g.detach().flatten(2) == 0).all(2) for g in grads]).all(0)
        seen["roi_align_single_bwd"].append((int(zero.numel()), int(zero.sum())))
        return orig["roi_align_levels_bwd"](grads, *a)

    pallas_roi_align.roi_align_bounded_bwd = bounded
    pallas_roi_align.roi_align_levels_bwd = levels
    try:
        model.train()
        losses, _ = model.losses(batch["image"], batch["targets"])
        model.total_loss(losses).backward()
    finally:
        for k, fn in orig.items():
            setattr(pallas_roi_align, k, fn)
        model.zero_grad(set_to_none=True)
        model.eval()
    return {k: [{"rois": n, "zero_gradient": z, "share": z / max(n, 1)} for n, z in v]
            for k, v in seen.items()}


def argument_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("hd_yolo_tpu_torch hnet_train_check")
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--nuclei", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.005)
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    ap.add_argument("--num-detections", type=int, default=0,
                    help="det40x num_detections override, num_proposals twice it (0 = config)")
    ap.add_argument("--cl-weight", type=float, default=0.0,
                    help="cl5x loss_weight override (0 = config value)")
    ap.add_argument("--seg-weight", type=float, default=0.0,
                    help="seg10x loss_weight override (0 = config value)")
    ap.add_argument("--seg-scale", type=int, default=0,
                    help="seg10x scale_factor override (0 = config value)")
    ap.add_argument("--seg-gt-stride", type=int, default=16, help="GT seg-map stride")
    ap.add_argument("--device", default="cuda", help="cuda (default, bf16) or cpu (f32)")
    ap.add_argument("--small", action="store_true",
                    help="a small backbone, FPN and headers (CPU runs)")
    return ap


def main(argv=None) -> dict:
    args = argument_parser().parse_args(argv)

    import torch

    from ..detector import resolve_device
    from ..engines.optim import build_optimizer
    from ..engines.train_step import TrainState, make_train_step, swap_ema, to_device
    from ..engines.val import summarize_stats
    from ..hnet import HNet
    from ..models.metrics import APMeter

    device = resolve_device(args.device)
    # disjoint seeds → disjoint tiles (the generator is purely seed-driven)
    tr_imgs, tr_t = build_split(0, args.n_train, args.img, args.nuclei, args.seg_gt_stride)
    va_imgs, va_t = build_split(1, args.n_val, args.img, args.nuclei, args.seg_gt_stride)

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = HNet.from_cfg(model_cfg(args), dtype=dtype, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params:,}", flush=True)

    B = args.batch
    steps_per_epoch = args.n_train // B
    opt = build_optimizer(model, {"lr0": args.lr, "warmup_epochs": 3.0, "clip_grad_norm": 10.0},
                          epochs=args.epochs, steps_per_epoch=steps_per_epoch)
    state = TrainState.create(model, opt)
    step = make_train_step()

    # device-resident batches
    batches = [to_device({"image": tr_imgs[i * B:(i + 1) * B],
                          "targets": slice_targets(tr_t, slice(i * B, (i + 1) * B))}, device)
               for i in range(steps_per_epoch)]

    t_start = time.time()
    nan_reported = False
    for ep in range(args.epochs):
        last = None
        for batch in batches:
            state, last = step(state, batch)
        if ep % 10 == 0 or ep == args.epochs - 1:
            print(f"epoch {ep}: loss={float(last['loss']):.4f} ({time.time() - t_start:.0f}s)",
                  flush=True)
        if not nan_reported and not np.isfinite(float(last["loss"])):
            nan_reported = True
            bad = {k: float(v) for k, v in last.items() if not np.isfinite(float(v))}
            print(f"NON-FINITE at epoch {ep}: {json.dumps(bad)}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t_start

    # ---- eval on the held-out split, EMA weights
    meter = APMeter()
    seg_inter, seg_union = np.zeros(5), np.zeros(5)
    cl_hits = 0
    model.eval()
    with swap_ema(state), torch.no_grad():
        for i in range(args.n_val // B):
            _, out = model(torch.from_numpy(va_imgs[i * B:(i + 1) * B]).to(device))
            out = {t: {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                       for k, v in o.items()} for t, o in out.items()}
            for b in range(B):
                gi = i * B + b
                ok = out["det40x"]["valid"][b].astype(bool)
                gv = va_t["det40x"]["valid"][gi]
                meter.add({"boxes": out["det40x"]["boxes"][b][ok],
                           "scores": out["det40x"]["scores"][b][ok],
                           "labels": out["det40x"]["labels"][b][ok]},
                          {"boxes": va_t["det40x"]["boxes"][gi][gv] * args.img,
                           "labels": va_t["det40x"]["labels"][gi][gv]})
                pred_seg = np.argmax(out["seg10x"]["probs"][b], -1)
                gt_seg = va_t["seg10x"]["seg_map"][gi]
                if pred_seg.shape != gt_seg.shape:           # amplification resizing
                    import cv2

                    pred_seg = cv2.resize(pred_seg.astype(np.uint8), gt_seg.shape[::-1],
                                          interpolation=cv2.INTER_NEAREST)
                for c in range(5):
                    seg_inter[c] += np.sum((pred_seg == c) & (gt_seg == c))
                    seg_union[c] += np.sum((pred_seg == c) | (gt_seg == c))
                cl_hits += int(np.argmax(out["cl5x"]["probs"][b]) == va_t["cl5x"]["label"][gi])

    det = summarize_stats(meter, "det40x", core_classes=4, verbose=True)
    present = seg_union > 0
    miou = float(np.mean(seg_inter[present] / seg_union[present]))
    zero = zero_gradient_rois(state, batches[0])
    res = {
        "config": {"epochs": args.epochs, "n_train": args.n_train, "n_val": args.n_val,
                   "batch": B, "img": args.img, "params": int(n_params),
                   "num_detections": args.num_detections or "cfg",
                   "cl_weight": args.cl_weight or "cfg", "seg_weight": args.seg_weight or "cfg",
                   "seg_scale": args.seg_scale or "cfg", "seg_gt_stride": args.seg_gt_stride},
        "train_wall_s": round(train_s, 1),
        "det_map50": round(float(det["map50"]), 4),
        "det_map": round(float(det["map"]), 4),
        "det_precision": round(float(det["mp"]), 4),
        "det_recall": round(float(det["mr"]), 4),
        "det_fitness": round(float(det["fitness"]), 4),
        "seg_miou": round(miou, 4),
        "cl_acc": round(cl_hits / args.n_val, 4),
        "zero_gradient_rois": zero,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
    return res


if __name__ == "__main__":
    main()
