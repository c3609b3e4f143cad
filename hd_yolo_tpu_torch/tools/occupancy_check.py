"""Mask-ROI occupancy of the packed mask branch (port of
``tools/occupancy_check.py``).

The packed branch (``mask_budget``) pools and runs the mask head on at most
``budget`` ROIs a forward call, the top-scored mask-eligible detections of
the whole batch; past the budget the lowest-scored detections lose their
masks.  This tool sweeps nucleus density on synthetic tiles
(``flagship_train_check``'s renderer) and measures, against the per-image
branch on the same tiles (``max_masks`` sized above the densest tile):
the eligible ROIs a batch, the masks the packed branch drops, the largest
difference of the masks both keep, and the mask mAP of both branches
(``engines/val.run`` with mask IoU).  It writes ``OCCUPANCY.json``'s keys
and an operating envelope.

    python -m hd_yolo_tpu_torch.tools.occupancy_check --run RUN_DIR \\
        [--sweep 40,80,120,160 --batch 16 --tiles 32 --budget 768 --max-masks 192]
    python -m hd_yolo_tpu_torch.tools.occupancy_check --device cpu --cfg yolov5s-test \\
        --img-size 128 --sweep 6,12 --tiles 4 --batch 2 --budget 24 --max-masks 16 \\
        --weights final.pt                                       # a tiny CPU run

``RUN_DIR`` is a ``flagship_train_check --out DIR`` run directory (its
``run/final.pt``) or any directory holding ``final.pt``; ``--weights``
names the ``.pt`` directly.  On the card by default (bf16); ``--device
cpu`` runs in f32.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from .flagship_train_check import LABELS_TEXT, _write_split, compute_dtype


def make_models(cfg: str, device: str, max_masks: int, budget: int,
                weights: Optional[str] = None) -> tuple:
    """The per-image and the packed branch's models (``pre_nms_topk`` 1024,
    ``mask_window`` 16) on ``device`` in eval mode, sharing ``weights``."""
    from ..detector import resolve_device
    from ..engines.checkpoint import load_inference
    from ..models.yolo import Model

    dtype = compute_dtype(device)
    out = []
    for kw in ({}, {"mask_budget": budget}):
        m = Model.from_cfg(cfg, "hyp-nuclei", dtype=dtype, max_masks=max_masks,
                           pre_nms_topk=1024, mask_window=16, **kw)
        if weights:
            load_inference(weights, m)
        out.append(m.eval().to(resolve_device(device)))
    if not weights:                               # the same random weights in both
        out[1].load_state_dict(out[0].state_dict())
    return tuple(out)


def occupancy(ref, pack, batches: Callable[[], object]) -> dict:
    """Eligible ROIs of each batch (the per-image branch's kept masks), the
    masks the packed branch drops of them, and the largest |difference| of
    the masks both keep."""
    import torch

    from ..data.preproc import model_input

    task = ref.spec.headers[0].tag
    device = next(ref.parameters()).device
    counts: List[int] = []
    drops, diff = 0, 0.0
    for b in batches():
        x = model_input(b["image"], None, device)
        with torch.no_grad():
            r, p = ref(x)[task], pack(x)[task]
        mv_r, mv_p = r["mask_valid"].cpu().numpy(), p["mask_valid"].cpu().numpy()
        counts.append(int(mv_r.sum()))
        drops += int((mv_r & ~mv_p).sum())
        both = mv_r & mv_p
        if both.any():
            d = (r["masks"].float() - p["masks"].float()).abs().cpu().numpy()[both]
            diff = max(diff, float(d.max()))
    return {"eligible_per_batch": counts, "dropped_total": drops,
            "max_abs_mask_diff_kept": diff}


def mask_map(model, batches: Callable[[], object], img_size: int) -> Dict[str, float]:
    """Mask mAP@0.5, mAP@0.5:0.95 and fitness of ``model`` on the batches."""
    from ..engines import val as val_engine

    task = model.spec.headers[0].tag
    _, stats, _ = val_engine.run(model, ((b["image"], b["targets"]) for b in batches()),
                                 meta_info={task: {"labels_text": LABELS_TEXT}},
                                 compute_masks=True, iou_type="masks", input_size=img_size,
                                 verbose=False)
    return {k: round(float(stats[task][k]), 4) for k in ("map50", "map", "fitness")}


def write_density(root: Path, nuclei: int, tiles: int, img_size: int, task: str) -> Path:
    """``tiles`` synthetic tiles of ``nuclei`` nuclei each under ``root``
    (rng ``1000 + nuclei``, as the JAX tool draws them); returns the index
    csv."""
    dsdir = root / f"n{nuclei}"
    dsdir.mkdir(parents=True, exist_ok=True)
    return _write_split(dsdir, f"n{nuclei}_", tiles, img_size, nuclei,
                        np.random.default_rng(1000 + nuclei), task)


def density_batches(csv: Path, nuclei: int, batch: int, img_size: int):
    """A function giving a fresh loader over the density's tiles (2 loader
    threads, as the JAX tool's)."""
    from ..data.dataset import DataLoader, DetectionDataset

    vds = DetectionDataset(str(csv), {"img_size": img_size}, train=False,
                           max_targets=max(2 * nuclei, 64))
    return lambda: DataLoader(vds, batch, workers=2, shuffle=False, drop_last=False)


def density_row(ref, pack, nuclei: int, batches, img_size: int) -> dict:
    """One density of the sweep over ``batches()``: the occupancy and both
    mask mAPs, as ``OCCUPANCY.json``'s sweep rows."""
    occ = occupancy(ref, pack, batches)
    ap_u, ap_p = mask_map(ref, batches, img_size), mask_map(pack, batches, img_size)
    counts = occ["eligible_per_batch"]
    return {
        "nuclei_per_tile": nuclei,
        "eligible_per_batch": counts,
        "eligible_max": max(counts),
        "dropped_total": occ["dropped_total"],
        "drop_rate": round(occ["dropped_total"] / max(sum(counts), 1), 4),
        "mask_map50_unpacked": ap_u["map50"],
        "mask_map50_packed": ap_p["map50"],
        "mask_map_unpacked": ap_u["map"],
        "mask_map_packed": ap_p["map"],
        "max_abs_mask_diff_kept": occ["max_abs_mask_diff_kept"],
    }


def envelope(rows: List[dict]) -> dict:
    worst = max(r["eligible_max"] for r in rows)
    exact_upto = max((r["nuclei_per_tile"] for r in rows if r["dropped_total"] == 0), default=0)
    return {
        "exact_up_to_nuclei_per_tile": exact_upto,
        "worst_eligible": worst,
        # rounded up to a multiple of 128
        "suggested_budget_for_worst": int(-(-int(worst * 1.1) // 128) * 128),
        "note": "packed == unpacked bit-for-bit while eligible <= budget; over budget the "
                "LOWEST-scored detections lose masks and the quality cost is the "
                "packed-vs-unpacked mask-AP gap in this sweep",
    }


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hd_yolo_tpu_torch occupancy_check")
    p.add_argument("--run", default=None, help="flagship_train_check run dir (its final.pt)")
    p.add_argument("--weights", default=None, help="an inference .pt (instead of --run)")
    p.add_argument("--cfg", default="yolov5l6-mask")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--tiles", type=int, default=32, help="val tiles per density")
    p.add_argument("--img-size", type=int, default=640)
    p.add_argument("--sweep", default="40,80,120,160", help="nuclei-per-tile densities")
    p.add_argument("--budget", type=int, default=768)
    p.add_argument("--max-masks", type=int, default=192,
                   help="the per-image branch's mask capacity (above the densest tile)")
    p.add_argument("--out", default="OCCUPANCY.json")
    return p


def weights_path(opt) -> str:
    if opt.weights:
        return opt.weights
    if not opt.run:
        raise SystemExit("pass --run RUN_DIR or --weights FILE")
    run = Path(opt.run)
    for cand in (run / "final.pt", run / "run" / "final.pt"):
        if cand.is_file():
            return str(cand)
    raise SystemExit(f"no final.pt under {run}")


def main(argv=None) -> dict:
    opt = argument_parser().parse_args(argv)
    weights = weights_path(opt)
    ref, pack = make_models(opt.cfg, opt.device, opt.max_masks, opt.budget, weights=weights)
    rows = []
    with tempfile.TemporaryDirectory(prefix="occ_sweep_") as tmp:
        task = ref.spec.headers[0].tag
        for nuclei in [int(s) for s in opt.sweep.split(",")]:
            csv = write_density(Path(tmp), nuclei, opt.tiles, opt.img_size, task)
            row = density_row(ref, pack, nuclei,
                              density_batches(csv, nuclei, opt.batch, opt.img_size),
                              opt.img_size)
            rows.append(row)
            print(json.dumps(row), flush=True)
    out = {"batch": opt.batch, "tiles_per_density": opt.tiles, "budget": opt.budget,
           "max_masks_unpacked": opt.max_masks, "sweep": rows, "envelope": envelope(rows),
           "weights": weights}
    if opt.device != "cpu":
        import torch

        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out["envelope"], indent=2), flush=True)
    Path(opt.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opt.out).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
