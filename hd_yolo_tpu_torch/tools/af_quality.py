"""Anchor-free quality run (port of ``tools/af_quality.py``): train
``yolov6s-af`` (the decoupled ``AnchorFreeDetect`` header with SimOTA)
through the training CLI on generated NuCLS tiles and report the held-out
validation metrics of its last epoch.

    python -m hd_yolo_tpu_torch.tools.af_quality --epochs 150 [--out report.json]
    python -m hd_yolo_tpu_torch.tools.af_quality --device cpu --img-size 128 \\
        --images 2 --val-images 2 --batch-size 2 --epochs 1   # a tiny CPU run

On the card by default (bf16); ``--device cpu`` runs in f32.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

from .flagship_train_check import make_nucls_dataset


def argument_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("hd_yolo_tpu_torch af_quality")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--val-images", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--device", default="cuda", help="cuda (default, bf16) or cpu (f32)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    ap.add_argument("--dir", default="", help="dataset and run dir (default: a temp dir)")
    return ap


def main(argv=None) -> dict:
    args = argument_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="af_quality_") as tmp:
        root = Path(args.dir or tmp)
        data = make_nucls_dataset(root / "data", n_images=args.images, img_size=args.img_size,
                                  n_val=args.val_images, task_id="det")

        from ..engines.train import main as train_main

        argv_train = [
            "--data", data, "--cfg", "yolov6s-af", "--hyp", "hyp-nuclei",
            "--device", args.device, "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size), "--img-size", str(args.img_size),
            "--workers", str(args.workers), "--max-targets", "64", "--k-mosaic", "1",
            "--patience", "1000000", "--cache-images", "--val-interval", "25",
            "--save-interval", str(args.epochs), "--nominal-batch-size", str(args.batch_size),
            "--save-dir", str(root / "run"), "--exist-ok"]
        if args.device == "cpu":
            argv_train.append("--no-bf16")
        t0 = time.time()
        result = train_main(argv_train)
        wall = time.time() - t0
    row = {
        "cfg": "yolov6s-af (AFDetect decoupled head + SimOTA)",
        "epochs": args.epochs, "n_train": args.images, "n_val": args.val_images,
        "img_size": args.img_size, "wall_s": round(wall, 1),
        **{k: round(float(v), 4) for k, v in result.items() if isinstance(v, (int, float))},
    }
    if args.device != "cpu":
        import torch

        row["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(row, indent=2), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(row, indent=2) + "\n")
    return row


if __name__ == "__main__":
    main()
