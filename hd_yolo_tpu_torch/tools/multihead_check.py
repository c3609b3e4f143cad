"""Two-header check (port of ``tools/multihead_check.py``): train
``yolov5l6-multihead`` — a ``det`` header (nc 7) and a ``detSC`` header
(nc 4) on one trunk, both with masks — through the training CLI on
generated NuCLS tiles served to both tasks, then report each task's
held-out box and mask quality, export one ``torch.export`` program that
carries both tasks, and post a tile and a slide to the REST server for the
default record set and for each task (``?task=``).

    python -m hd_yolo_tpu_torch.tools.multihead_check --epochs 120 [--out report.json]
    python -m hd_yolo_tpu_torch.tools.multihead_check --device cpu \\
        --cfg yolov5s-multihead-test --img-size 128 --n-train 2 --n-val 2 \\
        --batch-size 2 --epochs 1 --nuclei 6 --pre-nms-topk 64   # a tiny CPU run

On the card by default (bf16); ``--device cpu`` runs in f32.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from .flagship_train_check import LABELS_TEXT, _write_split, compute_dtype, render_tile

TASKS = ("det", "detSC")


def build_dataset(root: Path, n_train: int, n_val: int, img_size: int, nuclei: int) -> str:
    """The same tiles for both tasks: each image gets a ``det`` row (nc 7;
    classes 1..4 take the first slots) and a ``detSC`` row (nc 4) on one
    annotation file.  Returns the data yaml."""
    import yaml

    root.mkdir(parents=True, exist_ok=True)
    train_csv = _write_split(root, "tile", n_train, img_size, nuclei, np.random.default_rng(0),
                             "det")
    val_csv = _write_split(root, "val", n_val, img_size, nuclei, np.random.default_rng(10_000),
                           "det")
    for csv in (train_csv, val_csv):       # a second row of each annotation, for detSC
        lines = Path(csv).read_text().strip().splitlines()
        out = [lines[0]]
        for ln in lines[1:]:
            parts = ln.split(",")
            out.append(ln)
            sc = parts.copy()
            sc[2] = parts[2] + "_sc"        # a unique ann_id
            sc[4] = "detSC"
            out.append(",".join(sc))
        Path(csv).write_text("\n".join(out) + "\n")
    labels7 = {**LABELS_TEXT, 5: "necrosis", 6: "vessel", 7: "misc"}
    meta = {"det": {"labels_text": labels7}, "detSC": {"labels_text": dict(LABELS_TEXT)}}
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.safe_dump({"train": str(train_csv), "val": str(val_csv),
                                         "tasks": list(TASKS), "meta_info": meta}))
    return str(data_yaml)


def task_quality(run: Path, data: str, cfg: str, img_size: int, batch_size: int,
                 device: str, pre_nms_topk: int = 1024) -> dict:
    """Each task's held-out stats with box IoU and with mask IoU."""
    import torch

    from ..config import load_cfg, load_dataset_info
    from ..data.dataset import DataLoader, DetectionDataset
    from ..engines import val as val_engine
    from ..engines.checkpoint import load_inference
    from ..models.yolo import Model

    info = load_dataset_info(data)
    model = Model.from_cfg(cfg, load_cfg("hyp-nuclei"), dtype=compute_dtype(device),
                           max_masks=64, mask_rois=32, pre_nms_topk=pre_nms_topk)
    load_inference(str(run / "final.pt"), model)
    model.eval().to(torch.device(device))
    vds = DetectionDataset(info["val"], {"img_size": img_size}, train=False, max_targets=64)
    tasks: dict = {}
    for iou_type in ("boxes", "masks"):
        vdl = DataLoader(vds, batch_size, workers=4, drop_last=False)
        _, stats, _ = val_engine.run(model, ((b["image"], b["targets"]) for b in vdl),
                                     meta_info=info.get("meta_info", {}), compute_masks=True,
                                     iou_type=iou_type, input_size=img_size, verbose=False)
        for task, s in stats.items():
            tasks.setdefault(task, {})[iou_type] = {k: round(float(v), 4) for k, v in s.items()
                                                     if np.isscalar(v)}
    return tasks


def _post(url: str, png: bytes, name: str):
    boundary = "smokeboundary"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
            f"filename=\"{name}\"\r\nContent-Type: image/png\r\n\r\n").encode() + png + \
        f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    urllib.request.urlopen(req, timeout=600).read()          # the first call warms up
    t0 = time.time()
    rows = json.loads(urllib.request.urlopen(req, timeout=600).read())
    return rows, round(time.time() - t0, 3)


def deploy_smoke(run: Path, cfg: str, img_size: int, device: str, work: Path,
                 pre_nms_topk: int = 1024) -> dict:
    """One exported program with both tasks (its outputs on a tile bit for
    bit the eager forward's), and the REST server's tile rows
    (default and each ``?task=``) and slide rows (port of
    ``tools/deploy_smoke.py``'s checks)."""
    from http.server import ThreadingHTTPServer

    import cv2

    from .. import serving
    from ..detector import Detector
    from ..engines.evaluate import export, load_exported

    det = Detector(cfg, "hyp-nuclei", weights=str(run / "final.pt"), input_size=img_size,
                   dtype=compute_dtype(device), device=device, pre_nms_topk=pre_nms_topk)
    res: dict = {"cfg": cfg, "weights": str(run / "final.pt"), "device": str(det.device)}
    path = export(det.model, (1, img_size, img_size, 3), str(work / "multihead.pt2"))
    import torch

    x = torch.from_numpy(render_tile(np.random.default_rng(1), img_size, 30)[0][None]).to(
        det.device)
    out, eager = load_exported(path)(x), det.tiles(x)
    res["export_bytes"] = Path(path).stat().st_size
    res["export_tasks"] = sorted(out)
    # the program's outputs, bit for bit the eager forward's, for both tasks
    res["export_equals_eager"] = sorted(out) == sorted(eager) == sorted(TASKS) and all(
        torch.equal(out[t][k], v) for t in TASKS for k, v in eager[t].items())
    assert res["export_equals_eager"], sorted(out)

    serving._detector = det
    server = ThreadingHTTPServer(("127.0.0.1", 0), serving.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        rng = np.random.default_rng(0)
        tile = render_tile(rng, img_size, 30)[0]
        png = cv2.imencode(".png", cv2.cvtColor(tile, cv2.COLOR_RGB2BGR))[1].tobytes()
        rows, res["rest_latency_s"] = _post(f"{base}/v1/object-detection", png, "tile.png")
        res["rest_n_rows"] = len(rows)
        res["rest_row_keys"] = sorted(rows[0]) if rows else []
        for task in TASKS:
            trows, lat = _post(f"{base}/v1/object-detection?task={task}", png, "tile.png")
            assert all(r["task"] == task for r in trows), (task, trows[:1])
            res[f"rest_rows_{task}"] = len(trows)
            res[f"rest_latency_{task}_s"] = lat
        slide_px = img_size + img_size // 2          # a 2 x 2 tile grid
        slide = render_tile(rng, slide_px, 60)[0]
        spng = cv2.imencode(".png", cv2.cvtColor(slide, cv2.COLOR_RGB2BGR))[1].tobytes()
        srows, res["slide_latency_s"] = _post(f"{base}/v1/slide", spng, "slide.png")
        res["slide_px"] = slide_px
        res["slide_n_rows"] = len(srows)
    finally:
        server.shutdown()
        server.server_close()
        serving._detector = None
    return res


def argument_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("hd_yolo_tpu_torch multihead_check")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-val", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--nuclei", type=int, default=40)
    ap.add_argument("--val-interval", type=int, default=30)
    ap.add_argument("--cfg", default="yolov5l6-multihead")
    ap.add_argument("--device", default="cuda", help="cuda (default, bf16) or cpu (f32)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--pre-nms-topk", type=int, default=1024,
                    help="proposals into each header's NMS at val and deploy (a CPU run's "
                         "export unrolls the plain NMS loop over them)")
    ap.add_argument("--out-dir", default=None, help="dataset and run dir (default: a temp dir)")
    ap.add_argument("--out", default=None, help="also write the result JSON here")
    return ap


def main(argv=None) -> dict:
    args = argument_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="multihead_") as tmp:
        root = Path(args.out_dir or tmp)
        data = build_dataset(root / "data", args.n_train, args.n_val, args.img_size, args.nuclei)
        print(f"dataset: {data}", flush=True)

        from ..engines.train import main as train_main

        argv_train = [
            "--data", data, "--cfg", args.cfg, "--hyp", "hyp-nuclei", "--device", args.device,
            "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
            "--img-size", str(args.img_size), "--masks", "--workers", str(args.workers),
            "--max-targets", "64", "--mask-rois", "32", "--max-masks", "64", "--k-mosaic", "1",
            "--patience", "10000", "--cache-images", "--device-augment",
            "--val-interval", str(args.val_interval), "--save-interval", str(args.val_interval),
            "--nominal-batch-size", str(args.batch_size), "--save-dir", str(root / "run"),
            "--exist-ok"]
        if args.device == "cpu":
            argv_train.append("--no-bf16")
        t0 = time.time()
        train_main(argv_train)
        wall = time.time() - t0
        res = {"config": {"cfg": args.cfg, "epochs": args.epochs, "n_train": args.n_train,
                          "n_val": args.n_val, "img": args.img_size},
               "train_wall_s": round(wall, 1),
               "tasks": task_quality(root / "run", data, args.cfg, args.img_size,
                                     args.batch_size, args.device, args.pre_nms_topk)}
        print(json.dumps(res), flush=True)
        res["deploy"] = deploy_smoke(root / "run", args.cfg, args.img_size, args.device, root,
                                     args.pre_nms_topk)
        print(json.dumps({"deploy": res["deploy"]}), flush=True)
    if args.device != "cpu":
        import torch

        res["device"] = torch.cuda.get_device_name(0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
    return res


if __name__ == "__main__":
    main()
