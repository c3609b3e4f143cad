"""Training loop: dataset → train steps → per-epoch validation →
checkpoints (port of ``hd_yolo_tpu/engines/train.py``).

    python -m hd_yolo_tpu_torch.engines.train --data data.yaml --masks \\
        [--cfg yolov5l6-mask] [--hyp hyp-nuclei] [--batch-size 16] [--device cpu]

On the card by default (bf16); ``--device cpu`` runs the plain path and
raises nothing else.  The flags are the JAX package's plus ``--device``.
Per-header hyp rescaling is applied before the model is built: box·3/nl,
cls·nc/80·3/nl, obj·(imgsz/640)²·3/nl.  A fresh model starts from
``Model.init_weights`` (flax's default distributions, seeded by ``--seed``);
``--weights`` (a path, or a bare name searched by
``utils/downloads.attempt_download``) merges into it, tensor by tensor
where the shapes agree, a ``.pt`` checkpoint through
``utils/import_torch`` (a port or reference metayolo state_dict, an
ultralytics ``model.{i}`` one, a pickled module, bare or under ``ema`` /
``model`` / ``state_dict``) or a pickled flax ``{'params', 'batch_stats'}``
tree.  Validation runs ``engines/val.run`` on the EMA parameters with the
live BatchNorm statistics.  Checkpoints: ``last`` / ``best``
(``.pt`` + ``.json``, the whole train state) and ``final.pt`` (the EMA
inference weights).

``--device-augment`` runs the augmentation recipe on the card inside the
step (``data/device_augment.py``); the loader serves raw tiles.
``--cache-device`` uploads the whole raw-mode set to the card once (it
turns on ``--cache-images`` and ``--device-augment``) and each step gathers
its rows there.  ``--multi-scale`` resizes each streamed batch to a size
drawn from 0.5-1.5x ``--img-size`` (dropped under ``--cache-device``).
``--batch-size -1`` fits the batch to the card's memory
(``engines/autobatch.py``), ``--autoanchor`` reports the anchors' fit
(``engines/autoanchor.py``) and ``--evolve N`` evolves the hyperparameters
over N trainings (``engines/evolve.py``).  ``--plots`` writes the
dataset's display dumps and ``labels.jpg`` at the start and
``results.png`` at the end (``engines/plots.py``); it needs matplotlib and
raises ``ImportError`` before the first step where matplotlib is missing.

Several processes, one card each (``parallel/``)::

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m hd_yolo_tpu_torch.engines.train --data data.yaml --masks [--device cpu]

``--batch-size`` is the global batch: each rank loads its ``1/N`` slice of
every epoch (``DataLoader(shard=(rank, N))``) on ``cuda:LOCAL_RANK`` (NCCL)
or, with ``--device cpu``, on the CPU (gloo), and each step is the global
batch's (``train_step.make_train_step(distributed=True)``).  Rank 0 alone
writes the run's files and validates, on its shard of the val set, as the
JAX package does; its fitness goes to every rank.  Every rank restores
``--resume``.  ``--cache-device`` falls back to the streaming loader with a
warning.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import LOGGER, parallel
from ..config import load_cfg, load_dataset_info, save_cfg
from ..data.dataset import DataLoader, DetectionDataset, collate_padded
from ..data.preproc import model_input
from ..detector import resolve_device
from ..models.builder import parse_model_cfg
from ..models.yolo import Model
from ..utils.downloads import attempt_download
from ..utils.general import check_img_size
from ..utils.import_torch import import_state_dict, read_checkpoint
from . import val as val_engine
from .callbacks import Callbacks
from .checkpoint import restore_train_state, save_checkpoint, save_inference, wait_for_saves
from .loggers import Loggers
from .optim import build_optimizer
from .train_step import TrainState, make_train_step, swap_ema, to_device


def fitness_weights(stats: Dict[str, float]) -> float:
    """0.1·mAP@.5 + 0.9·mAP@.5:.95."""
    return stats.get("map50", 0.0) * 0.1 + stats.get("map", 0.0) * 0.9


def scale_task_hyp(hyp: dict, spec, img_size: int) -> dict:
    """Per-header loss-gain rescaling."""
    hyp = dict(hyp)
    for h in spec.headers:
        if h.tag not in hyp:
            continue
        nl = len(h.strides)
        th = dict(hyp[h.tag])
        th["box"] = th.get("box", 0.05) * 3.0 / nl
        th["cls"] = th.get("cls", 0.5) * h.nc / 80.0 * 3.0 / nl
        th["obj"] = th.get("obj", 1.0) * (img_size / 640.0) ** 2 * 3.0 / nl
        hyp[h.tag] = th
    return hyp


class EarlyStopping:
    """Stop after ``patience`` validated epochs without a better fitness."""

    def __init__(self, patience: int = 30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch, self.best_fitness = epoch, fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(f"Stopping early: no improvement in last {self.patience} epochs "
                        f"(best epoch {self.best_epoch}).")
        return stop


def _check_plots(opt) -> None:
    """``--plots`` draws with matplotlib: raise before the first step where
    it does not import."""
    if opt.plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("--plots draws its plots with matplotlib, which does not import "
                              "here; install it or leave --plots out") from e


def plot_dataset(train_ds, val_ds, data_info: Dict, img_size: int, save_dir: str) -> None:
    """``--plots`` at the start: the first 16 validation tiles with their
    boxes under ``display_dataset/``, and ``labels.jpg`` of the first 128
    training samples' first task."""
    from .plots import plot_labels, save_detection_overlay

    disp = os.path.join(save_dir, "display_dataset")
    meta0 = next(iter((data_info.get("meta_info") or {}).values()), {})
    for di in range(min(len(val_ds), 16)):
        s = val_ds[di]
        t = next(iter(s["targets"].values()))
        v = np.asarray(t["valid"])
        save_detection_overlay(os.path.join(disp, f"val_{di:04d}.png"),
                               np.asarray(s["image"], np.uint8),
                               {"boxes": np.asarray(t["boxes"])[v] * img_size,
                                "labels": np.asarray(t["labels"])[v]}, meta=meta0)
    rows = []
    for di in range(min(len(train_ds), 128)):
        t = next(iter(train_ds[di]["targets"].values()))
        v = np.asarray(t["valid"])
        b = np.asarray(t["boxes"])[v]                      # normalized xyxy
        if len(b):
            xywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                             b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)
            rows.append(np.concatenate([np.asarray(t["labels"])[v][:, None], xywh], 1))
    if rows:
        plot_labels(np.concatenate(rows), save_dir=save_dir)


def autobatch_size(model: Model, hyp: dict, opt, device, info: Optional[Dict] = None) -> int:
    """``--batch-size -1``: the batch that fills 0.8 of the card's memory,
    fitted over the real train step (a throwaway optimizer and EMA) on
    all-zero batches of 1, 2 and 4 images; the model's parameters and
    buffers are restored after.  Off the card: ``--nominal-batch-size``."""
    from .autobatch import autobatch

    T = opt.max_targets

    def probe(b):
        z = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                                            device=device)
        batch = {"image": z(b, opt.img_size, opt.img_size, 3),
                 "targets": {h.tag: {"boxes": z(b, T, 4), "labels": z(b, T, dtype=torch.int64),
                                     "masks": z(b, T, 28, 28), "valid": z(b, T, dtype=torch.bool)}
                             for h in model.spec.headers}}
        state = TrainState.create(model, build_optimizer(model, hyp, 1, 1))
        make_train_step(mask_weight=1.0 if opt.masks else 0.0)(state, batch)
        torch.cuda.synchronize(device)

    saved = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    try:
        return autobatch(probe, fallback=opt.nominal_batch_size, device=device, info=info)
    finally:
        model.load_state_dict(saved)


def load_pretrained(model: Model, name: str) -> int:
    """Resolve ``name`` (``utils/downloads.attempt_download``) and merge its
    weights into ``model`` where names and shapes agree
    (``utils/import_torch.import_state_dict``): a ``.pt`` / ``.pth``
    checkpoint (port, metayolo or ultralytics layout, a state_dict or a
    pickled module, bare or under ``ema`` / ``model`` / ``state_dict``),
    anything else as a pickled flax tree.  Returns the tensors loaded."""
    path = str(attempt_download(name))
    if path.endswith((".pt", ".pth")):
        sd = read_checkpoint(path)
    else:
        import pickle

        from ..utils.convert import state_dict_from_flax

        with open(path, "rb") as f:
            sd = state_dict_from_flax(pickle.load(f), model.spec)
    return import_state_dict(model, sd)[0]


def pick_save_dir(opt) -> str:
    """``--save-dir``, or ``exp2``, ``exp3``, ... after it where it holds
    files (not with ``--resume`` or ``--exist-ok``)."""
    save_dir = opt.save_dir
    if (os.path.exists(save_dir) and os.listdir(save_dir) and not opt.resume
            and not getattr(opt, "exist_ok", False)):
        base, n = save_dir.rstrip("/"), 2      # exp -> exp2 -> ...
        while os.path.exists(f"{base}{n}"):
            n += 1
        save_dir = f"{base}{n}"
        LOGGER.info(f"save dir exists; using {save_dir} (pass --exist-ok to reuse)")
    return save_dir


def train(opt, callbacks: Optional[Callbacks] = None) -> Dict[str, float]:
    callbacks = callbacks or Callbacks()
    _check_plots(opt)
    # several processes (torchrun's environment): one card each, rank 0 writes
    rank, world = parallel.maybe_initialize_distributed(
        opt.device, getattr(opt, "dist_timeout", None))
    main_proc = rank == 0
    device = resolve_device(parallel.local_device(opt.device))
    # every rank takes rank 0's pick, made before any rank creates the directory
    save_dir = parallel.broadcast_object(pick_save_dir(opt) if main_proc else None)
    if main_proc:
        os.makedirs(save_dir, exist_ok=True)
    parallel.barrier()
    data_info = load_dataset_info(opt.data)
    hyp = load_cfg(opt.hyp)
    if main_proc:
        Loggers(save_dir).register(callbacks)

    spec0 = parse_model_cfg(opt.cfg, hyp)
    gs = int(max(max(h.strides) for h in spec0.headers))
    opt.img_size = check_img_size(opt.img_size, gs)
    hyp = scale_task_hyp(hyp, spec0, opt.img_size)
    data_tasks = set(data_info.get("tasks", []))
    model_tasks = {h.tag for h in spec0.headers}
    if data_tasks and not (data_tasks & model_tasks):
        raise ValueError(f"data yaml tasks {sorted(data_tasks)} match no model header tags "
                         f"{sorted(model_tasks)} — check the 'tag' column of the header rows "
                         f"in {opt.cfg!r} vs the dataset's task_id values")
    if main_proc:
        save_cfg(hyp, os.path.join(save_dir, "hyp.yaml"))

    model = Model.from_cfg(opt.cfg, hyp, dtype=torch.bfloat16 if opt.bf16 else torch.float32,
                           mask_rois=opt.mask_rois, max_masks=opt.max_masks)
    model.init_weights(torch.Generator().manual_seed(opt.seed))
    if opt.weights:
        LOGGER.info(f"loaded pretrained weights from {opt.weights} "
                    f"({load_pretrained(model, opt.weights)} tensors)")
    model.to(device)
    parallel.replicate(model)
    LOGGER.info(f"model params: {sum(p.numel() for p in model.parameters()):,} on {device}"
                + (f", process {rank}/{world}" if world > 1 else ""))
    if opt.batch_size == -1:
        opt.batch_size = parallel.broadcast_object(autobatch_size(model, hyp, opt, device))
        LOGGER.info(f"autobatch: batch_size={opt.batch_size}")

    cache_device = bool(opt.cache_device)
    if cache_device:                 # the resident set is served raw; the step augments
        opt.cache_images = opt.device_augment = True
    if cache_device and world > 1:
        LOGGER.warning("--cache-device is single-process for now; falling back to the "
                       "streaming loader")
        cache_device = False
    dev_aug = bool(opt.device_augment)
    train_ds = DetectionDataset(
        data_info["train"], {**hyp, "img_size": opt.img_size, "patch_size": opt.patch_size,
                             "k_mosaic": opt.k_mosaic, "keep_res": opt.keep_res},
        train=True, max_targets=opt.max_targets, seed=opt.seed,
        cache_images=opt.cache_images, host_augment=not dev_aug)
    val_ds = DetectionDataset(data_info["val"], {"img_size": opt.img_size}, train=False,
                              max_targets=opt.max_targets, cache_images=opt.cache_images)
    if opt.autoanchor:
        from .autoanchor import check_anchors, dataset_wh

        wh = dataset_wh(val_ds, img_size=opt.img_size, max_images=64)
        if len(wh):
            for h in spec0.headers:
                if any(a for row in h.anchors for a in row):
                    check_anchors(wh, h.anchors, h.strides,
                                  anchor_t=float(dict(h.loss_hyp).get("anchor_t", 4.0)),
                                  imgsz=opt.img_size)
    if opt.plots and main_proc:
        plot_dataset(train_ds, val_ds, data_info, opt.img_size, save_dir)
    # --batch-size is the global batch; each rank loads its 1/world slice
    local_bs = opt.batch_size // parallel.auto_mesh(opt.batch_size, world)
    shard = (rank, world) if world > 1 else None
    train_dl = DataLoader(train_ds, local_bs, workers=opt.workers, infinite=True,
                          shuffle=True, seed=opt.seed, shard=shard)
    val_dl = DataLoader(val_ds, local_bs, workers=opt.workers, drop_last=world > 1, shard=shard)
    # every rank takes as many steps an epoch (the shards may differ by a batch)
    steps_per_epoch = max(_min_over_ranks(len(train_dl), device), 1)

    optimizer = build_optimizer(
        model, hyp, opt.epochs, steps_per_epoch, schedule="cosine" if opt.cos_lr else "linear",
        accumulate=max(round(opt.nominal_batch_size / opt.batch_size), 1),
        freeze=opt.freeze or None, optimizer=opt.optimizer)
    state = TrainState.create(model, optimizer)
    start_epoch, best_fitness = 0, 0.0
    last = os.path.join(save_dir, "last")
    if opt.resume and os.path.exists(last + ".pt"):
        state, meta = restore_train_state(last, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_fitness = float(meta.get("best_fitness", 0.0))
        LOGGER.info(f"resumed from epoch {start_epoch}")
    augment_fn = None
    if dev_aug:
        from ..data.device_augment import make_device_augment

        augment_fn = make_device_augment(hyp, k_mosaic=opt.k_mosaic)
        LOGGER.info("device augmentation: the recipe runs inside the train step")
    step_fn = make_train_step(mask_weight=1.0 if opt.masks else 0.0, seed=opt.seed,
                              augment_fn=augment_fn, resident_data=cache_device,
                              distributed=parallel.is_initialized())
    resident, upload = None, {}
    if cache_device:
        # one upload of the first n_keep raw samples; each step gathers its rows
        n_keep = (len(train_ds) // opt.batch_size) * opt.batch_size
        t0 = time.time()
        host_tree = collate_padded([train_ds[i] for i in range(n_keep)])
        resident = to_device(host_tree, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n_bytes = sum(v.nbytes for v in _leaves(host_tree))
        steps_per_epoch = max(n_keep // opt.batch_size, 1)
        upload = {"images": n_keep, "mb": n_bytes / 1e6, "s": time.time() - t0}
        LOGGER.info(f"device-resident dataset: {n_keep} images / {upload['mb']:.0f} MB uploaded "
                    f"in {upload['s']:.1f}s; {steps_per_epoch} steps/epoch")
    stopper = EarlyStopping(opt.patience)
    meta_info = data_info.get("meta_info", {})

    scale_sizes = []
    if opt.multi_scale and cache_device:
        LOGGER.warning("--multi-scale resizes streamed batches; ignored with --cache-device "
                       "(the device recipe already jitters the scale)")
        opt.multi_scale = False
    if opt.multi_scale:
        scale_sizes = multi_scale_sizes(opt.img_size, gs)
        LOGGER.info(f"multi-scale buckets: {scale_sizes}")

    def validate():
        with swap_ema(state):
            model.eval()
            return val_engine.run(model, ((b["image"], b["targets"]) for b in val_dl),
                                  meta_info=meta_info, compute_masks=opt.masks,
                                  input_size=opt.img_size, verbose=opt.verbose)

    callbacks.run("on_train_start")
    train_iter = None if cache_device else iter(train_dl)
    final_stats: Dict[str, float] = {}
    if opt.pretrain_val and main_proc:
        fit0, _, _ = validate()
        LOGGER.info(f"pre-train val (EMA init): fitness={fit0:.4f}")
    bench_batch = None
    for epoch in range(start_epoch, opt.epochs):
        callbacks.run("on_train_epoch_start")
        t_epoch = time.time()
        mloss: Dict[str, float] = {}
        step_metrics = []              # 0-d device tensors: one host fetch an epoch
        if cache_device:
            epoch_perm = np.random.default_rng(opt.seed + epoch).permutation(n_keep)
        for i in range(steps_per_epoch):
            if cache_device:
                idx = epoch_perm[i * opt.batch_size:(i + 1) * opt.batch_size]
                state, metrics = step_fn(state, resident, idx)
                step_metrics.append(metrics)
                callbacks.run("on_train_batch_end")
                continue
            if opt.bench_loop and bench_batch is not None:
                batch = bench_batch    # --bench-loop: the loader taken out
            else:
                batch = to_device(next(train_iter), device)
                if opt.bench_loop:
                    bench_batch = batch
            if scale_sizes:            # seeded by the global step
                sz = scale_sizes[np.random.default_rng(opt.seed + epoch * steps_per_epoch + i)
                                 .integers(len(scale_sizes))]
                if sz != batch["image"].shape[1]:   # the targets are normalized
                    batch = {**batch, "image": model_input(batch["image"], sz, device)}
            state, metrics = step_fn(state, batch)
            step_metrics.append(metrics)
            callbacks.run("on_train_batch_end")
        mkeys = sorted(step_metrics[0])
        vals = torch.stack([torch.stack([m[k].float() for k in mkeys])
                            for m in step_metrics]).cpu().numpy()
        t_steps = time.time() - t_epoch
        for row in vals:
            m = dict(zip(mkeys, row))
            if not np.isfinite(m["loss"]):         # a skipped step
                mloss["nonfinite_steps"] = mloss.get("nonfinite_steps", 0.0) + 1.0
                continue
            for k, v in m.items():
                if np.isfinite(v):
                    mloss[k] = mloss.get(k, 0.0) + float(v) / steps_per_epoch
        callbacks.run("on_train_epoch_end", epoch=epoch)

        # validation is rank 0's, on its shard of the val set (as the JAX
        # package); its fitness goes to every rank, so all take the same branches
        fit = 0.0
        stats: Dict[str, Dict[str, float]] = {}
        do_val = (epoch + 1) % max(opt.val_interval, 1) == 0 or epoch == opt.epochs - 1
        if do_val and main_proc:
            fit, stats, _ = validate()
        fit = float(parallel.broadcast_object(fit))
        final_stats = {f"{t}/{k}": v for t, s in stats.items() for k, v in s.items()}
        skipped = int(mloss.get("nonfinite_steps", 0))
        LOGGER.info(f"epoch {epoch}: loss={mloss.get('loss', float('nan')):.4f} "
                    f"fitness={fit:.4f} ({time.time() - t_epoch:.0f}s, "
                    f"{steps_per_epoch * opt.batch_size / max(t_steps, 1e-9):.1f} img/s)"
                    + (f" [skipped {skipped} non-finite step(s)]" if skipped else ""))
        callbacks.run("on_fit_epoch_end", {**mloss, **final_stats, "fitness": fit}, epoch,
                      best_fitness, fit)
        if fit >= best_fitness:       # the checkpoints write on rank 0 only
            best_fitness = fit
            if do_val:
                save_checkpoint(os.path.join(save_dir, "best"), state, epoch, best_fitness,
                                async_save=opt.async_ckpt)
        if (epoch + 1) % max(opt.save_interval, 1) == 0 or epoch == opt.epochs - 1:
            save_checkpoint(last, state, epoch, best_fitness, async_save=opt.async_ckpt)
        callbacks.run("on_model_save", epoch=epoch)
        if do_val and stopper(epoch, fit):
            break

    if train_iter is not None:
        train_iter.close()         # stops the loader's producer thread
    wait_for_saves()
    with swap_ema(state):
        save_inference(os.path.join(save_dir, "final.pt"), model)
    rj = os.path.join(save_dir, "results.json")
    if opt.plots and main_proc and os.path.exists(rj):
        from .plots import plot_results

        try:
            plot_results(rj)
        except Exception as e:   # a plot never fails the training it reports on
            LOGGER.warning(f"plot_results failed: {e}")
    callbacks.run("on_train_end")
    parallel.barrier()           # the files are written before any rank returns
    out = {"best_fitness": best_fitness, "save_dir": save_dir, **final_stats}
    if upload:
        out["resident_upload"] = upload
    return out


def _min_over_ranks(n: int, device) -> int:
    if not parallel.is_initialized():
        return n
    t = torch.tensor([n], dtype=torch.int64, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MIN)
    return int(t)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (np.asarray(v),))


def multi_scale_sizes(img_size: int, gs: int) -> list:
    """``--multi-scale``'s image sizes: multiples of the grid ``gs`` over
    0.5-1.5x ``img_size``."""
    lo, hi = int(img_size * 0.5), int(img_size * 1.5)
    return sorted({max(gs, (s // gs) * gs) for s in range(lo, hi + 1, gs)})


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("hd_yolo_tpu_torch train")
    p.add_argument("--data", required=True, help="data yaml")
    p.add_argument("--cfg", default="yolov5l6-mask", help="model yaml")
    p.add_argument("--hyp", default="hyp-nuclei", help="hyp yaml")
    p.add_argument("--weights", default="", help="pretrained weights, a path or a bare name "
                   "searched in $HD_YOLO_WEIGHTS_DIR, <repo>/weights/ and the cache: a .pt of "
                   "this package, the reference (metayolo) or ultralytics, or a pickled flax "
                   "{'params', 'batch_stats'} tree")
    p.add_argument("--device", default="cuda", help="cuda (default; cuda:LOCAL_RANK under "
                   "torchrun) or cpu (gloo under torchrun)")
    p.add_argument("--dist-timeout", dest="dist_timeout", type=float, default=None,
                   help="seconds a collective may wait under torchrun (torch's default if unset)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=32,
                   help="the global batch size (each of N processes takes 1/N); -1 = fit "
                        "it to the card's memory (autobatch)")
    p.add_argument("--multi-scale", dest="multi_scale", action="store_true",
                   help="bucketized 0.5-1.5x image-size jitter per step")
    p.add_argument("--pretrain-val", dest="pretrain_val", action="store_true",
                   help="validate the EMA before epoch 0")
    p.add_argument("--nominal-batch-size", dest="nominal_batch_size", type=int, default=64)
    p.add_argument("--img-size", dest="img_size", type=int, default=640)
    p.add_argument("--patch-size", dest="patch_size", type=int, default=None)
    p.add_argument("--k-mosaic", dest="k_mosaic", type=int, default=2)
    p.add_argument("--keep-res", dest="keep_res", type=float, default=-1)
    p.add_argument("--masks", action="store_true")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--cos-lr", dest="cos_lr", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--async-ckpt", dest="async_ckpt", action="store_true",
                   help="write checkpoints in a background thread")
    p.add_argument("--save-interval", dest="save_interval", type=int, default=1,
                   help="write 'last' every N epochs (the final epoch always saves)")
    p.add_argument("--val-interval", dest="val_interval", type=int, default=1,
                   help="validate every N epochs (the final epoch always validates)")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device-augment", dest="device_augment", action="store_true",
                   help="run the augmentation recipe on the device inside the train step; "
                        "the loader serves raw tiles")
    p.add_argument("--cache-images", dest="cache_images", action="store_true",
                   help="keep decoded images in RAM")
    p.add_argument("--cache-device", dest="cache_device", action="store_true",
                   help="upload the raw train set to the device once and gather each batch "
                        "there by index (implies --cache-images and --device-augment)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bench-loop", dest="bench_loop", action="store_true",
                   help="reuse the first (device-resident) batch every step: the step's "
                        "ceiling with the data pipeline taken out")
    p.add_argument("--max-targets", dest="max_targets", type=int, default=256)
    p.add_argument("--mask-rois", dest="mask_rois", type=int, default=64)
    p.add_argument("--max-masks", dest="max_masks", type=int, default=100)
    p.add_argument("--save-dir", dest="save_dir", default="runs/train/exp")
    p.add_argument("--exist-ok", dest="exist_ok", action="store_true",
                   help="reuse --save-dir as it is instead of exp -> exp2")
    p.add_argument("--optimizer", choices=["sgd", "adam", "adamw"], default="sgd")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--plots", action="store_true",
                   help="display dumps and labels.jpg at the start, results.png at the end "
                        "(needs matplotlib)")
    p.add_argument("--autoanchor", action="store_true",
                   help="report the anchors' best possible recall on the val set")
    p.add_argument("--freeze", nargs="*", default=[],
                   help="parameter-name substrings to freeze, e.g. backbone.0. headers.")
    p.add_argument("--evolve", type=int, default=0, metavar="GENERATIONS",
                   help="GA hyperparameter evolution: one training a generation")
    return p


def evolve_hyp(opt) -> Dict[str, float]:
    """``--evolve N``: N trainings, each on a mutation of the best
    hyperparameters so far (the first on ``--hyp`` itself) under
    ``<save-dir>/gen_<i>``; ``<save-dir>/evolve/evolve.csv`` a row a
    generation and the best in ``<save-dir>/hyp_evolved.yaml``."""
    import copy

    from .evolve import evolve

    base_hyp = load_cfg(opt.hyp)

    def train_fn(hyp_flat):
        o = copy.deepcopy(opt)
        o.evolve = 0
        o.hyp = {**base_hyp, **{k: v for k, v in hyp_flat.items() if not isinstance(v, dict)}}
        n = len(os.listdir(opt.save_dir)) if os.path.isdir(opt.save_dir) else 0
        o.save_dir = os.path.join(opt.save_dir, f"gen_{n}")
        return train(o).get("best_fitness", 0.0)

    flat0 = {k: v for k, v in base_hyp.items() if isinstance(v, (int, float))}
    best_hyp, best_fit = evolve(train_fn, flat0, generations=opt.evolve,
                                save_dir=os.path.join(opt.save_dir, "evolve"))
    save_cfg({**base_hyp, **best_hyp}, os.path.join(opt.save_dir, "hyp_evolved.yaml"))
    LOGGER.info(f"evolution done: best fitness {best_fit:.4f}")
    return best_hyp


def main(argv=None):
    opt = argument_parser().parse_args(argv)
    owns_group = not parallel.is_initialized()
    try:
        return evolve_hyp(opt) if opt.evolve else train(opt)
    finally:
        if owns_group and parallel.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
