"""Multi-task detection dataset: CSV index → padded batches (port of
``hd_yolo_tpu/data/dataset.py``).

CSV rows ``image_path,image_id,ann_id,ann_path,task_id,mask_mode`` map
images to annotation files (``.npz`` or a torch ``.pt`` of {boxes, labels,
masks, size}), cached in memory.  A validation sample (``train=False``) is
the image resized to ``img_size`` (or, with ``keep_res`` > 0, rescaled by
that factor and center padded / cropped).  A training sample is a k x k
mosaic of the image and random partners, each tile through the host
augmentation chain (``data/augment.py``), cropped at random to
``img_size``, optionally mixed up with a second mosaic (``hyp['mixup']``);
``host_augment=False`` serves the resized tile with no augmentation instead
(the raw mode the device recipe, ``data/device_augment.py``, takes; with
``cache_images`` the padded raw sample itself is cached).
Every task's targets are padded to ``max_targets`` under a validity mask:
normalized xyxy boxes, labels and 28x28 in-box masks.  Batches are plain
stacked numpy arrays; images stay uint8 and the model divides by 255 on the
device.

The training draws come from the dataset's own ``AugRng`` (seeded by
``seed``), in the JAX package's order of its global ``random`` /
``np.random`` draws.  OpenCV and pandas are imported inside the functions
that use them.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import LOGGER
from .augment import AugRng, mixup, train_proc_multi
from .mask import Mask

Ann = Dict[str, object]
MASK_SIZE = 28  # the in-box training / validation mask


def load_annotation_file(path: str) -> Dict[str, np.ndarray]:
    """Load {boxes, labels, masks, size} from .npz (native) or .pt (torch)."""
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        return {k: z[k] for k in z.files}
    if path.endswith((".pt", ".pth")):
        import torch

        d = torch.load(path, map_location="cpu", weights_only=False)
        return {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in d.items()}
    raise ValueError(f"unsupported annotation format: {path}")


class DetectionDataset:
    """CSV-indexed multi-task dataset producing padded samples.

    ``data``: the csv index path (``root`` defaults to its directory) or a
    list of its rows as dicts.  ``hyp``: ``img_size`` (640), ``keep_res``
    (-1: off) and, for training, ``patch_size`` (the mosaic tile, default
    ``img_size``), ``k_mosaic`` (2), ``mixup`` and the augmentation keys of
    ``data/augment.train_proc_multi``."""

    def __init__(self, data, hyp: Dict, train: bool = True, max_targets: int = 256,
                 root: Optional[str] = None, host_augment: bool = True, seed: int = 0,
                 cache_images: bool = False):
        self.hyp = dict(hyp)
        self.train = train
        self.max_targets = max_targets
        self.img_size = int(self.hyp.get("img_size", 640))
        self.patch_size = int(self.hyp.get("patch_size") or self.img_size)
        self.k_mosaic = int(self.hyp.get("k_mosaic", 2)) if train else 1
        self.keep_res = float(self.hyp.get("keep_res", -1))
        self.host_augment = bool(host_augment)
        self.rng = AugRng(seed)
        self._img_cache: Optional[Dict[int, np.ndarray]] = {} if cache_images else None
        self._sample_cache: Dict[int, Dict[str, object]] = {}

        self.root = root or "./"
        if isinstance(data, str):
            import pandas as pd

            self.root = root or os.path.dirname(data)
            data = pd.read_csv(data).to_dict("records")
        self.images: List[dict] = []
        self.annotations: List[dict] = []
        self.ann_cache: List[dict] = []
        id_map: Dict[object, int] = {}
        for ann_idx, info in enumerate(data):
            image_id = info["image_id"]
            if image_id not in id_map:
                id_map[image_id] = len(self.images)
                self.images.append(
                    {"image_id": image_id, "image_path": info["image_path"], "anns": []})
            img_pos = id_map[image_id]
            self.annotations.append({**info, "image_idx": img_pos})
            self.images[img_pos]["anns"].append(ann_idx)
            self.ann_cache.append(self._load_annotation(ann_idx))

        self.task_ids = sorted({a["task_id"] for a in self.annotations})

    # ------------------------------------------------------------------ loading
    def __len__(self) -> int:
        return len(self.images)

    def _load_annotation(self, ann_idx: int) -> dict:
        info = self.annotations[ann_idx]
        raw = load_annotation_file(os.path.join(self.root, info["ann_path"]))
        size = tuple(int(s) for s in np.asarray(raw["size"]).reshape(-1)[:2])
        mode = info.get("mask_mode", "poly")
        masks_raw = raw.get("masks", None)
        masks: List[Optional[Mask]] = []
        n = len(np.asarray(raw["boxes"]).reshape(-1, 4))
        if masks_raw is None:
            masks = [None] * n
        else:
            for m in list(masks_raw)[:n]:
                masks.append(Mask(m, size, mode) if m is not None and len(np.atleast_1d(m)) else None)
            masks += [None] * (n - len(masks))
        return {
            "boxes": np.asarray(raw["boxes"], np.float32).reshape(-1, 4),
            "labels": np.asarray(raw["labels"], np.int64).reshape(-1),
            "masks": masks,
            "size": size,
        }

    def load_image_and_target(self, idx: int) -> Tuple[np.ndarray, Dict[str, Ann]]:
        import cv2

        info = self.images[idx]
        img = None if self._img_cache is None else self._img_cache.get(idx)
        if img is None:
            img = cv2.imread(os.path.join(self.root, info["image_path"]))
            if img is None:
                raise FileNotFoundError(info["image_path"])
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if self._img_cache is not None:         # decoded once, copied per use
                img.setflags(write=False)
                self._img_cache[idx] = img
        if self._img_cache is not None:
            img = img.copy()
        anns: Dict[str, Ann] = {}
        for ann_idx in info["anns"]:
            task = self.annotations[ann_idx]["task_id"]
            a = self.ann_cache[ann_idx]
            if task in anns:  # merge multiple annotation groups of one task
                anns[task] = _merge_anns(anns[task], a)
            else:
                anns[task] = {k: (list(v) if k == "masks" else np.copy(v)
                                  if isinstance(v, np.ndarray) else v)
                              for k, v in a.items()}
        return img, anns

    # ----------------------------------------------------------------- geometry
    @staticmethod
    def _scaled(img: np.ndarray, anns: Dict[str, Ann], nh: int, nw: int):
        """``img`` resized to (nh, nw) bilinearly, boxes and masks with it."""
        import cv2

        h, w = img.shape[:2]
        sy, sx = nh / h, nw / w
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        out = {}
        for task, a in anns.items():
            boxes = np.asarray(a["boxes"], np.float32) * [sx, sy, sx, sy]
            masks = [m.rescale(sy, sx, (nh, nw)) if m is not None else None
                     for m in a.get("masks", [None] * len(boxes))]
            out[task] = {"boxes": boxes, "labels": np.asarray(a["labels"]), "masks": masks}
        return img, out

    @staticmethod
    def _resize(img: np.ndarray, anns: Dict[str, Ann], size: int):
        if img.shape[:2] == (size, size):
            return img, anns
        return DetectionDataset._scaled(img, anns, size, size)

    @staticmethod
    def _rescale(img: np.ndarray, anns: Dict[str, Ann], scale: float):
        """Scale by a fixed factor (``keep_res``: a fixed µm/px)."""
        h, w = img.shape[:2]
        nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
        if (nh, nw) == (h, w):
            return img, anns
        return DetectionDataset._scaled(img, anns, nh, nw)

    def _pad_or_crop(self, img: np.ndarray, anns: Dict[str, Ann], size: int, pos: str = "center",
                     cval: int = 114):
        """Pad and/or crop to a square ``size`` (centred, or at a random
        offset with ``pos='random'``), annotations with it."""
        h, w = img.shape[:2]
        ph, pw = max(size - h, 0), max(size - w, 0)
        if ph or pw:
            if pos == "random":
                top, left = self.rng.py.randint(0, ph), self.rng.py.randint(0, pw)
            else:
                top, left = ph // 2, pw // 2
            canvas = np.full((max(h + ph, size), max(w + pw, size), 3), cval, img.dtype)
            canvas[top: top + h, left: left + w] = img
            img = canvas
            anns = self._shift(anns, top, left, img.shape[:2])
            h, w = img.shape[:2]
        ch, cw = max(h - size, 0), max(w - size, 0)
        if ch or cw:
            if pos == "random":
                y0, x0 = self.rng.py.randint(0, ch), self.rng.py.randint(0, cw)
            else:
                y0, x0 = ch // 2, cw // 2
            img = img[y0: y0 + size, x0: x0 + size]
            anns = self._shift(anns, -y0, -x0, (size, size))
            for a in anns.values():
                a["boxes"] = np.clip(a["boxes"], 0, [size, size, size, size])
        return np.ascontiguousarray(img), anns

    @staticmethod
    def _shift(anns: Dict[str, Ann], dy: int, dx: int, size) -> Dict[str, Ann]:
        out = {}
        for task, a in anns.items():
            boxes = np.asarray(a["boxes"], np.float32) + [dx, dy, dx, dy]
            masks = [m.pad(dy, dx, size) if m is not None else None
                     for m in a.get("masks", [None] * len(boxes))]
            out[task] = {"boxes": boxes, "labels": np.asarray(a["labels"]), "masks": masks}
        return out

    # ---------------------------------------------------------------- get item
    def __getitem__(self, idx: int) -> Dict[str, object]:
        if self.train and not self.host_augment:
            return self._raw_sample(idx)
        if self.train:
            img, anns = self._train_sample(idx)
            if self.rng.py.random() < float(self.hyp.get("mixup", 0.0)):
                img2, anns2 = self._train_sample(self.rng.py.randrange(len(self)))
                img, anns = mixup(img, anns, img2, anns2, self.rng)
            return self._to_padded(img, anns)
        return self._to_padded(*self._fixed_tile(idx))

    def _fixed_tile(self, idx: int):
        """The image and its annotations resized to ``img_size`` (or, with
        ``keep_res``, rescaled and center padded / cropped)."""
        img, anns = self.load_image_and_target(idx)
        if self.keep_res > 0:  # fixed µm/px: rescale + center pad/crop
            img, anns = self._rescale(img, anns, self.keep_res)
            return self._pad_or_crop(img, anns, self.img_size)
        return self._resize(img, anns, self.img_size)

    def _raw_sample(self, idx: int) -> Dict[str, object]:
        """A training sample with no augmentation: the resized tile and its
        padded targets, with no small-object filter (the device recipe
        applies it after its warp); cached whole with ``cache_images``."""
        sample = self._sample_cache.get(idx)
        if sample is None:
            sample = self._to_padded(*self._fixed_tile(idx), small_filter=False)
            if self._img_cache is not None:
                self._sample_cache[idx] = sample
        return sample

    def _train_sample(self, idx: int):
        """A k x k mosaic of ``idx`` and k²−1 random partners, each tile
        augmented, cropped at random to ``img_size``."""
        k, size, rng = self.k_mosaic, self.patch_size, self.rng
        indices = [idx] + rng.py.choices(range(len(self)), k=k * k - 1)
        rng.py.shuffle(indices)
        merged: Dict[str, dict] = {}
        canvas = np.full((k * size, k * size, 3), 114, np.uint8)
        for rc, img_idx in enumerate(indices):
            r, c = rc // k, rc % k
            img, anns = self.load_image_and_target(img_idx)
            if self.keep_res > 0:  # resolution-preserving tile prep
                img, anns = self._rescale(img, anns, self.keep_res)
                img, anns = self._pad_or_crop(img, anns, size, pos="random")
            else:
                img, anns = self._resize(img, anns, size)
            img, anns = train_proc_multi(img, anns, self.hyp, rng)
            canvas[r * size: (r + 1) * size, c * size: (c + 1) * size] = img
            for task, a in self._shift(anns, r * size, c * size, (k * size, k * size)).items():
                m = merged.setdefault(task, {"boxes": [], "labels": [], "masks": []})
                m["boxes"].append(a["boxes"])
                m["labels"].append(a["labels"])
                m["masks"].extend(a["masks"])
        anns = {t: {"boxes": np.concatenate(v["boxes"]) if v["boxes"] else np.zeros((0, 4), np.float32),
                    "labels": np.concatenate(v["labels"]) if v["labels"] else np.zeros((0,), np.int64),
                    "masks": v["masks"]}
                for t, v in merged.items()}
        H = canvas.shape[0]
        if H > self.img_size:
            y0 = rng.py.randint(0, H - self.img_size)
            x0 = rng.py.randint(0, H - self.img_size)
            canvas = canvas[y0: y0 + self.img_size, x0: x0 + self.img_size]
            anns = self._shift(anns, -y0, -x0, (self.img_size, self.img_size))
            for a in anns.values():
                a["boxes"] = np.clip(a["boxes"], 0, [self.img_size] * 4)
        return canvas, anns

    def _to_padded(self, img: np.ndarray, anns: Dict[str, Ann],
                   small_filter: bool = True) -> Dict[str, object]:
        """Pad every task's annotations to max_targets; 28×28 in-box masks."""
        H, W = img.shape[:2]
        T, M = self.max_targets, MASK_SIZE
        targets = {}
        for task in self.task_ids:
            boxes = np.zeros((T, 4), np.float32)
            labels = np.zeros((T,), np.int64)
            masks = np.zeros((T, M, M), np.float32)
            valid = np.zeros((T,), bool)
            a = anns.get(task)
            if a is not None and len(a["boxes"]):
                b = np.asarray(a["boxes"], np.float32)
                l = np.asarray(a["labels"], np.int64)
                keep = ((b[:, 2] - b[:, 0] > 10) & (b[:, 3] - b[:, 1] > 10) if small_filter
                        else np.ones(len(b), bool))                       # small-object filter
                b, l = b[keep], l[keep]
                mlist = [m for m, k2 in zip(a["masks"], keep) if k2]
                n = min(len(b), T)
                if len(b) > T:
                    LOGGER.debug(f"truncating {len(b)} targets to {T}")
                boxes[:n] = b[:n] / [W, H, W, H]  # normalized xyxy
                labels[:n] = l[:n]
                valid[:n] = True
                for i in range(n):
                    if mlist[i] is not None:
                        masks[i] = mlist[i].box_crop(b[i], M).astype(np.float32)
            targets[task] = {
                "boxes": boxes, "labels": labels, "masks": masks,
                "valid": valid, "active": np.asarray(a is not None),
            }
        image = (np.ascontiguousarray(img) if img.dtype == np.uint8
                 else img.astype(np.float32) / 255.0)
        return {"image": image, "targets": targets}


def _merge_anns(a: Ann, b: Ann) -> Ann:
    return {
        "boxes": np.concatenate([np.asarray(a["boxes"]).reshape(-1, 4),
                                 np.asarray(b["boxes"]).reshape(-1, 4)]),
        "labels": np.concatenate([np.asarray(a["labels"]), np.asarray(b["labels"])]),
        "masks": list(a.get("masks", [])) + list(b.get("masks", [])),
        "size": a.get("size"),
    }


def collate_padded(samples: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """Stack padded samples into one batch of the same schema (also the
    whole raw-mode set at once, for a device-resident upload)."""
    batch = {"image": np.stack([s["image"] for s in samples])}
    tasks = samples[0]["targets"].keys()
    batch["targets"] = {
        t: {k: np.stack([s["targets"][t][k] for s in samples]) for k in samples[0]["targets"][t]}
        for t in tasks
    }
    return batch


class DataLoader:
    """Prefetching loader: background threads run ``dataset[i]`` (OpenCV
    releases the GIL for the heavy work) and batches come out in order.  A
    failure in a worker is raised in the caller.  ``shuffle`` draws each
    epoch's order from ``random.Random(seed + epoch)``; ``infinite`` runs
    epoch after epoch (the training loader); ``drop_last`` drops a partial
    last batch.  ``shard=(rank, world)``: this process's slice of each
    epoch's order, ``idx[rank::world]`` — every rank shuffles with the same
    seed, so the slices are disjoint and cover the epoch."""

    def __init__(self, dataset: DetectionDataset, batch_size: int = 8, workers: int = 4,
                 drop_last: bool = True, shuffle: bool = False, infinite: bool = False,
                 seed: int = 0, shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(workers, 1)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.infinite = infinite
        self.seed = seed
        self.shard = shard if shard and shard[1] > 1 else None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.shard:
            rank, world = self.shard
            n = (n - rank + world - 1) // world
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(idx)
        if self.shard:
            rank, world = self.shard
            idx = idx[rank::world]
        return idx[: len(self) * self.batch_size] if self.drop_last else idx

    def __iter__(self) -> Iterator[Dict[str, object]]:
        epoch = 0
        while True:
            yield from self._epoch(self._epoch_indices(epoch))
            if not self.infinite:
                return
            epoch += 1

    def _epoch(self, indices: List[int]) -> Iterator[Dict[str, object]]:
        batches = [indices[i: i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.workers * 2)
        stop = threading.Event()

        def producer():
            try:
                if self.workers > 1:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(self.workers) as ex:
                        for bidx in batches:
                            if stop.is_set():
                                break
                            q.put(collate_padded(list(ex.map(self.dataset.__getitem__, bidx))))
                else:
                    for bidx in batches:
                        if stop.is_set():
                            break
                        q.put(collate_padded([self.dataset[i] for i in bidx]))
                q.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():          # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
