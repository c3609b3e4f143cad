"""User-facing inference API (port of ``hd_yolo_tpu/detector.py``): accept
numpy/PIL/path inputs of any size, letterbox to the model frame, run the
model on the card, rescale boxes back, export records or a DataFrame, and
draw them (``Detections.render``).

``Detector(..., device="cuda")`` is the default and raises when CUDA is
missing; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the CPU.  ``Detector.slide`` runs tiled whole-slide inference
with the stitched global NMS.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .data.preproc import letterbox_batch, normalize
from .engines.checkpoint import load_inference
from .models.yolo import Model
from .ops.boxes import scale_coords


class Detections:
    """Per-image results holder with record / DataFrame exports."""

    def __init__(self, records: List[Dict[str, Dict[str, np.ndarray]]],
                 images: List[np.ndarray], labels_text: Optional[Dict[int, str]] = None):
        self.records = records
        self.images = images
        self.labels_text = labels_text or {}

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]

    def to_records(self, task: Optional[str] = None) -> List[Dict[str, Any]]:
        rows = []
        for i, rec in enumerate(self.records):
            for t, o in rec.items():
                if task and t != task:
                    continue
                for b, s, l in zip(o["boxes"], o["scores"], o["labels"]):
                    rows.append({
                        "image": i, "task": t,
                        "xmin": float(b[0]), "ymin": float(b[1]),
                        "xmax": float(b[2]), "ymax": float(b[3]),
                        "confidence": float(s), "class": int(l),
                        "name": self.labels_text.get(int(l), str(int(l))),
                    })
        return rows

    def pandas(self, task: Optional[str] = None):
        import pandas as pd

        return pd.DataFrame(self.to_records(task))

    def render(self, i: int = 0, task: Optional[str] = None) -> np.ndarray:
        """Image ``i`` with its boxes, labels, scores and in-box masks drawn
        (``engines/plots.overlay_detections``, OpenCV)."""
        from .engines.plots import overlay_detections

        rec = self.records[i]
        t = task or next(iter(rec))
        o = rec[t]
        return overlay_detections(
            self.images[i], o["boxes"], o["labels"], o["scores"], o.get("masks"),
            labels_text=self.labels_text,
        )


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA when no card is there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA device; none is available. "
                           "Pass device='cpu' to run the plain PyTorch path.")
    return device


class Detector:
    """Any-input inference wrapper around a model.

    Weights: ``weights`` names an inference checkpoint
    (``engines/checkpoint.load_inference``: a ``.pt`` state_dict, this
    package's or the reference's, or a pickled flax
    ``{'params', 'batch_stats'}`` tree); without
    it the model gets seeded random weights (``seed``).  ``dtype`` is the
    compute dtype (bf16 by default); parameters stay f32 masters.
    ``mask_budget`` None (the default, as the JAX ``Model``) runs the
    per-image mask branch: a mask for each of the top ``max_masks`` (100)
    detections of every image.  An integer selects the occupancy-packed
    branch with that cross-batch ROI budget (``mask_budget=768`` is how the
    flagship benchmark runs it); detections past the budget get no mask.
    ``model_kwargs`` go to ``Model`` (``pre_nms_topk``, ``max_masks``,
    ``mask_window``).
    """

    def __init__(self, cfg: Union[str, dict] = "yolov5l6-mask", hyp: Union[str, dict] = "hyp-nuclei",
                 weights: Optional[str] = None, input_size: int = 640,
                 dtype: torch.dtype = torch.bfloat16, labels_text: Optional[Dict[int, str]] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda",
                 mask_budget: Optional[int] = None, **model_kwargs):
        self.device = resolve_device(device)
        self.model = Model.from_cfg(cfg, hyp, dtype=dtype, mask_budget=mask_budget,
                                    **model_kwargs)
        if weights:
            load_inference(weights, self.model)
        else:
            self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.eval().to(self.device)
        self.input_size = input_size
        self.labels_text = labels_text or {}

    @staticmethod
    def _to_numpy(im) -> np.ndarray:
        if isinstance(im, str):
            import cv2

            arr = cv2.imread(im)
            if arr is None:
                raise FileNotFoundError(f"cannot read {im}")
            return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        if hasattr(im, "convert"):  # PIL
            return np.asarray(im.convert("RGB"))
        return np.asarray(im)

    def tiles(self, batch: Union[np.ndarray, torch.Tensor], compute_masks: bool = True):
        """A batch of model-sized tiles (B, S, S, 3), uint8 or float in [0, 1],
        straight through the model on the card → {task: output tensors}."""
        x = torch.as_tensor(batch).to(self.device)
        return self.model(x, compute_masks=compute_masks)

    def __call__(self, images: Union[Any, Sequence[Any]], compute_masks: bool = True,
                 task: Optional[str] = None) -> Detections:
        """Run every header on each image; ``task`` filters the returned
        records to one header."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        arrs = [self._to_numpy(im) for im in images]
        records: List[Dict[str, Dict[str, np.ndarray]]] = []
        S = self.input_size
        for a in arrs:
            h, w = a.shape[:2]
            x = normalize(torch.from_numpy(np.ascontiguousarray(a))[None].to(self.device))
            padded, gain, (px, py) = letterbox_batch(x, (S, S))
            out = self.model(padded, compute_masks=compute_masks)
            rec: Dict[str, Dict[str, np.ndarray]] = {}
            for t, o in out.items():
                v = o["valid"][0].cpu().numpy()
                boxes = scale_coords((S, S), o["boxes"][0].float(), (h, w),
                                     ratio_pad=((gain, gain), (px, py))).cpu().numpy()
                entry = {
                    "boxes": boxes[v],
                    "scores": o["scores"][0].float().cpu().numpy()[v],
                    "labels": o["labels"][0].cpu().numpy()[v],
                }
                if "masks" in o:
                    # masks cover the first R (score-ordered) detections; pad to
                    # full capacity so rows stay aligned with boxes[v]
                    m = o["masks"][0].cpu().numpy()
                    R, D = m.shape[0], v.shape[0]
                    mfull = np.zeros((D,) + m.shape[1:], m.dtype)
                    mfull[:R] = m
                    hm = np.zeros((D,), bool)
                    hm[:R] = o["mask_valid"][0].cpu().numpy()
                    entry["masks"] = mfull[v]
                    entry["has_mask"] = hm[v]
                rec[t] = entry
            if task is not None:
                rec = {task: rec[task]}
            records.append(rec)
        return Detections(records, arrs, self.labels_text)

    def slide(self, image: Any, task: Optional[str] = None, tile: Optional[int] = None,
              overlap: int = 64, batch: int = 8, compute_masks: bool = True, fused: bool = True,
              mask_uint8: bool = False, iou_thres: float = 0.45,
              max_total: int = 4096) -> Detections:
        """Tiled whole-slide inference with the stitched global NMS.

        The slide goes to the device once (uint8 stays uint8: the model
        normalizes at entry), tiles are gathered there, and detections come
        back in slide coords (``wsi/tiling.slide_inference``).  A slide
        smaller than one tile is padded to it; detections that start inside
        the pad are dropped and boxes are clipped to the slide.  Returns a
        one-record :class:`Detections` (record key = ``task``)."""
        from .wsi.tiling import slide_inference

        arr = self._to_numpy(image)
        tile = tile or self.input_size
        task = task or self.model.spec.headers[0].tag
        h, w = arr.shape[:2]
        if h < tile or w < tile:  # small slides: pad to one full tile
            arr = np.pad(arr, ((0, max(0, tile - h)), (0, max(0, tile - w)), (0, 0)))
        out = slide_inference(
            lambda t: self.model(t, compute_masks=compute_masks)[task],
            torch.from_numpy(np.ascontiguousarray(arr)).to(self.device),
            tile=tile, overlap=overlap, batch=batch, iou_thres=iou_thres, max_total=max_total,
            mask_uint8=mask_uint8, fused=fused)
        # drop detections that only exist inside the small-slide pad
        v = out["valid"] & (out["boxes"][:, 0] < w) & (out["boxes"][:, 1] < h)
        entry: Dict[str, np.ndarray] = {
            "boxes": np.minimum(out["boxes"][v], [w, h, w, h]),
            "scores": out["scores"][v],
            "labels": out["labels"][v],
        }
        if "masks" in out:
            entry["masks"] = out["masks"][v]
            entry["has_mask"] = out["mask_valid"][v]
        return Detections([{task: entry}], [arr[:h, :w]], self.labels_text)
