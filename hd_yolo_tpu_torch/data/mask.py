"""Tri-modal instance mask container: polygon / RLE / binary mask (port of
``hd_yolo_tpu/data/mask.py``).

The COCO uncompressed-RLE codec is numpy (column-major run lengths starting
with the zero run, as pycocotools writes them).  The JAX package takes its
C++ codec under ``native/`` when that is built; both give the same runs,
and ``tests/test_torch_data.py`` holds this one to whichever the JAX package
takes.  The OpenCV operations (polygon fill and contours, rescale, warp,
the 28x28 box crop) import ``cv2`` inside the function, so the module
imports without it.  Host-side code: masks are built at data-loading time.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def rle_encode(mask: np.ndarray) -> Dict[str, object]:
    """Binary (h, w) mask → COCO uncompressed RLE {'size': [h, w], 'counts': [...]}."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F").astype(np.int8)
    changes = np.flatnonzero(np.diff(flat))
    idx = np.concatenate([[0], changes + 1, [len(flat)]])
    counts = np.diff(idx).tolist()
    if flat[0] == 1:  # RLE starts with the run of zeros
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_decode(rle: Dict[str, object]) -> np.ndarray:
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if len(flat) < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - len(flat), np.uint8)])
    return flat[: h * w].reshape((h, w), order="F")


def polygons_to_mask(polygons: Sequence[np.ndarray], size) -> np.ndarray:
    """List of (K, 2) xy float arrays → binary (h, w) mask (cv2.fillPoly fast
    path, image_utils.py:376-381)."""
    import cv2

    m = np.zeros(tuple(size), np.uint8)
    pts = [np.round(np.asarray(p)).astype(np.int32).reshape(-1, 2) for p in polygons if len(p)]
    if pts:
        cv2.fillPoly(m, pts, 1)
    return m


def mask_to_polygons(mask: np.ndarray) -> List[np.ndarray]:
    """Binary mask → list of (K, 2) xy contours."""
    import cv2

    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    return [c.reshape(-1, 2).astype(np.float32) for c in contours if len(c) >= 3]


class Mask:
    """One object's mask in 'poly' | 'rle' | 'mask' mode with lazy conversion.

    ``data``:
      * poly: list of (K, 2) float arrays (absolute xy),
      * rle:  {'size': [h, w], 'counts': [...]},
      * mask: (h, w) binary array.
    ``size``: the (h, w) canvas the mask lives on.
    """

    def __init__(self, data, size, mode: str = "poly"):
        self.size = tuple(int(s) for s in size)
        self.mode = mode
        if mode == "poly":
            self.data = [np.asarray(p, np.float32).reshape(-1, 2) for p in (data or [])]
        elif mode == "rle":
            self.data = data
        elif mode == "mask":
            self.data = np.asarray(data)
        else:
            raise ValueError(f"unknown mask mode {mode!r}")

    # ------------------------------------------------------------- conversion
    def mask(self) -> "Mask":
        if self.mode == "mask":
            return self
        if self.mode == "poly":
            return Mask(polygons_to_mask(self.data, self.size), self.size, "mask")
        return Mask(rle_decode(self.data), self.size, "mask")

    def poly(self) -> "Mask":
        if self.mode == "poly":
            return self
        return Mask(mask_to_polygons(self.mask().m), self.size, "poly")

    def rle(self) -> "Mask":
        if self.mode == "rle":
            return self
        return Mask(rle_encode(self.mask().m), self.size, "rle")

    @property
    def m(self) -> np.ndarray:
        if self.mode != "mask":
            raise ValueError(f"Mask.m needs mode 'mask', this one is {self.mode!r}")
        return self.data

    # -------------------------------------------------------------- geometry
    def box(self) -> np.ndarray:
        """xyxy bounding box."""
        if self.mode == "poly":
            if not self.data:
                return np.zeros(4, np.float32)
            pts = np.concatenate(self.data)
            return np.array(
                [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()], np.float32
            )
        m = self.mask().m
        ys, xs = np.where(m)
        if len(ys) == 0:
            return np.zeros(4, np.float32)
        return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1], np.float32)

    def area(self) -> float:
        return float(self.mask().m.sum())

    def pad(self, top: int, left: int, new_size) -> "Mask":
        if self.mode == "poly":
            return Mask([p + [left, top] for p in self.data], new_size, "poly")
        m = np.zeros(tuple(new_size), np.uint8)
        src = self.mask().m
        m[top : top + src.shape[0], left : left + src.shape[1]] = src
        return Mask(m, new_size, "mask")

    def crop(self, y0: int, x0: int, h: int, w: int) -> "Mask":
        if self.mode == "poly":
            return Mask([p - [x0, y0] for p in self.data], (h, w), "poly")
        src = self.mask().m
        canvas = np.zeros((h, w), np.uint8)
        ys, ye = max(y0, 0), min(y0 + h, src.shape[0])
        xs, xe = max(x0, 0), min(x0 + w, src.shape[1])
        if ys < ye and xs < xe:
            canvas[ys - y0 : ye - y0, xs - x0 : xe - x0] = src[ys:ye, xs:xe]
        return Mask(canvas, (h, w), "mask")

    def rescale(self, scale_y: float, scale_x: float, new_size) -> "Mask":
        if self.mode == "poly":
            return Mask([p * [scale_x, scale_y] for p in self.data], new_size, "poly")
        import cv2

        m = cv2.resize(
            self.mask().m, (int(new_size[1]), int(new_size[0])), interpolation=cv2.INTER_NEAREST
        )
        return Mask(m, new_size, "mask")

    def flip(self, horizontal: bool = False, vertical: bool = False) -> "Mask":
        h, w = self.size
        if self.mode == "poly":
            out = []
            for p in self.data:
                q = p.copy()
                if horizontal:
                    q[:, 0] = w - q[:, 0]
                if vertical:
                    q[:, 1] = h - q[:, 1]
                out.append(q)
            return Mask(out, self.size, "poly")
        m = self.mask().m
        if horizontal:
            m = m[:, ::-1]
        if vertical:
            m = m[::-1]
        return Mask(np.ascontiguousarray(m), self.size, "mask")

    def transpose(self) -> "Mask":
        if self.mode == "poly":
            return Mask([p[:, ::-1] for p in self.data], self.size[::-1], "poly")
        return Mask(self.mask().m.T, self.size[::-1], "mask")

    def warp(self, matrix: np.ndarray, new_size) -> "Mask":
        """Projective warp by a 3×3 matrix."""
        if self.mode == "poly":
            out = []
            for p in self.data:
                hom = np.concatenate([p, np.ones((len(p), 1), np.float32)], 1)
                q = hom @ matrix.T
                out.append((q[:, :2] / np.maximum(q[:, 2:3], 1e-9)).astype(np.float32))
            return Mask(out, new_size, "poly")
        import cv2

        m = cv2.warpPerspective(
            self.mask().m, matrix, (int(new_size[1]), int(new_size[0])),
            flags=cv2.INTER_NEAREST,
        )
        return Mask(m, new_size, "mask")

    def box_crop(self, box: np.ndarray, out_size: int = 28, order: int = 1) -> np.ndarray:
        """(out, out) float mask cropped to ``box`` — the 28×28 training target
        (datasets.py:462-519 target_to_tensors)."""
        import cv2

        interp = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR, 3: cv2.INTER_CUBIC}[order]
        m = self.mask().m.astype(np.float32)
        if m.sum() < 25:  # ignore tiny artifacts (reference threshold)
            return np.zeros((out_size, out_size), np.float32)
        x0, y0, x1, y1 = np.round(np.asarray(box)).astype(np.int64)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, m.shape[1]), min(y1, m.shape[0])
        if x1 <= x0 or y1 <= y0:
            return np.zeros((out_size, out_size), np.float32)
        return cv2.resize(m[y0:y1, x0:x1], (out_size, out_size), interpolation=interp)
