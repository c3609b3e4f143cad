"""Slide tiling (port of ``hd_yolo_tpu/wsi/tiling.py``): the sliding-window
tile grid.  Slide inference and the stitch are not ported yet."""

from __future__ import annotations

import numpy as np


def sliding_window_grid(h: int, w: int, tile: int = 640, overlap: int = 64) -> np.ndarray:
    """(N, 2) int32 (y, x) tile origins covering an h×w slide.

    Stride = tile − overlap; the final row/col snaps inward so tiles never
    cross the border (full static tile shapes)."""
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be smaller than the tile {tile}")

    def starts(size):
        if size <= tile:
            return [0]
        s = list(range(0, size - tile, stride))
        s.append(size - tile)
        return s

    return np.asarray([(y, x) for y in starts(h) for x in starts(w)], np.int32)
