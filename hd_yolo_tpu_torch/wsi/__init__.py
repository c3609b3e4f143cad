"""Whole-slide tiling and stitched inference (port of ``hd_yolo_tpu/wsi/``)."""

from .tiling import extract_tiles, slide_inference, sliding_window_grid  # noqa: F401
