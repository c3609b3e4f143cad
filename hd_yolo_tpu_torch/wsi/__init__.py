"""Whole-slide tiling and stitched inference (port of ``hd_yolo_tpu/wsi/``)."""

from .tiling import (  # noqa: F401
    extract_tiles,
    slide_inference,
    slide_inference_sharded,
    sliding_window_grid,
)
