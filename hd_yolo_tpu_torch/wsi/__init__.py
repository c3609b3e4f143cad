"""Whole-slide tiling (port of ``hd_yolo_tpu/wsi/``): so far only the tile
grid that hnet's detection header uses."""
