"""Misc training utilities (port of ``hd_yolo_tpu/utils/general.py``, the
part training uses)."""

from __future__ import annotations

import math

from .. import LOGGER


def check_img_size(img_size: int, stride: int = 32, floor: int = 0) -> int:
    """Round the image size up to a multiple of the max stride (warn and adjust)."""
    new = max(int(math.ceil(img_size / stride) * stride), floor)
    if new != img_size:
        LOGGER.warning(f"img_size {img_size} is not a multiple of stride {stride}; using {new}")
    return new
