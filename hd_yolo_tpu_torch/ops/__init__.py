"""Box, NMS, ROI-align and paste ops, and the wrappers of the hand-written CUDA kernels."""

from .paste import paste_masks_in_image  # noqa: F401
