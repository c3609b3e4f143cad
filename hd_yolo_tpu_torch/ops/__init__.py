"""Box, NMS and ROI-align ops, and the wrappers of the hand-written CUDA kernels."""
