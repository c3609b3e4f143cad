"""ROI-align on the card: wrappers of ``kernels/roi_align.cu`` (the Hopper
port of ``hd_yolo_tpu/ops/pallas_roi_align.py``'s canvas kernel) and
``kernels/roi_align_single.cu`` (the port of its single-level ``_kernel``).

``roi_align_bounded`` pools a flat ROI list from a level-stacked canvas.
Each ROI names its image and a window origin ``(oy, ox)`` in the canvas;
its sample coordinates and valid bounds come window-local.  A tap outside
the ``win_h x win_w`` window contributes nothing.  With the window set to
the whole canvas this is the exact canvas semantics; with a 16 x 16 window
it is the main path's packed pooling.

On a CUDA canvas it launches the kernel; on a CPU canvas it runs the plain
version, which builds the same interpolation matrices as the JAX package
(``_bounded_interp_matrix``), gathers each ROI's window and contracts them in
two einsums, with the JAX package's bf16 rounding points (matrices and the
row intermediate in the compute dtype, f32 accumulation).  The kernel keeps
everything in f32 until its single output write, so for bf16 it agrees with
the plain version to bf16 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .roi_align import _bounded_interp_matrix, roi_align

Tensor = torch.Tensor


def roi_align_bounded_plain(canvas: Tensor, meta: Tensor, ys: Tensor, xs: Tensor,
                            bounds: Tensor, window: Tuple[int, int], M: int, n: int) -> Tensor:
    win_h, win_w = window
    cd = torch.bfloat16 if canvas.dtype == torch.bfloat16 else torch.float32
    b, oy, ox = (meta[:, j].to(torch.int64) for j in range(3))
    Wy = _bounded_interp_matrix(ys, bounds[:, 0], bounds[:, 1], win_h, M, n).to(cd).float()
    Wx = _bounded_interp_matrix(xs, bounds[:, 2], bounds[:, 3], win_w, M, n).to(cd).float()
    rows = oy[:, None] + torch.arange(win_h, device=canvas.device)
    cols = ox[:, None] + torch.arange(win_w, device=canvas.device)
    patch = canvas[b[:, None, None], rows[:, :, None], cols[:, None, :]]   # (K, wh, ww, C)
    r = torch.einsum("ksh,khwc->kswc", Wy, patch.to(cd).float()).to(cd).float()
    out = torch.einsum("ktw,kswc->kstc", Wx, r)
    return out.to(canvas.dtype)


def roi_align_bounded(canvas: Tensor, meta: Tensor, ys: Tensor, xs: Tensor, bounds: Tensor,
                      window: Tuple[int, int], M: int, n: int) -> Tensor:
    """canvas (B, Ht, W0, C) f32|bf16; meta (K, 4) int32 (image, oy, ox, 0);
    ys/xs (K, M·n) f32 window-local; bounds (K, 4) f32 (lo_y, hi_y, lo_x,
    hi_x) window-local → (K, M, M, C) in the canvas dtype."""
    if canvas.device.type == "cpu":
        return roi_align_bounded_plain(canvas, meta, ys, xs, bounds, window, M, n)
    if canvas.dtype not in (torch.float32, torch.bfloat16) or canvas.shape[-1] % 2:
        raise ValueError(f"roi_align kernel takes an f32/bf16 canvas with even C, got "
                         f"{canvas.dtype} {tuple(canvas.shape)}")
    if M * n > 64:
        raise ValueError(f"roi_align kernel takes at most 64 samples per axis, got {M * n}")
    B, Ht, W0, C = canvas.shape
    K = meta.shape[0]
    canvas = canvas.contiguous()
    meta = meta.to(torch.int32).contiguous()
    ys, xs = ys.float().contiguous(), xs.float().contiguous()
    bounds = bounds.float().contiguous()
    kernels.require_cuda(canvas, meta, ys, xs, bounds)
    out = torch.empty((K, M, M, C), dtype=canvas.dtype, device=canvas.device)
    dev, stream = kernels.device_and_stream(canvas)
    code = kernels.fn("roi_align_bounded")(
        canvas.data_ptr(), meta.data_ptr(), ys.data_ptr(), xs.data_ptr(), bounds.data_ptr(),
        out.data_ptr(), K, Ht, W0, C, int(window[0]), int(window[1]), M, n,
        1 if canvas.dtype == torch.bfloat16 else 0, dev, stream)
    kernels.check(code, "roi_align_bounded")
    kernels.LAUNCHES["roi_align"] += 1
    return out


def roi_align_single(features: Tensor, boxes: Tensor, output_size: int,
                     spatial_scale: float = 1.0, sampling_ratio: int = 2,
                     aligned: bool = False) -> Tensor:
    """features (B, H, W, C) f32|bf16, any C; boxes (B, K, 4) xyxy in image
    coordinates → (B, K, M, M, C) in the features' dtype.  The kernel works
    in f32 until its single write, so for bf16 it agrees with the plain
    version (``ops/roi_align.roi_align``) to bf16 rounding."""
    if features.device.type == "cpu":
        return roi_align(features, boxes, output_size, spatial_scale, sampling_ratio, aligned)
    if features.dim() != 4 or features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align_single kernel takes (B, H, W, C) f32/bf16 features, got "
                         f"{features.dtype} {tuple(features.shape)}")
    B, H, W, C = features.shape
    if boxes.dim() != 3 or boxes.shape[0] != B or boxes.shape[2] != 4:
        raise ValueError(f"roi_align_single kernel takes ({B}, K, 4) boxes, got {tuple(boxes.shape)}")
    M, n = int(output_size), int(sampling_ratio)
    if min(H, W, C, M, n) < 1:
        raise ValueError(f"roi_align_single kernel takes positive sizes, got features "
                         f"{tuple(features.shape)}, output {M}, sampling {n}")
    K = boxes.shape[1]
    features = features.contiguous()
    boxes = boxes.float().contiguous()
    if boxes.data_ptr() % 16:                         # the kernel reads each box as a float4
        boxes = boxes.clone()
    kernels.require_cuda(features, boxes)
    out = torch.empty((B, K, M, M, C), dtype=features.dtype, device=features.device)
    dev, stream = kernels.device_and_stream(features)
    code = kernels.fn("roi_align_single")(
        features.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W, C, K, M, n,
        float(spatial_scale), 1 if aligned else 0,
        1 if features.dtype == torch.bfloat16 else 0, dev, stream)
    kernels.check(code, "roi_align_single")
    kernels.LAUNCHES["roi_align_single"] += 1
    return out
