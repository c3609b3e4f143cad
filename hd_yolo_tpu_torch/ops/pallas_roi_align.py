"""Bounded multiscale ROI-align on the card: wrapper of ``kernels/roi_align.cu``
(the Hopper port of ``hd_yolo_tpu/ops/pallas_roi_align.py``'s canvas kernel).

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
from .roi_align import _bounded_interp_matrix

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
