"""ROI-align on the card: wrappers of ``kernels/roi_align.cu`` (the Hopper
port of ``hd_yolo_tpu/ops/pallas_roi_align.py``'s canvas kernel) and
``kernels/roi_align_single.cu`` (the port of its single-level ``_kernel``).

``roi_align_bounded`` pools a flat ROI list from the pyramid's level maps
where they lie, with no stacked canvas.  Each ROI names its image, its level
and a window origin ``(oy, ox)`` in level-stacked (canvas) coordinates, in
which level ``l`` occupies rows ``[moff_l, moff_l + H_l)`` (``moff_l`` the
heights of the levels before it) and columns ``[0, W_l)``; its sample
coordinates and valid bounds come window-local.  A contributing tap's canvas
row ``r`` is level row ``r - moff_l``: the bounds give every other canvas
cell zero weight, so this is the canvas function exactly.  A tap outside the
``win_h x win_w`` window contributes nothing.  With the window set to the
whole canvas this is the exact canvas semantics; with a 16 x 16 window it is
the main path's packed pooling.  ``active`` (a 0-d integer tensor on the
device) pools only the leading ROIs and writes 0 to the rest; ``None`` pools
all of them.

On CUDA levels it launches the kernel; on CPU levels it runs the plain
version, which builds the same interpolation matrices as the JAX package
(``_bounded_interp_matrix``), gathers each ROI's window from its level with
the same index arithmetic and contracts them in two einsums, with the JAX
package's bf16 rounding points (matrices and the row intermediate in the
compute dtype, f32 accumulation).  The kernel rounds at the same points and
sums in f32 in another order, so for bf16 it agrees with the plain version
to bf16 rounding of the row intermediate, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import kernels
from .roi_align import _bounded_interp_matrix, level_offsets, roi_align

Tensor = torch.Tensor

MAX_LEVELS = 8


def roi_align_bounded_plain(levels: Sequence[Tensor], meta: Tensor, ys: Tensor, xs: Tensor,
                            bounds: Tensor, window: Tuple[int, int], M: int, n: int,
                            active: Optional[Tensor] = None) -> Tensor:
    win_h, win_w = window
    f0 = levels[0]
    dev = f0.device
    cd = torch.bfloat16 if f0.dtype == torch.bfloat16 else torch.float32
    b, oy, ox, lv = (meta[:, j].to(torch.int64) for j in range(4))
    lv = lv.clamp(0, len(levels) - 1)
    K, C = meta.shape[0], f0.shape[-1]
    Wy = _bounded_interp_matrix(ys, bounds[:, 0], bounds[:, 1], win_h, M, n).to(cd).float()
    Wx = _bounded_interp_matrix(xs, bounds[:, 2], bounds[:, 3], win_w, M, n).to(cd).float()
    moff = torch.tensor(level_offsets(levels), device=dev)[lv]
    rows = (oy - moff)[:, None] + torch.arange(win_h, device=dev)     # level rows (K, wh)
    cols = ox[:, None] + torch.arange(win_w, device=dev)              # level cols (K, ww)
    # each ROI's window from its own level; cells off the level stay 0 (the
    # canvas holds other levels or padding there, all at zero weight)
    patch = torch.zeros((K, win_h, win_w, C), dtype=cd, device=dev)
    for l, f in enumerate(levels):
        H, W = f.shape[1:3]
        ok = ((lv == l)[:, None, None] & ((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])
        g = f[b.clamp(0, f.shape[0] - 1)[:, None, None], rows.clamp(0, H - 1)[:, :, None],
              cols.clamp(0, W - 1)[:, None, :]]
        patch = torch.where(ok[..., None], g.to(cd), patch)
    r = torch.einsum("ksh,khwc->kswc", Wy, patch.float()).to(cd).float()
    out = torch.einsum("ktw,kswc->kstc", Wx, r).to(f0.dtype)
    if active is not None:
        live = torch.arange(K, device=dev) < active.to(dev)
        out = torch.where(live[:, None, None, None], out, torch.zeros_like(out))
    return out


def _dense(t: Tensor, dtype) -> Tensor:
    """``t`` as a contiguous tensor of ``dtype``, without a call when it is one."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def roi_align_bounded(levels: Sequence[Tensor], meta: Tensor, ys: Tensor, xs: Tensor,
                      bounds: Tensor, window: Tuple[int, int], M: int, n: int,
                      active: Optional[Tensor] = None) -> Tensor:
    """levels: per-level (B, H_l, W_l, C) f32|bf16 maps; meta (K, 4) int32
    (image, oy, ox, level); ys/xs (K, M·n) f32 window-local; bounds (K, 4)
    f32 (lo_y, hi_y, lo_x, hi_x) window-local; active: None or a 0-d integer
    count of leading ROIs to pool (the rest come out 0) → (K, M, M, C) in
    the levels' dtype."""
    levels = list(levels)
    f0 = levels[0]
    if f0.device.type == "cpu":
        return roi_align_bounded_plain(levels, meta, ys, xs, bounds, window, M, n, active)
    B, C, dtype = f0.shape[0], f0.shape[-1], f0.dtype
    vec = 8 if dtype == torch.bfloat16 else 4
    if (dtype not in (torch.float32, torch.bfloat16) or C % vec
            or any(f.dim() != 4 or f.dtype != dtype or f.shape[0] != B or f.shape[-1] != C
                   for f in levels)):
        raise ValueError(f"roi_align kernel takes (B, H, W, C) f32/bf16 levels of one dtype, "
                         f"batch and C, with C a multiple of 8 (bf16) or 4 (f32), got "
                         f"{[(f.dtype, tuple(f.shape)) for f in levels]}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"roi_align kernel takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    if M * n > 64:
        raise ValueError(f"roi_align kernel takes at most 64 samples per axis, got {M * n}")
    K = meta.shape[0]
    if meta.shape != (K, 4) or bounds.shape != (K, 4) or ys.shape != (K, M * n) \
            or xs.shape != (K, M * n):
        raise ValueError(f"roi_align kernel takes meta/bounds ({K}, 4) and ys/xs ({K}, {M * n}), "
                         f"got {tuple(meta.shape)} {tuple(bounds.shape)} {tuple(ys.shape)} "
                         f"{tuple(xs.shape)}")
    # the main path's maps are contiguous and 512-byte aligned already; the
    # kernel reads 16-byte vectors
    levels = [f if f.is_contiguous() and f.data_ptr() % 16 == 0 else f.contiguous().clone()
              for f in levels]
    meta, ys, xs, bounds = (_dense(meta, torch.int32), _dense(ys, torch.float32),
                            _dense(xs, torch.float32), _dense(bounds, torch.float32))
    tensors = [*levels, meta, ys, xs, bounds]
    if active is not None:
        active = _dense(active, torch.int64)   # the packed branch's sum is int64 already
        if active.dim():
            active = active.reshape(())
        tensors.append(active)
    kernels.require_cuda(*tensors)
    table = (ctypes.c_longlong * (4 * len(levels)))(*[
        v for f, off in zip(levels, level_offsets(levels))
        for v in (f.data_ptr(), f.shape[1], f.shape[2], off)])
    out = torch.empty((K, M, M, C), dtype=dtype, device=f0.device)
    dev, stream = kernels.device_and_stream(f0)
    code = kernels.fn("roi_align_bounded")(
        ctypes.addressof(table), len(levels), meta.data_ptr(), ys.data_ptr(), xs.data_ptr(),
        bounds.data_ptr(), None if active is None else active.data_ptr(), out.data_ptr(), K, C,
        int(window[0]), int(window[1]), M, n, 1 if dtype == torch.bfloat16 else 0, dev, stream)
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
