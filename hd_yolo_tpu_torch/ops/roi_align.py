"""Bilinear ROI-align, single-level and multiscale (port of
``hd_yolo_tpu/ops/roi_align.py``).

torchvision ``aligned=False`` semantics (the reference's mode):
``roi_start = coord * spatial_scale``, ``roi_w/h = max(roi_w/h, 1)``,
samples outside ``(lo-1, hi)`` contribute zero, in-range coordinates clamp
to the border, a fixed ``n x n`` sample grid per output bin, average-pooled.

Single level: ``roi_align`` pools (B, K) boxes from one (B, H, W, C) map
with the JAX package's matmul form — the plain version of
``ops/pallas_roi_align.roi_align_single``, which launches the CUDA kernel
for a CUDA map and runs ``roi_align`` for a CPU map.

Multiscale: the JAX package stacks all pyramid levels along rows into one
channels-last canvas (B, ΣH_l, W0, C); each ROI samples its own level's
sub-rectangle through per-ROI bounds (``_bounded_interp_matrix``), so
nothing reads across a level boundary.  The geometry (sample coordinates,
bounds, window origins) is computed here in those canvas coordinates, in
float32 with the JAX package's op order; the pooling itself is
``ops/pallas_roi_align.roi_align_bounded``, which reads each ROI's level map
in place (canvas row r of level l is its row r - moff_l) — the CUDA kernel
for CUDA maps, its plain version for CPU maps.  Only the plain einsum form
``_multiscale_roi_align_canvas`` builds the canvas (``level_canvas``).

Under autograd (grad enabled and a level map that requires it: the training
step's mask loss) both multiscale forms pool through
``pallas_roi_align.RoiAlignBoundedFn``, whose backward is the level
gradient (the kernel ``roi_align_bwd`` on the card); otherwise they call
the op directly.
"""

from __future__ import annotations

from itertools import accumulate
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _sample_weights(coord: Tensor, size: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """1-D bilinear sample: (low_idx, high_idx, low_w, high_w) with
    torchvision's out-of-range zeroing and border clamping."""
    in_range = (coord > -1.0) & (coord < size)
    c = coord.clamp(0.0, size - 1)
    low = torch.floor(c).to(torch.int64)
    high = (low + 1).clamp(max=size - 1)
    lw = c - low.to(coord.dtype)
    zero = torch.zeros_like(lw)
    return low, high, torch.where(in_range, 1.0 - lw, zero), torch.where(in_range, lw, zero)


def _interp_matrix(coords: Tensor, size: int) -> Tensor:
    """(..., S) sample coords → (..., S, size) dense bilinear rows (≤ 2
    nonzeros each; an out-of-range sample gets an all-zero row)."""
    low, high, w_low, w_high = _sample_weights(coords, size)
    grid = torch.arange(size, device=coords.device)
    m_low = (grid == low[..., None]).to(coords.dtype) * w_low[..., None]
    m_high = (grid == high[..., None]).to(coords.dtype) * w_high[..., None]
    return m_low + m_high


def _sample_coords(boxes: Tensor, M: int, n: int, spatial_scale: float, aligned: bool):
    """boxes (K, 4) → per-axis sample centres ys, xs, each (K, M·n)."""
    offset = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - offset
    y1 = boxes[:, 1] * spatial_scale - offset
    x2 = boxes[:, 2] * spatial_scale - offset
    y2 = boxes[:, 3] * spatial_scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    s = torch.arange(M * n, dtype=boxes.dtype, device=boxes.device) + 0.5
    ys = y1[:, None] + s[None, :] * (roi_h / (M * n))[:, None]
    xs = x1[:, None] + s[None, :] * (roi_w / (M * n))[:, None]
    return ys, xs


def _pooled_interp_matrix(coords: Tensor, size: int, M: int, n: int) -> Tensor:
    """(k, M·n) sample coords → (k, M, size) rows with each bin's n-sample
    mean folded in (the sample grid is separable, so this is exact)."""
    m = _interp_matrix(coords, size)
    return m.reshape(m.shape[0], M, n, size).mean(2)


def roi_align(features: Tensor, boxes: Tensor, output_size: int, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = False) -> Tensor:
    """ROI-align (B, K, 4) xyxy boxes against their image's map of
    ``features`` (B, H, W, C) → (B, K, M, M, C) in the features' dtype: the
    JAX ``roi_align`` with the batch in front, as it runs under ``vmap``.

    The plain version: ``Wy · F · Wxᵀ`` with the bin-pooled interpolation
    matrices, which (like the row intermediate) are rounded to the compute
    dtype (bf16 for bf16 features, else f32), products accumulated in f32."""
    B, H, W, C = features.shape
    K = boxes.shape[1]
    M, n = output_size, sampling_ratio
    ys, xs = _sample_coords(boxes.reshape(B * K, 4).float(), M, n, spatial_scale, aligned)
    cd = torch.bfloat16 if features.dtype == torch.bfloat16 else torch.float32
    Wy = _pooled_interp_matrix(ys, H, M, n).to(cd).float().reshape(B, K, M, H)
    Wx = _pooled_interp_matrix(xs, W, M, n).to(cd).float().reshape(B, K, M, W)
    rows = torch.einsum("bksh,bhwc->bkswc", Wy, features.to(cd).float()).to(cd).float()
    out = torch.einsum("bktw,bkswc->bkstc", Wx, rows)
    return out.to(features.dtype)


def _bounded_interp_matrix(coords: Tensor, lo: Tensor, hi: Tensor, size: int, M: int,
                           n: int) -> Tensor:
    """(..., M·n) coords with per-ROI [lo, hi) valid window → (..., M, size)
    bin-pooled interpolation rows (the n-sample mean folded in)."""
    lo2, hi2 = lo[..., None], hi[..., None]
    in_range = ((coords > lo2 - 1.0) & (coords < hi2)).to(torch.float32)
    c = torch.minimum(torch.maximum(coords, lo2), hi2 - 1.0)
    low = torch.floor(c)
    lw = c - low
    high = torch.minimum(low + 1.0, hi2 - 1.0)
    grid = torch.arange(size, dtype=torch.float32, device=coords.device)
    w = (grid == low[..., None]).to(torch.float32) * ((1.0 - lw) * in_range)[..., None] \
        + (grid == high[..., None]).to(torch.float32) * (lw * in_range)[..., None]
    return w.reshape(*w.shape[:-2], M, n, size).mean(-2)


def level_offsets(features: Sequence[Tensor]) -> list:
    """Row offset of each per-level NHWC map in the level-stacked canvas."""
    return [0] + list(accumulate(f.shape[1] for f in features))[:-1]


def level_meta(features: Sequence[Tensor], strides: Sequence[float]) -> Tensor:
    """(L, 4) f32 rows (row offset in the level-stacked canvas, height,
    width, stride) of the per-level NHWC maps."""
    metas = [(off, f.shape[1], f.shape[2], float(s))
             for f, s, off in zip(features, strides, level_offsets(features))]
    return torch.tensor(metas, dtype=torch.float32, device=features[0].device)


def level_canvas(features: Sequence[Tensor], strides: Sequence[float]) -> Tuple[Tensor, Tensor]:
    """Per-level NHWC maps → (canvas (B, ΣH_l, W0, C), meta (L, 4) f32 rows
    (row offset, height, width, stride)): the levels stacked along rows, each
    padded to the first level's width.  Only the plain einsum form builds it;
    the pooling reads the levels in place."""
    W0 = features[0].shape[2]
    canvas = torch.cat([F.pad(f, (0, 0, 0, W0 - f.shape[2])) for f in features], 1)
    return canvas, level_meta(features, strides)


def sample_coords(boxes: Tensor, levels: Tensor, meta: Tensor, S: int, aligned: bool):
    """Canvas-space sample coordinates of each ROI: ys, xs (..., S), plus its
    level's row offset, height and width (...)."""
    lv = levels.to(torch.int64).clamp(0, meta.shape[0] - 1)
    moff, mh, mw = meta[lv, 0], meta[lv, 1], meta[lv, 2]
    scale = 1.0 / meta[lv, 3]
    bf = boxes.to(torch.float32)
    offset = 0.5 if aligned else 0.0
    x1 = bf[..., 0] * scale - offset
    y1 = bf[..., 1] * scale - offset
    x2 = bf[..., 2] * scale - offset
    y2 = bf[..., 3] * scale - offset
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    s_idx = torch.arange(S, dtype=torch.float32, device=boxes.device) + 0.5
    ys = y1[..., None] + s_idx * (roi_h / S)[..., None] + moff[..., None]
    xs = x1[..., None] + s_idx * (roi_w / S)[..., None]
    return ys, xs, moff, mh, mw


def _multiscale_roi_align_canvas(features: Sequence[Tensor], boxes: Tensor, levels: Tensor,
                                 strides: Sequence[float], output_size: int,
                                 sampling_ratio: int = 2, aligned: bool = False) -> Tensor:
    """Exact canvas formulation, plain: (B, K) ROIs against their image's
    whole canvas as two einsums → (B, K, M, M, C)."""
    M, n = output_size, sampling_ratio
    canvas, meta = level_canvas(features, strides)
    Ht, W0 = canvas.shape[1:3]
    ys, xs, moff, mh, mw = sample_coords(boxes, levels, meta, M * n, aligned)
    cd = torch.bfloat16 if canvas.dtype == torch.bfloat16 else torch.float32
    Wy = _bounded_interp_matrix(ys, moff, moff + mh, Ht, M, n).to(cd).float()
    Wx = _bounded_interp_matrix(xs, torch.zeros_like(mw), mw, W0, M, n).to(cd).float()
    rows = torch.einsum("bksh,bhwc->bkswc", Wy, canvas.to(cd).float()).to(cd).float()
    out = torch.einsum("bktw,bkswc->bkstc", Wx, rows)
    return out.to(features[0].dtype)


def _pool_bounded(levels, meta, ys, xs, bounds, window, M, n, active=None) -> Tensor:
    """``roi_align_bounded``, through ``RoiAlignBoundedFn`` when autograd
    needs the levels' gradient."""
    from .pallas_roi_align import RoiAlignBoundedFn, roi_align_bounded

    if torch.is_grad_enabled() and any(f.requires_grad for f in levels):
        return RoiAlignBoundedFn.apply(meta, ys, xs, bounds, window, M, n, active, *levels)
    return roi_align_bounded(levels, meta, ys, xs, bounds, window, M, n, active)


def multiscale_roi_align_packed(features: Sequence[Tensor], boxes: Tensor, levels: Tensor,
                                batch_idx: Tensor, strides: Sequence[float], output_size: int,
                                sampling_ratio: int = 2, aligned: bool = False,
                                window: int = 16, active: Optional[Tensor] = None) -> Tensor:
    """Occupancy-packed multi-level ROI-align → (K, M, M, C).

    One flat ROI list across the batch (``batch_idx`` names each ROI's
    image).  Each ROI pools from a ``window x window`` patch of its image's
    level-stacked canvas at the floor of its first sample (clamped to the
    canvas): exact for every ROI whose sampled span fits the window (span ≤
    window−2 feature px at its level); larger ROIs get border-truncated
    sampling, exactly as the JAX packed path.  The canvas is never built:
    the pooling reads each ROI's level map in place.  ``active`` (a 0-d
    integer tensor) pools only the leading ROIs; the rest come out 0.
    """
    M, n = output_size, sampling_ratio
    S = M * n
    meta = level_meta(features, strides)
    B, W0 = features[0].shape[0], features[0].shape[2]
    Ht = sum(f.shape[1] for f in features)
    win = min(window, Ht, W0)
    lv = levels.to(torch.int32).clamp(0, len(features) - 1)
    ys, xs, moff, mh, mw = sample_coords(boxes, lv, meta, S, aligned)
    oy = torch.floor(ys[:, 0]).clamp(0, Ht - win).to(torch.int32)
    ox = torch.floor(xs[:, 0]).clamp(0, W0 - win).to(torch.int32)
    oyf, oxf = oy.to(torch.float32), ox.to(torch.float32)
    bounds = torch.stack([moff - oyf, moff + mh - oyf, -oxf, mw - oxf], -1)
    b_idx = batch_idx.to(torch.int32).clamp(0, B - 1)
    roi_meta = torch.stack([b_idx, oy, ox, lv], -1)
    return _pool_bounded(list(features), roi_meta, ys - oyf[:, None], xs - oxf[:, None], bounds,
                         (win, win), M, n, active)


def multiscale_roi_align_canvas(features: Sequence[Tensor], boxes: Tensor, levels: Tensor,
                                strides: Sequence[float], output_size: int,
                                sampling_ratio: int = 2, aligned: bool = False) -> Tensor:
    """Exact canvas semantics through the bounded ROI-align (kernel on CUDA):
    (B, K) ROIs, each against its image's whole level-stacked canvas, read
    from the level maps in place → (B, K, M, M, C)."""
    M, n = output_size, sampling_ratio
    meta = level_meta(features, strides)
    B, W0, C = features[0].shape[0], features[0].shape[2], features[0].shape[3]
    Ht = sum(f.shape[1] for f in features)
    K = boxes.shape[1]
    lv = levels.reshape(B * K).to(torch.int32).clamp(0, len(features) - 1)
    ys, xs, moff, mh, mw = sample_coords(boxes.reshape(B * K, 4), lv, meta, M * n, aligned)
    bounds = torch.stack([moff, moff + mh, torch.zeros_like(mw), mw], -1)
    b_idx = torch.arange(B, dtype=torch.int32, device=boxes.device).repeat_interleave(K)
    zero = torch.zeros_like(b_idx)
    roi_meta = torch.stack([b_idx, zero, zero, lv], -1)
    out = _pool_bounded(list(features), roi_meta, ys, xs, bounds, (Ht, W0), M, n)
    return out.reshape(B, K, M, M, C)
