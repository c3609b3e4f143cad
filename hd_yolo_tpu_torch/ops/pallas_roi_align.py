"""ROI-align on the card: wrappers of ``kernels/roi_align.cu`` (the Hopper
port of ``hd_yolo_tpu/ops/pallas_roi_align.py``'s canvas kernel) and
``kernels/roi_align_single.cu`` (the port of its single-level ``_kernel``).

``roi_align_levels`` pools one set of (B, K) boxes from several maps, each
at its own output size and scale, in one launch (hnet's ROI pyramid);
``roi_align_single`` is its one-map entry.  On CPU maps both run the plain
version, one ``ops/roi_align.roi_align`` per map.  The kernel rounds where
the plain version does (matrices and row intermediate in the compute dtype)
and sums a bin's entries in index order: where every bin has at most two
distinct rows and columns (hnet's pyramid) that is bit for bit the plain
version at bf16; elsewhere f32 sums of three or more terms may run in
another order.

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
merges a bin's taps per index in sample order as the plain matrices do: at
bf16 it equals the plain version bit for bit at every shape the main path,
hnet and the checks give it (a bin's f32 sums there never depend on order).
In f32 the sums of more than two taps may run in another order than the
plain version's matrix products, so f32 agrees to ~1e-5.

The bounded kernel is the ``torch.library`` op
``hd_yolo_tpu_torch::roi_align_bounded`` (the ``ctypes`` launch in its body,
a fake implementation of its output shape), so ``torch.export`` keeps it as
one call in the graph of the yolo forward; eager calls on the card go
through the same op.  ``roi_align_levels`` (hnet's pyramid, not on an
exported path) stays a plain ``ctypes`` wrapper.

Training differentiates the bounded pooling with respect to the level maps:
``RoiAlignBoundedFn`` runs ``roi_align_bounded`` forward and
``roi_align_bounded_bwd`` backward, the op
``hd_yolo_tpu_torch::roi_align_bounded_bwd`` of ``kernels/roi_align_bwd.cu``
on the card (the adjoint, gathered: two launches, one building each ROI's
tables and listing the ROIs of each image and level, one writing each
level-gradient tile once in the levels' dtype from the ROIs that reach it,
in ROI order; tiled as ``_bounded_bwd_plan`` says), and on CPU levels the
plain version, the autograd of ``roi_align_bounded_plain``.  The
coordinates, bounds and boxes get no gradient.

Training differentiates the single-level pooling (hnet's ROI pyramids and
the confliction loss's pooling of the seg probabilities) with respect to
the maps the same way: under autograd ``roi_align_levels`` and
``roi_align_single`` go through ``RoiAlignLevelsFn``, whose backward is
``roi_align_levels_bwd`` — one launch of ``kernels/roi_align_single_bwd.cu``
for every map on the card (each map cell's gradient gathered from the bins
that touch it, with the plain version's rounding points; bit for bit the
plain version at hnet's pyramid; one map with many ROIs an image, the
confliction loss's pooling, by a thread-block cluster an image whose warps
form the ROIs' adjoint patches and sum them in a fixed order), the
autograd of ``roi_align_levels_plain`` on CPU maps.  The boxes get no
gradient, as JAX's TPU kernel's vjp gives none.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import List, Optional, Sequence, Tuple

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
    levels = [f.contiguous() for f in levels]
    meta, ys, xs, bounds = (_dense(meta, torch.int32), _dense(ys, torch.float32),
                            _dense(xs, torch.float32), _dense(bounds, torch.float32))
    tensors = [*levels, meta, ys, xs, bounds]
    if active is not None:
        active = _dense(active, torch.int64)   # the packed branch's sum is int64 already
        if active.dim():
            active = active.reshape(())
        tensors.append(active)
    kernels.require_cuda(*tensors)
    return roi_align_bounded_op(levels, meta, ys, xs, bounds, int(window[0]), int(window[1]),
                                int(M), int(n), active)


def _launch_bounded(levels, meta, ys, xs, bounds, win_h: int, win_w: int, M: int, n: int,
                    active: Optional[Tensor]) -> Tensor:
    f0 = levels[0]
    K, C, dtype = meta.shape[0], f0.shape[-1], f0.dtype
    # the main path's maps are 512-byte aligned already; the kernel reads
    # 16-byte vectors
    levels = [f if f.data_ptr() % 16 == 0 else f.clone() for f in levels]
    table = (ctypes.c_longlong * (4 * len(levels)))(*[
        v for f, off in zip(levels, level_offsets(levels))
        for v in (f.data_ptr(), f.shape[1], f.shape[2], off)])
    out = torch.empty((K, M, M, C), dtype=dtype, device=f0.device)
    dev, stream = kernels.device_and_stream(f0)
    code = kernels.fn("roi_align_bounded")(
        ctypes.addressof(table), len(levels), meta.data_ptr(), ys.data_ptr(), xs.data_ptr(),
        bounds.data_ptr(), None if active is None else active.data_ptr(), out.data_ptr(), K, C,
        win_h, win_w, M, n, 1 if dtype == torch.bfloat16 else 0, dev, stream)
    kernels.check(code, "roi_align_bounded")
    kernels.LAUNCHES["roi_align"] += 1
    return out


def _bounded_fake(levels, meta, ys, xs, bounds, win_h, win_w, M, n, active):
    return levels[0].new_empty((meta.shape[0], M, M, levels[0].shape[-1]))


roi_align_bounded_op = kernels.register_op(
    "roi_align_bounded", "(Tensor[] levels, Tensor meta, Tensor ys, Tensor xs, Tensor bounds, "
                         "int win_h, int win_w, int M, int n, Tensor? active) -> Tensor",
    _launch_bounded, _bounded_fake)


def roi_align_bounded_bwd_plain(grad_out: Tensor, levels: Sequence[Tensor], meta: Tensor,
                                ys: Tensor, xs: Tensor, bounds: Tensor, window: Tuple[int, int],
                                M: int, n: int, active: Optional[Tensor] = None) -> List[Tensor]:
    """The plain version of ``roi_align_bounded_bwd``: the autograd of
    ``roi_align_bounded_plain`` with respect to the levels."""
    leaves = [f.detach().requires_grad_() for f in levels]
    with torch.enable_grad():
        out = roi_align_bounded_plain(leaves, meta, ys, xs, bounds, window, M, n, active)
    grads = torch.autograd.grad(out, leaves, grad_out.to(out.dtype), allow_unused=True)
    return [torch.zeros_like(f) if g is None else g for f, g in zip(levels, grads)]


def roi_align_bounded_bwd(grad_out: Tensor, levels: Sequence[Tensor], meta: Tensor, ys: Tensor,
                          xs: Tensor, bounds: Tensor, window: Tuple[int, int], M: int, n: int,
                          active: Optional[Tensor] = None) -> List[Tensor]:
    """The gradient of ``roi_align_bounded``'s output with respect to each
    level map: grad_out (K, M, M, C), the forward's arguments → per level a
    (B, H_l, W_l, C) gradient in the levels' dtype.  Reads only the levels'
    shapes and dtype.  The kernel on CUDA levels, the plain version on CPU
    levels."""
    levels = list(levels)
    f0 = levels[0]
    if f0.device.type == "cpu":
        return roi_align_bounded_bwd_plain(grad_out, levels, meta, ys, xs, bounds, window, M, n,
                                           active)
    B, C, dtype = f0.shape[0], f0.shape[-1], f0.dtype
    K = meta.shape[0]
    if (dtype not in (torch.float32, torch.bfloat16)
            or any(f.dim() != 4 or f.dtype != dtype or f.shape[0] != B or f.shape[-1] != C
                   for f in levels)):
        raise ValueError(f"roi_align_bwd kernel takes (B, H, W, C) f32/bf16 levels of one dtype, "
                         f"batch and C, got {[(f.dtype, tuple(f.shape)) for f in levels]}")
    lim = kernels.constants("roi_align_bwd")
    if not 1 <= len(levels) <= lim["MAX_L"] or M * n > lim["MAX_S"]:
        raise ValueError(f"roi_align_bwd kernel takes 1 to {lim['MAX_L']} levels and at most "
                         f"{lim['MAX_S']} samples per axis, got {len(levels)} and {M * n}")
    if grad_out.shape != (K, M, M, C) or meta.shape != (K, 4) or bounds.shape != (K, 4) \
            or ys.shape != (K, M * n) or xs.shape != (K, M * n):
        raise ValueError(f"roi_align_bwd kernel takes grad ({K}, {M}, {M}, {C}), meta/bounds "
                         f"({K}, 4) and ys/xs ({K}, {M * n}), got {tuple(grad_out.shape)} "
                         f"{tuple(meta.shape)} {tuple(bounds.shape)} {tuple(ys.shape)} "
                         f"{tuple(xs.shape)}")
    grad_out = _dense(grad_out, dtype)
    meta, ys, xs, bounds = (_dense(meta, torch.int32), _dense(ys, torch.float32),
                            _dense(xs, torch.float32), _dense(bounds, torch.float32))
    tensors = [grad_out, meta, ys, xs, bounds]
    if active is not None:
        active = _dense(active, torch.int64).reshape(())
        tensors.append(active)
    kernels.require_cuda(*tensors)
    if any(f.device != f0.device for f in levels) or f0.device != meta.device:
        raise ValueError("roi_align_bwd kernel inputs must share one CUDA device")
    return roi_align_bounded_bwd_op(grad_out, levels, meta, ys, xs, bounds, int(window[0]),
                                    int(window[1]), int(M), int(n), active)


_BOUNDED_BWD_PLANS: dict = {}


def _bounded_bwd_plan(shapes: Sequence[Tuple[int, int]], B: int, C: int, vec: int, M: int,
                      n: int) -> tuple:
    """The tiling of ``roi_align_bwd.cu``'s gather for level shapes ``(H_l,
    W_l)``, batch B, C channels in vectors of ``vec``, M x M bins of n x n
    samples: (plan row, per level (tiles down, tiles across, slabs), record
    bytes of one ROI's tables).  A slab is up to 32 channel vectors, a lane
    each in groups of ``lpc`` lanes (a power of two); a tile is the kernel's
    ``NWARPS`` x ``32 / lpc`` rows (a lane group each) by its ``TW`` columns
    (the cells a lane owns; ``kernels.constants``).  A
    ROI's record holds its footprint, both axes' entries (at most 2·M·n
    each: a weight and a bin) and one run start per index of the largest
    level side, in 16-byte multiples."""
    key = (tuple(shapes), B, C, vec, M, n)
    plan = _BOUNDED_BWD_PLANS.get(key)
    if plan is not None:
        return plan
    k = kernels.constants("roi_align_bwd")
    ncv = C // vec
    cvs = min(ncv, 32)
    lpc_log2 = (cvs - 1).bit_length()
    th = k["NWARPS"] * (32 >> lpc_log2)
    e_max = 2 * M * n
    rs = max(max(h, w) for h, w in shapes) + 1
    rec = -(-(16 + 10 * e_max + 2 * rs) // 16) * 16
    tiles = [(-(-h // th), -(-w // k["TW"]), -(-ncv // cvs)) for h, w in shapes]
    plan = ((th, cvs, lpc_log2, rec, e_max, rs, B, 0), tiles, rec)
    _BOUNDED_BWD_PLANS[key] = plan
    return plan


def _launch_bounded_bwd(grad_out, levels, meta, ys, xs, bounds, win_h: int, win_w: int, M: int,
                        n: int, active: Optional[Tensor]) -> List[Tensor]:
    f0 = levels[0]
    K, B, C, dtype = meta.shape[0], f0.shape[0], f0.shape[-1], f0.dtype
    outs = [torch.empty(f.shape, dtype=dtype, device=f0.device) for f in levels]
    width = 8 if dtype == torch.bfloat16 else 4
    vec = width if C % width == 0 and grad_out.data_ptr() % 16 == 0 else 1
    head, tiles, rec = _bounded_bwd_plan([tuple(f.shape[1:3]) for f in levels], B, C, vec, M, n)
    # footprints (K x 16 bytes), list counts and the ROIs of each (image,
    # level) (B·L ints, B·L x K ints), records (K x rec), each at a 16-byte
    # multiple
    nkey = B * len(levels)
    work = torch.empty(K * (16 + rec) + 16 * (-(-nkey // 4) + -(-nkey * K // 4)),
                       dtype=torch.uint8, device=f0.device)
    table = struct.pack(f"<{8 * (len(levels) + 1)}q", *head, *[
        v for o, f, off, t in zip(outs, levels, level_offsets(levels), tiles)
        for v in (o.data_ptr(), f.shape[1], f.shape[2], off, *t, 0)])
    dev, stream = kernels.device_and_stream(f0)
    code = kernels.fn("roi_align_bounded_bwd")(
        table, len(levels), grad_out.data_ptr(), meta.data_ptr(), ys.data_ptr(), xs.data_ptr(),
        bounds.data_ptr(), None if active is None else active.data_ptr(), work.data_ptr(), K, C,
        win_h, win_w, M, n, 1 if dtype == torch.bfloat16 else 0, 1 if vec > 1 else 0, dev, stream)
    kernels.check(code, "roi_align_bounded_bwd")
    kernels.LAUNCHES["roi_align_bwd"] += 1
    return outs


def _bounded_bwd_fake(grad_out, levels, meta, ys, xs, bounds, win_h, win_w, M, n, active):
    return [f.new_empty(f.shape) for f in levels]


roi_align_bounded_bwd_op = kernels.register_op(
    "roi_align_bounded_bwd",
    "(Tensor grad_out, Tensor[] levels, Tensor meta, Tensor ys, Tensor xs, Tensor bounds, "
    "int win_h, int win_w, int M, int n, Tensor? active) -> Tensor[]",
    _launch_bounded_bwd, _bounded_bwd_fake)


class RoiAlignBoundedFn(torch.autograd.Function):
    """``roi_align_bounded`` differentiable in the level maps:
    ``apply(meta, ys, xs, bounds, window, M, n, active, *levels)``.  The
    forward is ``roi_align_bounded``, the backward ``roi_align_bounded_bwd``
    (both the kernel on CUDA levels, the plain version on CPU levels)."""

    @staticmethod
    def forward(ctx, meta, ys, xs, bounds, window, M, n, active, *levels):
        ctx.args = (window, M, n)
        ctx.save_for_backward(meta, ys, xs, bounds, active, *levels)
        return roi_align_bounded(levels, meta, ys, xs, bounds, window, M, n, active)

    @staticmethod
    def backward(ctx, grad_out):
        meta, ys, xs, bounds, active, *levels = ctx.saved_tensors
        window, M, n = ctx.args
        grads = roi_align_bounded_bwd(grad_out, levels, meta, ys, xs, bounds, window, M, n,
                                      active)
        return (None,) * 8 + tuple(grads)


def roi_align_levels_plain(features: Sequence[Tensor], rois: Tensor, sizes: Sequence[int],
                          scales: Sequence[float], sampling_ratio: int = 2,
                          aligned: bool = False) -> List[Tensor]:
    """The plain version of ``roi_align_levels``: one ``roi_align`` per map."""
    return [roi_align(f, rois, int(M), float(s), sampling_ratio, aligned)
            for f, M, s in zip(features, sizes, scales)]


_LIMITS: dict = {}


def _limits() -> dict:
    """The kernel's pooling limits (levels, samples per axis, y entries of a
    band, staged bytes), read from its library once."""
    if not _LIMITS:
        f = kernels.fn("roi_align_levels_limits")
        _LIMITS.update(zip(("levels", "samples", "band_entries", "stage_bytes"),
                           (f(i) for i in range(4))))
    return _LIMITS


def _band_and_slab(H: int, W: int, C: int, M: int, n: int, cell: int, esz: int, vec: int):
    """Output rows per work item and channels per slab for one map: the
    band's worst-case rows at the map's width must fit the staging buffer one
    ``vec``-channel cell wide; the slab is the widest that fits the band's
    usual rows (band + 1 when bins are a pixel apart) at the whole width,
    cut into equal ``vec`` multiples."""
    lim = _limits()
    bh = min(M, 8)
    while bh > 1 and (min(H, bh * 2 * n) * W * cell > lim["stage_bytes"]
                      or bh * 2 * n > lim["band_entries"]):
        bh -= 1
    if min(H, bh * 2 * n) * W * cell > lim["stage_bytes"] or bh * 2 * n > lim["band_entries"]:
        raise ValueError(f"roi_align_levels kernel: a ({H}, {W}) map at sampling {n} does not fit "
                         f"its {lim['stage_bytes']}-byte staging buffer")
    cs_max = max(vec, lim["stage_bytes"] // (min(H, bh + 1) * W * esz) // vec * vec)
    per_slab = -(-C // -(-C // cs_max))
    return bh, -(-per_slab // vec) * vec


_PLANS: dict = {}


def _plan(features: Sequence[Tensor], rois: Tensor, sizes: Sequence[int],
          scales: Sequence[float], n: int) -> tuple:
    """The launch plan of one call's shapes, checked and cached: per map its
    output shape and the level-table row without pointers, for the vector
    path and the scalar one."""
    key = (tuple((f.dtype, f.shape) for f in features), rois.shape, tuple(sizes), tuple(scales), n)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    f0 = features[0]
    dtype, B = f0.dtype, f0.shape[0]
    if (dtype not in (torch.float32, torch.bfloat16)
            or any(f.dim() != 4 or f.dtype != dtype or f.shape[0] != B for f in features)):
        raise ValueError(f"roi_align_levels kernel takes (B, H, W, C) f32/bf16 maps of one dtype "
                         f"and batch, got {[(f.dtype, tuple(f.shape)) for f in features]}")
    if not len(features) == len(sizes) == len(scales):
        raise ValueError(f"roi_align_levels takes one size and scale per map, got "
                         f"{len(features)} maps, {len(sizes)} sizes, {len(scales)} scales")
    if rois.dim() != 3 or rois.shape[0] != B or rois.shape[2] != 4:
        raise ValueError(f"roi_align_levels kernel takes ({B}, K, 4) boxes, got {tuple(rois.shape)}")
    lim = _limits()
    if not 1 <= len(features) <= lim["levels"]:
        raise ValueError(f"roi_align_levels kernel takes 1 to {lim['levels']} maps, "
                         f"got {len(features)}")
    for f, M in zip(features, sizes):
        if min(f.shape[1:]) < 1 or max(f.shape[1:3]) > 32767 or n < 1 or not \
                1 <= int(M) * n <= lim["samples"]:
            raise ValueError(f"roi_align_levels kernel takes maps of 1 to 32767 rows and columns "
                             f"and 1 to {lim['samples']} samples per axis, got "
                             f"{tuple(f.shape)} at output {M}, sampling {n}")
    esz = f0.element_size()
    vec = 16 // esz
    K = rois.shape[1]
    shapes, rows = [], {True: [], False: []}
    for f, M, sc in zip(features, sizes, scales):
        H, W, C = f.shape[1:]
        shapes.append((B, K, int(M), int(M), C))
        bits = struct.unpack("<I", struct.pack("<f", float(sc)))[0]
        for use_vec in (True, False):
            if use_vec and C % vec:
                continue
            bh, cs = _band_and_slab(H, W, C, int(M), n, 16 if use_vec else esz, esz,
                                    vec if use_vec else 1)
            rows[use_vec].append((H, W, C, int(M), bh, cs, bits, 0))
    vec_ok = len(rows[True]) == len(features)
    # the outputs as views of one buffer, each at a 16-byte multiple
    offsets, total = [], 0
    for sh in shapes:
        offsets.append(total)
        total += -(-math.prod(sh) // vec) * vec
    views = [(sh, torch.empty(sh, device="meta").stride(), o) for sh, o in zip(shapes, offsets)]
    plan = (views, total, rows[True] if vec_ok else None, rows[False])
    _PLANS[key] = plan
    return plan


def _aligned16(t: Tensor) -> Tensor:
    """``t`` contiguous and at a 16-byte aligned address (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _levels_forward(features: Sequence[Tensor], rois: Tensor, sizes: Sequence[int],
                    scales: Sequence[float], sampling_ratio: int = 2,
                    aligned: bool = False) -> List[Tensor]:
    """``roi_align_levels`` without autograd."""
    f0 = features[0]
    if f0.device.type == "cpu":
        return roi_align_levels_plain(features, rois, sizes, scales, sampling_ratio, aligned)
    n = int(sampling_ratio)
    views, total, vec_rows, scalar_rows = _plan(features, rois, sizes, scales, n)
    features = [f if f.is_contiguous() else f.contiguous() for f in features]
    rois = _aligned16(rois.float())                   # the kernel reads each box as a float4
    dev = f0.get_device()
    if dev < 0 or not f0.is_cuda or rois.get_device() != dev or any(
            f.get_device() != dev for f in features):
        raise ValueError("roi_align_levels kernel inputs must share one CUDA device")
    # one allocation for every map's output (host time: one allocator call)
    buf = torch.empty(total, dtype=f0.dtype, device=f0.device)
    outs = [buf.as_strided(sh, st, o) for sh, st, o in views]
    base, esz = buf.data_ptr(), buf.element_size()
    fptrs = [f.data_ptr() for f in features]
    use_vec = vec_rows is not None and base % 16 == 0 and all(p % 16 == 0 for p in fptrs)
    table = struct.pack(f"<{10 * len(fptrs)}q", *[
        v for p, (_, _, o), r in zip(fptrs, views, vec_rows if use_vec else scalar_rows)
        for v in (p, base + o * esz, *r)])
    _, stream = kernels.device_and_stream(f0)
    B, K = views[0][0][:2]
    code = kernels.fn("roi_align_levels")(
        table, len(fptrs), rois.data_ptr(), B, K, n, 1 if aligned else 0,
        1 if f0.dtype == torch.bfloat16 else 0, 1 if use_vec else 0, dev, stream)
    kernels.check(code, "roi_align_levels")
    kernels.LAUNCHES["roi_align_single"] += 1
    return outs


def roi_align_levels_bwd_plain(grads: Sequence[Tensor], features: Sequence[Tensor], rois: Tensor,
                               sizes: Sequence[int], scales: Sequence[float],
                               sampling_ratio: int = 2, aligned: bool = False) -> List[Tensor]:
    """The plain version of ``roi_align_levels_bwd``: the autograd of
    ``roi_align_levels_plain`` with respect to the maps (the boxes held
    constant)."""
    leaves = [f.detach().requires_grad_() for f in features]
    with torch.enable_grad():
        outs = roi_align_levels_plain(leaves, rois.detach(), sizes, scales, sampling_ratio, aligned)
    got = torch.autograd.grad(outs, leaves, [g.to(o.dtype) for g, o in zip(grads, outs)],
                              allow_unused=True)
    return [torch.zeros_like(f) if g is None else g for f, g in zip(features, got)]


# channel vectors a slab of the single-level backward's gather (a plan choice;
# the kernel's limits are read from its source by ``kernels.constants``)
BWD_SLAB_VECTORS = 8

_BWD_PLANS: dict = {}


# the per-ROI path: one map with at least this many ROIs an image, whose f32
# gradient fits a block's shared memory
PER_ROI_MIN_K = 16


def _bwd_plan(features: Sequence[Tensor], rois: Tensor, sizes: Sequence[int], n: int) -> tuple:
    """The backward's launch plan of one call's shapes, checked and cached:
    (vector path?, per-ROI path?, per map (H, W, C, M, bands, column blocks,
    columns a block, slabs, channels a slab, log2 of the lanes a column)).
    The per-ROI path takes one map with many ROIs an image (the confliction
    loss's pooling) whose buffers fit; the gather the rest.  A gather item is
    the kernel's ``BH`` rows by a block of columns by a slab of up to
    ``BWD_SLAB_VECTORS`` channel vectors, a thread per (column, vector): the
    lanes of a column are the slab's vectors rounded up to a power of two,
    the columns a block's ``NTHREADS`` worth of them (at most ``MAX_CB``).
    The limits are the kernel's (``kernels.constants``)."""
    key = (tuple((f.dtype, f.shape) for f in features), rois.shape, tuple(sizes), n)
    plan = _BWD_PLANS.get(key)
    if plan is not None:
        return plan
    f0 = features[0]
    dtype, B = f0.dtype, f0.shape[0]
    if (dtype not in (torch.float32, torch.bfloat16) or len(sizes) != len(features)
            or any(f.dim() != 4 or f.dtype != dtype or f.shape[0] != B for f in features)):
        raise ValueError(f"roi_align_levels_bwd kernel takes (B, H, W, C) f32/bf16 maps of one "
                         f"dtype and batch, one size each, got "
                         f"{[(f.dtype, tuple(f.shape)) for f in features]} and sizes {sizes}")
    if rois.dim() != 3 or rois.shape[0] != B or rois.shape[2] != 4:
        raise ValueError(f"roi_align_levels_bwd kernel takes ({B}, K, 4) boxes, got "
                         f"{tuple(rois.shape)}")
    k = kernels.constants("roi_align_single_bwd")
    if not 1 <= len(features) <= k["MAX_L"]:
        raise ValueError(f"roi_align_levels_bwd kernel takes 1 to {k['MAX_L']} maps, "
                         f"got {len(features)}")
    esz = f0.element_size()
    vec = 16 // esz
    use_vec = all(f.shape[-1] % vec == 0 for f in features)
    v = vec if use_vec else 1
    rows = []
    for f, M in zip(features, sizes):
        H, W, C = f.shape[1:]
        if not (1 <= H <= k["GATHER_SIDE"] and 1 <= W <= k["GATHER_SIDE"] and C >= 1
                and n >= 1 and 1 <= int(M) * n <= k["MAX_S"]):
            raise ValueError(f"roi_align_levels_bwd kernel takes maps of 1 to {k['GATHER_SIDE']} "
                             f"rows and columns and 1 to {k['MAX_S']} samples per axis, got "
                             f"{tuple(f.shape)} at output {M}, sampling {n}")
        nv = min(C // v, BWD_SLAB_VECTORS)
        lpc_log2 = (nv - 1).bit_length()
        cb = min(k["MAX_CB"], k["NTHREADS"] >> lpc_log2)
        cs = nv * v
        rows.append((H, W, C, int(M), -(-H // k["BH"]), -(-W // cb), cb, -(-C // cs), cs,
                     lpc_log2))
    H, W, C = f0.shape[1:]
    M = int(sizes[0])
    per_roi = (len(features) == 1 and rois.shape[1] >= PER_ROI_MIN_K
               and H * W * C * 4 <= k["MAP_BYTES"] and M * n <= k["ROI_MAX_S"]
               and M * C * esz <= k["ROW_CAP"] and max(H, W) <= k["MAX_SIDE"]
               and W * C <= k["BIG_FLOATS"] and M * (H + W) <= k["DENSE_FLOATS"])
    plan = (use_vec, per_roi, rows)
    _BWD_PLANS[key] = plan
    return plan


def roi_align_levels_bwd(grads: Sequence[Tensor], features: Sequence[Tensor], rois: Tensor,
                         sizes: Sequence[int], scales: Sequence[float], sampling_ratio: int = 2,
                         aligned: bool = False) -> List[Tensor]:
    """The gradient of ``roi_align_levels``' outputs with respect to each
    map: grads (per map (B, K, M_l, M_l, C_l)), the forward's arguments →
    per map a (B, H_l, W_l, C_l) gradient in the maps' dtype, in one launch
    of the kernel for CUDA maps (reads only the maps' shapes and dtype), the
    plain version for CPU maps.  The boxes get no gradient."""
    f0 = features[0]
    if f0.device.type == "cpu":
        return roi_align_levels_bwd_plain(grads, features, rois, sizes, scales, sampling_ratio,
                                          aligned)
    n = int(sampling_ratio)
    use_vec, per_roi, rows = _bwd_plan(features, rois, sizes, n)
    dtype = f0.dtype
    B, K = rois.shape[:2]
    for g, (H, W, C, M) in zip(grads, (r[:4] for r in rows)):
        if g.shape != (B, K, M, M, C):
            raise ValueError(f"roi_align_levels_bwd kernel takes ({B}, {K}, {M}, {M}, {C}) output "
                             f"gradients, got {tuple(g.shape)}")
    grads = [_aligned16(g if g.dtype == dtype else g.to(dtype)) for g in grads]
    rois = _aligned16(rois.detach().float())
    dev = f0.get_device()
    if dev < 0 or any(t.get_device() != dev for t in (rois, *grads)):
        raise ValueError("roi_align_levels_bwd kernel inputs must share one CUDA device")
    outs = [torch.empty(f.shape, dtype=dtype, device=f0.device) for f in features]
    _, stream = kernels.device_and_stream(f0)
    bits = [struct.unpack("<i", struct.pack("<f", float(sc)))[0] for sc in scales]
    if per_roi:
        H, W, C, M = rows[0][:4]
        code = kernels.fn("roi_align_levels_bwd_rois")(
            grads[0].data_ptr(), outs[0].data_ptr(), rois.data_ptr(), B, K, H, W, C, M, n,
            bits[0], 1 if aligned else 0, 1 if dtype == torch.bfloat16 else 0, dev, stream)
        kernels.check(code, "roi_align_levels_bwd_rois")
        kernels.LAUNCHES["roi_align_single_bwd"] += 1
        return outs
    table = struct.pack(f"<{16 * len(outs)}q", *[
        v for g, o, r, sb in zip(grads, outs, rows, bits)
        for v in (g.data_ptr(), o.data_ptr(), *r, sb, 0, 0, 0)])
    code = kernels.fn("roi_align_levels_bwd")(
        table, len(outs), rois.data_ptr(), B, K, n, 1 if aligned else 0,
        1 if dtype == torch.bfloat16 else 0, 1 if use_vec else 0, dev, stream)
    kernels.check(code, "roi_align_levels_bwd")
    kernels.LAUNCHES["roi_align_single_bwd"] += 1
    return outs


class RoiAlignLevelsFn(torch.autograd.Function):
    """``roi_align_levels`` differentiable in the maps:
    ``apply(rois, sizes, scales, sampling_ratio, aligned, *features)`` → a
    tuple of per-map outputs.  The forward is the single-level kernel, the
    backward ``roi_align_levels_bwd`` (both the plain versions on CPU maps).
    The boxes get no gradient, as JAX's TPU kernel's vjp gives none."""

    @staticmethod
    def forward(ctx, rois, sizes, scales, sampling_ratio, aligned, *features):
        ctx.args = (tuple(sizes), tuple(scales), sampling_ratio, aligned)
        ctx.save_for_backward(rois, *features)
        return tuple(_levels_forward(features, rois, sizes, scales, sampling_ratio, aligned))

    @staticmethod
    def backward(ctx, *grads):
        rois, *features = ctx.saved_tensors
        sizes, scales, n, aligned = ctx.args
        B, K = rois.shape[:2]
        grads = [torch.zeros((B, K, M, M, f.shape[-1]), dtype=f.dtype, device=f.device)
                 if g is None else g for g, f, M in zip(grads, features, sizes)]
        return (None,) * 5 + tuple(roi_align_levels_bwd(grads, features, rois, sizes, scales, n,
                                                        aligned))


def roi_align_levels(features: Sequence[Tensor], rois: Tensor, sizes: Sequence[int],
                     scales: Sequence[float], sampling_ratio: int = 2,
                     aligned: bool = False) -> List[Tensor]:
    """The (B, K, 4) xyxy ROIs pooled from each of several (B, H_l, W_l, C_l)
    f32|bf16 maps (one dtype) at its own output size ``sizes[l]`` and scale
    ``scales[l]`` → per map (B, K, M_l, M_l, C_l): one launch of the kernel
    for CUDA maps, the plain version (one ``roi_align`` each) for CPU maps.
    The boxes are detached; when autograd needs the maps' gradient the call
    goes through ``RoiAlignLevelsFn``."""
    rois = rois.detach()
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return list(RoiAlignLevelsFn.apply(rois, tuple(int(M) for M in sizes),
                                           tuple(float(s) for s in scales), int(sampling_ratio),
                                           bool(aligned), *features))
    return _levels_forward(features, rois, sizes, scales, sampling_ratio, aligned)


def roi_align_single(features: Tensor, boxes: Tensor, output_size: int,
                     spatial_scale: float = 1.0, sampling_ratio: int = 2,
                     aligned: bool = False) -> Tensor:
    """features (B, H, W, C) f32|bf16, any C; boxes (B, K, 4) xyxy in image
    coordinates → (B, K, M, M, C) in the features' dtype: the single-map
    entry of ``roi_align_levels``."""
    return roi_align_levels([features], boxes, [output_size], [spatial_scale], sampling_ratio,
                            aligned)[0]
