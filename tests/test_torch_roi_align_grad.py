"""PyTorch port: the gradient of the multiscale ROI-align with respect to
the level maps (``ops/pallas_roi_align.RoiAlignBoundedFn`` on CPU maps: the
plain forward and ``roi_align_bounded_bwd_plain``), against ``jax.vjp`` of
the JAX package's canvas form (``_multiscale_roi_align_canvas``, the vjp its
``_canvas_bwd`` takes) and of its windowed form, on the same seeded inputs
and output cotangent.

* f32: within 1e-5·max|g| per level;
* bf16: within 2e-2·max|g| per level — both sides round the interpolation
  weights and the row intermediate to bf16 in the forward, and their
  gradients pass through those bf16 casts at different points (the port's
  index backward also sums in bf16);
* the boxes get no gradient, and ROIs at or past ``active`` add nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.ops.roi_align import _multiscale_roi_align_canvas, _multiscale_roi_align_windows
from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.ops import pallas_roi_align
from hd_yolo_tpu_torch.ops.roi_align import (multiscale_roi_align_canvas,
                                             multiscale_roi_align_packed)

STRIDES = (8.0, 16.0, 32.0, 64.0)


def inputs(seed, B=2, K=5, size=128, C=16):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, size // int(s), size // int(s), C)).astype(np.float32)
             for s in STRIDES]
    xy = rng.uniform(0, size * 0.8, (B, K, 2))
    wh = rng.uniform(3, 60, (B, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [-20.0, 100.0, 30.0, 160.0]           # partly outside the image
    levels = rng.integers(0, 4, (B, K)).astype(np.int32)
    return feats, boxes, levels, rng


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 16])
def test_roi_align_level_gradients_match_jax_vjp(dtype, rel, window):
    feats, boxes, levels, rng = inputs(0)
    B, K, M = boxes.shape[0], boxes.shape[1], 7
    C = feats[0].shape[-1]
    g = rng.standard_normal((B, K, M, M, C)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jf(fs):
        if window is None:
            return _multiscale_roi_align_canvas(tuple(fs), jnp.asarray(boxes), jnp.asarray(levels),
                                                STRIDES, M, 2, False)
        return _multiscale_roi_align_windows(tuple(fs), jnp.asarray(boxes), jnp.asarray(levels),
                                             STRIDES, M, 2, False, window)

    out, vjp = jax.vjp(jf, [jnp.asarray(f, jdt) for f in feats])
    (want,) = vjp(jnp.asarray(g, jdt))
    tf = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
    tb = torch.from_numpy(boxes).requires_grad_()
    if window is None:
        got = multiscale_roi_align_canvas(tf, tb, torch.from_numpy(levels), STRIDES, M)
    else:
        b_idx = torch.arange(B).repeat_interleave(K)
        got = multiscale_roi_align_packed(tf, tb.reshape(B * K, 4), torch.from_numpy(levels).reshape(-1),
                                          b_idx, STRIDES, M, window=window).reshape(B, K, M, M, C)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(out, np.float32),
                               rtol=0, atol=1e-5 if dtype == torch.float32 else 2e-2)
    got.backward(torch.from_numpy(g).to(dtype))
    assert tb.grad is None or float(tb.grad.abs().max()) == 0
    for lvl, (a, t) in enumerate(zip(want, tf)):
        a = np.asarray(a, np.float32)
        err = np.abs(t.grad.float().numpy() - a).max()
        assert err <= rel * np.abs(a).max(), (lvl, err, np.abs(a).max())
        assert t.grad.dtype == dtype


def test_bounded_backward_plain_active_rows_add_nothing():
    feats, boxes, levels, rng = inputs(1, B=1, K=6)
    M, n = 7, 2
    tf = [torch.from_numpy(f) for f in feats]
    from hd_yolo_tpu_torch.ops.roi_align import level_meta, sample_coords
    meta = level_meta(tf, STRIDES)
    lv = torch.from_numpy(levels[0])
    ys, xs, moff, mh, mw = sample_coords(torch.from_numpy(boxes[0]), lv, meta, M * n, False)
    bounds = torch.stack([moff, moff + mh, torch.zeros_like(mw), mw], -1)
    rmeta = torch.stack([torch.zeros_like(lv), torch.zeros_like(lv), torch.zeros_like(lv), lv], -1)
    Ht, W0 = sum(f.shape[1] for f in tf), tf[0].shape[2]
    g = torch.from_numpy(rng.standard_normal((6, M, M, tf[0].shape[-1])).astype(np.float32))
    args = (tf, rmeta, ys, xs, bounds, (Ht, W0), M, n)
    part = pallas_roi_align.roi_align_bounded_bwd(g, *args[:-2], M, n, torch.tensor(4))
    first = pallas_roi_align.roi_align_bounded_bwd(g[:4], tf, rmeta[:4], ys[:4], xs[:4],
                                                   bounds[:4], (Ht, W0), M, n)
    for a, b in zip(part, first):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert any(float(a.abs().max()) > 0 for a in part)


@pytest.mark.parametrize("shapes,B,C,dtype", [
    (((80, 80), (40, 40), (20, 20), (10, 10)), 16, 256, torch.bfloat16),   # yolo training
    (((160, 160), (80, 80), (40, 40), (20, 20)), 4, 256, torch.bfloat16),  # hnet training
    (((37, 29), (19, 15), (10, 8)), 2, 12, torch.float32),                 # ragged, 3 vectors
    (((23, 17), (12, 9)), 3, 6, torch.bfloat16),                           # single elements
    (((9, 300),), 1, 1000, torch.float32),                                 # wide, many slabs
])
def test_bounded_bwd_plan_covers_every_cell_once(shapes, B, C, dtype):
    """``roi_align_bwd.cu``'s tiling from ``_bounded_bwd_plan``, on meta
    tensors: decoded as the gather decodes its blocks, the tiles cover every
    (image, row, column, channel) of every level exactly once, and the plan
    keeps the kernel's limits (a lane group per tile row, at most 32 channel
    vectors a slab, tile indices below 2^16, a record that holds a ROI's
    entries and one run start per index of the largest side)."""
    levels = [torch.empty((B, h, w, C), dtype=dtype, device="meta") for h, w in shapes]
    width = 8 if dtype == torch.bfloat16 else 4
    vec = width if C % width == 0 else 1
    M, n = 14, 2
    head, tiles, rec = pallas_roi_align._bounded_bwd_plan(
        [tuple(f.shape[1:3]) for f in levels], B, C, vec, M, n)
    th, cvs, lpc_log2, rec_h, e_max, rs, batch, _ = head
    k = kernels.constants("roi_align_bwd")
    ncv = C // vec
    assert rec == rec_h and rec % 16 == 0 and batch == B
    assert 1 <= cvs <= min(32, ncv) and cvs <= 1 << lpc_log2 <= 32 and (cvs - 1) < 1 << lpc_log2
    assert th == k["NWARPS"] * (32 >> lpc_log2)
    assert e_max == 2 * M * n and rs >= max(max(s) for s in shapes) + 1
    assert rec >= 16 + 10 * e_max + 2 * rs
    tw = k["TW"]
    for (h, w), (nty, ntx, nslab) in zip(shapes, tiles):
        assert nty < 1 << 16 and ntx < 1 << 16
        seen = np.zeros((B, h, w, ncv), np.int32)
        for unit in range(B * nty * ntx * nslab):       # the kernel's decode
            slab, u = unit % nslab, unit // nslab
            tx, u = u % ntx, u // ntx
            ty, b = u % nty, u // nty
            lanes = np.arange(BWD_LANES := 32)
            for warp in range(k["NWARPS"]):
                cv = lanes & ((1 << lpc_log2) - 1)
                y = ty * th + warp * (32 >> lpc_log2) + (lanes >> lpc_log2)
                c = slab * cvs + cv
                live = (cv < min(cvs, ncv - slab * cvs)) & (y < h)
                for j in range(tw):
                    x = tx * tw + j
                    if x < w:
                        np.add.at(seen, (b, y[live], x, c[live]), 1)
        assert (seen == 1).all()
