"""PyTorch port, multiscale ROI-align: the plain versions against the JAX
packed path (``multiscale_roi_align_packed``, window 16, including ROIs
wider than the window) and the Pallas canvas kernel in interpret mode
(copies ``tests/test_pallas.py::test_pallas_canvas_multiscale_matches_xla``
and ``tests/test_roi_align.py::test_windowed_matches_canvas_for_in_window_rois``).
Tolerance: atol 1e-5, f32."""

import jax.numpy as jnp
import pytest
import numpy as np
import torch

from hd_yolo_tpu.ops.pallas_roi_align import multiscale_roi_align_canvas_pallas
from hd_yolo_tpu.ops.roi_align import _bounded_interp_matrix as jax_bounded_interp_matrix
from hd_yolo_tpu.ops.roi_align import multiscale_roi_align_packed as jax_packed
from hd_yolo_tpu_torch.ops.roi_align import (_bounded_interp_matrix,
                                             _multiscale_roi_align_canvas,
                                             multiscale_roi_align_canvas,
                                             multiscale_roi_align_packed)

STRIDES = (8.0, 16.0, 32.0, 64.0)


def _feats(rng, B, img, C):
    return [rng.standard_normal((B, img // int(s), img // int(s), C)).astype(np.float32)
            for s in STRIDES]


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def test_bounded_interp_matrix_matches_jax(rng):
    coords = rng.uniform(-3, 20, (5, 28)).astype(np.float32)
    lo = rng.integers(-2, 3, 5).astype(np.float32)
    hi = lo + rng.integers(4, 16, 5).astype(np.float32)
    got = _bounded_interp_matrix(torch.from_numpy(coords), torch.from_numpy(lo),
                                 torch.from_numpy(hi), 16, 14, 2)
    want = jax_bounded_interp_matrix(jnp.asarray(coords), jnp.asarray(lo), jnp.asarray(hi),
                                     16, 14, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def test_packed_matches_jax_including_wide_rois(rng):
    """The main path's pooling (window 16) against the JAX packed path; every
    4th ROI spans more than the window, so the border truncation is held too."""
    B, K, C, img = 2, 40, 8, 256
    feats = _feats(rng, B, img, C)
    levels = rng.integers(0, 4, K).astype(np.int32)
    b_idx = rng.integers(0, B, K).astype(np.int32)
    boxes = np.zeros((K, 4), np.float32)
    for k in range(K):
        s = STRIDES[levels[k]]
        span = 40 * s if k % 4 == 0 else 10 * s      # every 4th ROI wider than the window
        w, h = rng.uniform(2, span, 2)
        x1, y1 = rng.uniform(-12, img - 6, 2)
        boxes[k] = [x1, y1, x1 + w, y1 + h]
    want = jax_packed(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes),
                      jnp.asarray(levels), jnp.asarray(b_idx), STRIDES, 7, window=16)
    got = multiscale_roi_align_packed(_t(feats), torch.from_numpy(boxes),
                                      torch.from_numpy(levels), torch.from_numpy(b_idx),
                                      STRIDES, 7, window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_canvas_bounds_match_pallas_interpret(rng):
    """Copies ``tests/test_pallas.py::test_pallas_canvas_multiscale_matches_xla``:
    the kernel's contract with the whole canvas as the window."""
    B, K, C = 2, 9, 8
    feats = [rng.standard_normal((B, 64 >> i, 64 >> i, C)).astype(np.float32) for i in range(4)]
    boxes = rng.uniform(-40, 520, (B, K, 4)).astype(np.float32)       # some off-edge
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(2, 120, (B, K, 2))
    levels = rng.integers(0, 4, (B, K)).astype(np.int32)
    want = multiscale_roi_align_canvas_pallas(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes), jnp.asarray(levels), STRIDES,
        7, 2, False, 4, True)
    got = multiscale_roi_align_canvas(_t(feats), torch.from_numpy(boxes),
                                      torch.from_numpy(levels), STRIDES, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    einsum = _multiscale_roi_align_canvas(_t(feats), torch.from_numpy(boxes),
                                          torch.from_numpy(levels), STRIDES, 7)
    np.testing.assert_allclose(einsum.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_packed_equals_canvas_for_in_window_rois(rng):
    """Inside the window (span <= window-2 cells) the packed path is exact.
    Copies ``tests/test_roi_align.py::test_windowed_matches_canvas_for_in_window_rois``."""
    B, K, C, img = 2, 29, 8, 256
    feats = _feats(rng, B, img, C)
    levels = rng.integers(0, 4, (B, K)).astype(np.int32)
    boxes = np.zeros((B, K, 4), np.float32)
    for b in range(B):
        for k in range(K):
            s = STRIDES[levels[b, k]]
            w, h = rng.uniform(2, 10 * s, 2)
            x1, y1 = rng.uniform(-12, img - 6, 2)
            boxes[b, k] = [x1, y1, x1 + w, y1 + h]
    canvas = multiscale_roi_align_canvas(_t(feats), torch.from_numpy(boxes),
                                         torch.from_numpy(levels), STRIDES, 7)
    b_idx = torch.arange(B).repeat_interleave(K)
    packed = multiscale_roi_align_packed(_t(feats), torch.from_numpy(boxes).reshape(B * K, 4),
                                         torch.from_numpy(levels).reshape(B * K), b_idx,
                                         STRIDES, 7, window=12)
    np.testing.assert_allclose(packed.reshape(canvas.shape).numpy(), canvas.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_bf16_canvas_keeps_dtype(rng):
    feats = [torch.from_numpy(f).to(torch.bfloat16) for f in _feats(rng, 1, 128, 8)]
    boxes = torch.tensor([[10.0, 12.0, 60.0, 50.0], [0.0, 0.0, 127.0, 127.0]])
    out = multiscale_roi_align_packed(feats, boxes, torch.tensor([0, 3]), torch.zeros(2),
                                      STRIDES, 14)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 14, 14, 8)
    assert torch.isfinite(out.float()).all()


# ------------------------------------------------ the level table (no canvas)
FLAG_IMG = 640          # P3..P6 = 80, 40, 20, 10 rows: P6 is shorter than the 16-window


def _flagship_rois(rng, K, img=FLAG_IMG):
    """ROIs on every level: small ones, wide ones (past the 16-window), ones
    at the right and bottom edges (windows clamped on narrow levels, and on
    P6 straddling into P5's rows) and partly off the image."""
    levels = rng.integers(0, 4, K).astype(np.int32)
    boxes = np.zeros((K, 4), np.float32)
    for k in range(K):
        s = STRIDES[levels[k]]
        kind = k % 4
        w, h = rng.uniform(2, (40 if kind == 1 else 8) * s, 2)
        if kind == 2:                                 # right / bottom edge
            x1, y1 = img - rng.uniform(0.2, 3) * s, img - rng.uniform(0.2, 3) * s
        elif kind == 3:                               # top / left edge, partly off
            x1, y1 = rng.uniform(-2 * s, s, 2)
        else:
            x1, y1 = rng.uniform(-6, img - 6, 2)
        boxes[k] = [x1, y1, x1 + w, y1 + h]
    levels[2::8] = 3                                  # P6 edge ROIs: the window reaches P5
    return boxes, levels


def _capture_bounded(monkeypatch):
    """Record the arguments each ``roi_align_bounded`` call gets."""
    from hd_yolo_tpu_torch.ops import pallas_roi_align

    calls, orig = [], pallas_roi_align.roi_align_bounded

    def spy(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(pallas_roi_align, "roi_align_bounded", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["packed", "canvas"])
def test_level_table_equals_canvas_form(rng, monkeypatch, form, dtype):
    """The pooling reads each ROI's level map in place; on the same meta,
    coordinates and bounds it equals the stacked canvas read as one level
    (moff 0) bit for bit, since every canvas cell off the ROI's level has
    zero weight.  ROIs straddle P6/P5 (P6 has 10 rows), clamp at the right
    and bottom edges, and span past the window."""
    from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_bounded_plain
    from hd_yolo_tpu_torch.ops.roi_align import level_canvas

    B, K, C = 2, 48, 8
    feats = [torch.from_numpy(f).to(dtype) for f in _feats(rng, B, FLAG_IMG, C)]
    boxes, levels = _flagship_rois(rng, K)
    calls = _capture_bounded(monkeypatch)
    if form == "packed":
        b_idx = torch.from_numpy(rng.integers(0, B, K).astype(np.int32))
        got = multiscale_roi_align_packed(feats, torch.from_numpy(boxes),
                                          torch.from_numpy(levels), b_idx, STRIDES, 14)
    else:
        got = multiscale_roi_align_canvas(feats, torch.from_numpy(boxes).reshape(B, K // B, 4),
                                          torch.from_numpy(levels).reshape(B, K // B),
                                          STRIDES, 7)
    (levs, meta, ys, xs, bounds, window, M, n, *_), = calls
    assert [l.data_ptr() for l in levs] == [f.data_ptr() for f in feats]     # read in place
    canvas, _ = level_canvas(feats, STRIDES)
    one_level = meta.clone()
    one_level[:, 3] = 0
    want = roi_align_bounded_plain([canvas], one_level, ys, xs, bounds, window, M, n)
    assert torch.equal(got.reshape(want.shape), want)
    if form == "packed":
        Ht = canvas.shape[1]
        lv = meta[:, 3].long()
        oy = meta[:, 1].long()
        moff = torch.tensor([0, 80, 120, 140])[lv]
        h = torch.tensor([80, 40, 20, 10])[lv]
        straddle = (lv == 3) & (oy < moff)                      # P6 windows reaching P5
        assert int(straddle.sum()) > 0 and bool((oy + window[0] <= Ht).all())
        assert int(((lv > 0) & (meta[:, 2] + window[1] > torch.tensor([80, 40, 20, 10])[lv]))
                   .sum()) > 0                                  # windows past narrow levels
        assert int((oy + window[0] > moff + h).sum()) > 0


@pytest.mark.parametrize("form", ["packed", "canvas"])
def test_level_table_matches_jax_on_flagship_levels(rng, form):
    """The same edge, straddling and wide ROIs against JAX's packed path and
    its Pallas canvas kernel in interpret mode (f32, M 7, atol 3e-5: on
    640 px levels a canvas-space sample coordinate reaches row ~150, where
    one f32 ulp is 1.5e-5, and the two frameworks may round it apart; the
    256 px tests above hold 1e-5)."""
    B, K, C = 2, 48, 8
    feats = _feats(rng, B, FLAG_IMG, C)
    boxes, levels = _flagship_rois(rng, K)
    if form == "packed":
        b_idx = rng.integers(0, B, K).astype(np.int32)
        want = jax_packed(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes),
                          jnp.asarray(levels), jnp.asarray(b_idx), STRIDES, 7, window=16)
        got = multiscale_roi_align_packed(_t(feats), torch.from_numpy(boxes),
                                          torch.from_numpy(levels), torch.from_numpy(b_idx),
                                          STRIDES, 7, window=16)
    else:
        bb, ll = boxes.reshape(B, K // B, 4), levels.reshape(B, K // B)
        want = multiscale_roi_align_canvas_pallas(
            tuple(jnp.asarray(f) for f in feats), jnp.asarray(bb), jnp.asarray(ll), STRIDES,
            7, 2, False, 4, True)
        got = multiscale_roi_align_canvas(_t(feats), torch.from_numpy(bb), torch.from_numpy(ll),
                                          STRIDES, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=3e-5)
    assert np.abs(np.asarray(want)).max() > 0.1


@pytest.mark.parametrize("active", [0, 1, 17, 40])
def test_active_prefix_pools_leading_rois_only(rng, active):
    """``active`` pools the leading ROIs (equal to JAX's pooled rows at the
    tolerance above, and to the all-active result bit for bit) and writes
    exactly 0 to the rest."""
    B, K, C = 2, 40, 8
    feats = _feats(rng, B, FLAG_IMG, C)
    boxes, levels = _flagship_rois(rng, K)
    b_idx = rng.integers(0, B, K).astype(np.int32)
    args = (_t(feats), torch.from_numpy(boxes), torch.from_numpy(levels),
            torch.from_numpy(b_idx), STRIDES, 7)
    got = multiscale_roi_align_packed(*args, active=torch.tensor(active))
    full = multiscale_roi_align_packed(*args)
    want = np.asarray(jax_packed(tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes),
                                 jnp.asarray(levels), jnp.asarray(b_idx), STRIDES, 7, window=16))
    assert torch.equal(got[:active], full[:active])
    np.testing.assert_allclose(got[:active].numpy(), want[:active], rtol=0, atol=3e-5)
    assert bool((got[active:] == 0).all())
    assert tuple(got.shape) == (K, 7, 7, C)


def _meta_call(levels=None, K=3, M=7, n=2, C=8, dtype=torch.bfloat16, **over):
    """roi_align_bounded on meta tensors: no data, so only its argument checks run."""
    from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_bounded

    d = "meta"
    if levels is None:
        levels = [torch.empty((2, 16 >> i, 16 >> i, C), dtype=dtype, device=d) for i in range(2)]
    args = dict(meta=torch.empty((K, 4), dtype=torch.int32, device=d),
                ys=torch.empty((K, M * n), device=d), xs=torch.empty((K, M * n), device=d),
                bounds=torch.empty((K, 4), device=d), window=(16, 16), M=M, n=n, active=None)
    args.update(over)
    return roi_align_bounded(levels, **args)


@pytest.mark.parametrize("case", ["c_not_vec", "mixed_dtype", "f16", "samples", "nine_levels",
                                  "batch", "ys_shape", "not_cuda"])
def test_roi_align_bounded_raises_on_what_the_kernel_does_not_take(case):
    d = "meta"
    kw = {}
    if case == "c_not_vec":
        kw["C"] = 12                                  # bf16 takes C % 8 == 0
    elif case == "mixed_dtype":
        kw["levels"] = [torch.empty((2, 16, 16, 8), dtype=torch.bfloat16, device=d),
                        torch.empty((2, 8, 8, 8), dtype=torch.float32, device=d)]
    elif case == "f16":
        kw["dtype"] = torch.float16
    elif case == "samples":
        kw.update(M=33, n=2)
    elif case == "nine_levels":
        kw["levels"] = [torch.empty((2, 4, 4, 8), dtype=torch.bfloat16, device=d)] * 9
    elif case == "batch":
        kw["levels"] = [torch.empty((2, 16, 16, 8), dtype=torch.bfloat16, device=d),
                        torch.empty((3, 8, 8, 8), dtype=torch.bfloat16, device=d)]
    elif case == "ys_shape":
        kw["ys"] = torch.empty((3, 5), device=d)
    with pytest.raises(ValueError):
        _meta_call(**kw)                              # "not_cuda": valid, but not on a card
