"""PyTorch port, multiscale ROI-align: the plain versions against the JAX
packed path (``multiscale_roi_align_packed``, window 16, including ROIs
wider than the window) and the Pallas canvas kernel in interpret mode
(copies ``tests/test_pallas.py::test_pallas_canvas_multiscale_matches_xla``
and ``tests/test_roi_align.py::test_windowed_matches_canvas_for_in_window_rois``).
Tolerance: atol 1e-5, f32."""

import jax.numpy as jnp
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
