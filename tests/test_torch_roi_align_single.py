"""PyTorch port, single-level ROI-align: the plain version ``roi_align``
(what the kernel's wrapper ``roi_align_single`` runs on CPU tensors) against
the JAX ``roi_align`` under
``vmap`` and against the Pallas kernel ``roi_align_pallas`` in interpret
mode, in f32 and bf16, at sampling ratios 1 and 2, with boxes partly off the
map, zero-area boxes and more than 64 samples per axis.

Tolerances: f32 atol 1e-5.  bf16: both sides round the interpolation
matrices and the row intermediate to bf16 and accumulate in f32, in other
orders, so a row value may round to the neighbouring bf16 value: |d| <=
2^-7 · max|output| (one bf16 rounding step at the output's scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.ops.pallas_roi_align import roi_align_pallas
from hd_yolo_tpu.ops.roi_align import multiscale_roi_align_batched as jax_batched
from hd_yolo_tpu.ops.roi_align import roi_align as jax_roi_align
from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_single
from hd_yolo_tpu_torch.ops.roi_align import (_interp_matrix, multiscale_roi_align_canvas,
                                             multiscale_roi_align_packed)

STRIDES = (8.0, 16.0, 32.0, 64.0)


def _boxes(rng, B, K, span):
    """(B, K, 4) boxes, some partly off the map, the first of each image of zero area."""
    xy = rng.uniform(-0.2 * span, span, (B, K, 2))
    wh = rng.uniform(0.0, 0.7 * span, (B, K, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 0, 2:] = boxes[:, 0, :2]
    return boxes


def _jax(f, b, M, scale, n, aligned=False):
    return np.asarray(jax.vmap(lambda ff, bb: jax_roi_align(
        ff, bb, M, spatial_scale=scale, sampling_ratio=n, aligned=aligned))(
        jnp.asarray(f), jnp.asarray(b))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("M,H,W,C", [(7, 19, 23, 5), (14, 32, 20, 16), (40, 12, 9, 8)])
def test_roi_align_f32_matches_jax(rng, n, M, H, W, C):
    """(40, n=2) is 80 samples per axis: past the multiscale kernel's 64."""
    B, K, scale = 2, 6, 0.25
    f = rng.standard_normal((B, H, W, C)).astype(np.float32)
    b = _boxes(rng, B, K, W / scale)
    n0 = kernels.LAUNCHES["roi_align_single"]
    got = roi_align_single(torch.from_numpy(f), torch.from_numpy(b), M, scale, n)
    assert kernels.LAUNCHES["roi_align_single"] == n0          # CPU tensors: the plain version
    assert got.shape == (B, K, M, M, C) and got.dtype == torch.float32
    want = _jax(f, b, M, scale, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_roi_align_aligned_matches_jax(rng):
    f = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    b = _boxes(rng, 1, 5, 64.0)
    got = roi_align_single(torch.from_numpy(f), torch.from_numpy(b), 7, 0.25, 2, aligned=True)
    np.testing.assert_allclose(got.numpy(), _jax(f, b, 7, 0.25, 2, aligned=True), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2])
def test_roi_align_bf16_matches_jax(rng, n):
    B, K, H, W, C, M, scale = 2, 5, 24, 20, 16, 10, 0.5
    f = rng.standard_normal((B, H, W, C)).astype(np.float32)
    b = _boxes(rng, B, K, W / scale)
    ft = torch.from_numpy(f).to(torch.bfloat16)
    got = roi_align_single(ft, torch.from_numpy(b), M, scale, n)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax.vmap(lambda ff, bb: jax_roi_align(
        ff, bb, M, spatial_scale=scale, sampling_ratio=n))(
        jnp.asarray(ft.float().numpy()).astype(jnp.bfloat16), jnp.asarray(b))).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_roi_align_matches_pallas_interpret(rng):
    """The TPU kernel (interpret mode) computes the same function."""
    B, K, H, W, C, M = 2, 5, 16, 16, 8, 7
    f = rng.standard_normal((B, H, W, C)).astype(np.float32)
    b = _boxes(rng, B, K, 64.0)
    want = np.asarray(roi_align_pallas(jnp.asarray(f), jnp.asarray(b), M, 0.25, 2, False, 4,
                                       True))
    got = roi_align_single(torch.from_numpy(f), torch.from_numpy(b), M, 0.25, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_interp_matrix_rows_zero_out_of_range():
    coords = torch.tensor([-1.5, -1.0, -0.5, 0.25, 3.5, 4.0, 4.5])
    m = _interp_matrix(coords, 4)
    np.testing.assert_allclose(m.sum(-1).numpy(), [0, 0, 1, 1, 1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(m[2].numpy(), [1, 0, 0, 0])                    # clamped to 0
    np.testing.assert_allclose(m[3].numpy(), [0.75, 0.25, 0, 0])


def _per_level(feats, boxes, levels, strides, M):
    """Every box pooled from every level by the single-level ROI-align, each
    keeping its own level's result (the JAX package's differential form)."""
    out = 0
    for i, (f, s) in enumerate(zip(feats, strides)):
        out = out + roi_align_single(f, boxes, M, 1.0 / s) * (levels == i)[..., None, None, None]
    return out


def _window(feats, boxes, levels, strides, M):
    B, K = boxes.shape[:2]
    b_idx = torch.arange(B).repeat_interleave(K)
    out = multiscale_roi_align_packed(feats, boxes.reshape(B * K, 4), levels.reshape(B * K),
                                      b_idx, strides, M, window=12)
    return out.reshape((B, K) + out.shape[1:])


@pytest.mark.parametrize("mode", ["canvas", "per_level", "window"])
def test_multiscale_batched_matches_jax(rng, mode):
    """Three forms of the multiscale ROI-align against the JAX
    ``multiscale_roi_align_batched`` (its default canvas form): the canvas
    form the Mask R-CNN header runs, the single-level ROI-align per level,
    and the 12 x 12 window form (exact for ROIs whose span fits it, which
    these do)."""
    B, K, C, img = 2, 7, 8, 256
    feats = [rng.standard_normal((B, img // int(s), img // int(s), C)).astype(np.float32)
             for s in STRIDES]
    levels = rng.integers(0, 4, (B, K)).astype(np.int32)
    boxes = np.zeros((B, K, 4), np.float32)
    for i in range(B):
        for k in range(K):
            s = STRIDES[levels[i, k]]
            x1, y1 = rng.uniform(-8, img - 8, 2)
            w, h = rng.uniform(2, 8 * s, 2)
            boxes[i, k] = [x1, y1, x1 + w, y1 + h]
    want = np.asarray(jax_batched([jnp.asarray(f) for f in feats], jnp.asarray(boxes),
                                  jnp.asarray(levels), STRIDES, 7))
    fn = {"canvas": multiscale_roi_align_canvas, "per_level": _per_level, "window": _window}[mode]
    got = fn([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
             torch.from_numpy(levels), STRIDES, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


HNET_LEVELS = ((32, 4.0), (16, 8.0), (8, 16.0), (4, 32.0))


@pytest.mark.parametrize("C,dtype", [(8, np.float32), (5, np.float32), (6, "bfloat16")])
def test_roi_align_levels_plain_matches_four_jax_calls(rng, C, dtype):
    """``roi_align_levels`` on CPU maps (its plain version) against one JAX
    ``roi_align`` per level: a ragged C, each level at its own output size
    and scale, boxes partly off the maps and one of zero area.  f32 atol
    1e-5; bf16 as ``test_roi_align_bf16_matches_jax``."""
    from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_levels

    B, K = 2, 5
    feats = [rng.standard_normal((B, s, s, C)).astype(np.float32) for s, _ in HNET_LEVELS]
    boxes = _boxes(rng, B, K, 128.0)
    sizes, scales = [8, 4, 2, 1], [1.0 / st for _, st in HNET_LEVELS]
    tf = [torch.from_numpy(f) for f in feats]
    if dtype == "bfloat16":
        tf = [t.to(torch.bfloat16) for t in tf]
    n0 = kernels.LAUNCHES["roi_align_single"]
    got = roi_align_levels(tf, torch.from_numpy(boxes), sizes, scales, 2)
    assert kernels.LAUNCHES["roi_align_single"] == n0
    for t, g, M, s in zip(tf, got, sizes, scales):
        assert g.shape == (B, K, M, M, C) and g.dtype == t.dtype
        want = np.asarray(jax.vmap(lambda ff, bb: jax_roi_align(
            ff, bb, M, spatial_scale=s, sampling_ratio=2))(
            jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16"
                                                  else jnp.float32),
            jnp.asarray(boxes))).astype(np.float32)
        atol = 2.0 ** -7 * np.abs(want).max() if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(g.float().numpy(), want, rtol=0, atol=atol)


def test_extract_roi_feature_maps_pools_every_level_in_one_call(rng, monkeypatch):
    """hnet's ROI pyramid goes through ``roi_align_levels`` once for all its
    levels (one kernel launch on the card), and equals per-level pooling."""
    from hd_yolo_tpu_torch.hnet import feature_mosaic
    from hd_yolo_tpu_torch.ops import pallas_roi_align

    feats = [torch.from_numpy(rng.standard_normal((2, s, s, 8)).astype(np.float32))
             for s, _ in HNET_LEVELS]
    rois = torch.tensor([[[0.0, 0.0, 128.0, 128.0]], [[10.0, -5.0, 90.0, 60.0]]])
    calls = []
    orig = pallas_roi_align.roi_align_levels

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(feature_mosaic, "roi_align_levels", spy)
    got = feature_mosaic.extract_roi_feature_maps(feats, rois, [s for _, s in HNET_LEVELS],
                                                   roi_size=32)
    assert len(calls) == 1 and len(calls[0][0]) == 4
    for lvl, (f, (_, st)) in enumerate(zip(feats, HNET_LEVELS)):
        torch.testing.assert_close(got[lvl], roi_align_single(f, rois, 32 >> lvl, 1.0 / st),
                                   rtol=0, atol=0)


def test_roi_align_levels_rejects_what_the_kernel_does_not_take():
    """Off the CPU the wrapper launches the kernel or raises; the checks that
    come before the launch, reached with ``device="meta"`` maps."""
    from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_levels

    meta = dict(device="meta")
    boxes = torch.zeros((1, 2, 4), **meta)
    with pytest.raises(ValueError):                   # f16
        roi_align_levels([torch.zeros((1, 4, 4, 8), dtype=torch.float16, **meta)], boxes, [2],
                         [1.0])
    with pytest.raises(ValueError):                   # mixed dtypes
        roi_align_levels([torch.zeros((1, 4, 4, 8), **meta),
                          torch.zeros((1, 2, 2, 8), dtype=torch.bfloat16, **meta)], boxes,
                         [2, 1], [1.0, 0.5])
    with pytest.raises(ValueError):                   # one size per map
        roi_align_levels([torch.zeros((1, 4, 4, 8), **meta)], boxes, [2, 1], [1.0])
    with pytest.raises(ValueError):                   # boxes of another batch
        roi_align_levels([torch.zeros((1, 4, 4, 8), **meta)], torch.zeros((2, 2, 4), **meta),
                         [2], [1.0])
