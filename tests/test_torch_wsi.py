"""PyTorch port, whole-slide tiling and stitching (``hd_yolo_tpu_torch/wsi``)
against ``hd_yolo_tpu/wsi/tiling.py``: the slide tests of
``tests/test_wsi_preproc.py``, each running the same toy forward through
both ``slide_inference``s and comparing the returned dicts key by key.

The toy forwards are written in jnp, as in the JAX tests; the port's side
calls the same function on its tiles (torch → numpy → jnp → numpy → torch),
so both stitches see identical per-tile outputs.  Tolerances: keys,
shapes, counts, indices, labels, validity and uint8/bit masks exactly;
boxes, scores and f32 masks atol 1e-5 (f32 on both sides).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.wsi import extract_tiles as jax_extract_tiles
from hd_yolo_tpu.wsi import slide_inference as jax_slide_inference
from hd_yolo_tpu.wsi import sliding_window_grid as jax_grid
from hd_yolo_tpu_torch.wsi import extract_tiles, slide_inference, sliding_window_grid


def _torch_forward(jax_forward, with_vars=False):
    def to_torch(out):
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}

    if with_vars:
        return lambda fv, t: to_torch(jax_forward({k: jnp.asarray(v.numpy()) for k, v in fv.items()},
                                                  jnp.asarray(t.numpy())))
    return lambda t: to_torch(jax_forward(jnp.asarray(t.numpy())))


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype == bool or w.dtype == np.uint8 or np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype or np.issubdtype(g.dtype, np.integer), (k, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)


def both(jax_forward, slide, with_vars=False, fvars=None, reset=None, **kw):
    """(port, jax) outputs of the same toy forward on the same slide."""
    tfv = None if fvars is None else {k: torch.tensor(np.asarray(v)) for k, v in fvars.items()}
    if reset:
        reset()
    want = jax_slide_inference(jax_forward, jnp.asarray(slide), forward_vars=fvars, **kw)
    if reset:
        reset()
    got = slide_inference(_torch_forward(jax_forward, with_vars), torch.from_numpy(slide),
                          forward_vars=tfv, **kw)
    assert_same(got, want)
    return got, want


@pytest.mark.parametrize("h,w,tile,overlap", [(1000, 1500, 640, 64), (320, 320, 640, 64),
                                              (4096, 4096, 640, 64), (300, 410, 128, 32),
                                              (640, 641, 640, 64)])
def test_grid_matches_jax(h, w, tile, overlap):
    g = sliding_window_grid(h, w, tile, overlap)
    np.testing.assert_array_equal(g, jax_grid(h, w, tile, overlap))
    assert g.dtype == np.int32
    assert (g[:, 0] + tile <= max(h, tile)).all() and (g[:, 1] + tile <= max(w, tile)).all()


def test_extract_tiles_matches_jax(rng):
    slide = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    origins = np.asarray([[0, 0], [100, 60], [192, 192]], np.int32)
    want = np.asarray(jax_extract_tiles(jnp.asarray(slide), jnp.asarray(origins), 64))
    got = extract_tiles(torch.from_numpy(slide), torch.from_numpy(origins), 64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), slide[100:164, 60:124])
    u8 = (slide * 255).astype(np.uint8)
    assert extract_tiles(torch.from_numpy(u8), torch.from_numpy(origins), 64).dtype == torch.uint8


def _fixed_box_forward(tiles):
    B, D = tiles.shape[0], 4
    return {"boxes": jnp.tile(jnp.asarray([[10.0, 10.0, 30.0, 30.0]]), (B, D, 1)),
            "scores": jnp.tile(jnp.asarray([0.9] + [0.0] * (D - 1)), (B, 1)),
            "labels": jnp.ones((B, D), jnp.int32),
            "valid": jnp.tile(jnp.asarray([True] + [False] * (D - 1)), (B, 1))}


@pytest.mark.parametrize("fused", [False, True])
def test_slide_inference_stitching(fused):
    got, _ = both(_fixed_box_forward, np.zeros((200, 328, 3), np.float32), tile=128, overlap=28,
                  batch=4, max_total=64, fused=fused)
    v = got["valid"]
    assert v.sum() == 6
    want = {(y + 10, x + 10) for y in (0, 72) for x in (0, 100, 200)}
    assert {(int(b[1]), int(b[0])) for b in got["boxes"][v]} == want


@pytest.mark.parametrize("overlap,n_kept", [(118, 2), (124, 1)])
def test_slide_inference_dedups_overlap(overlap, n_kept):
    """Two tiles offset by 10 px (IoU 0.33: both survive) or 4 px (IoU 0.71:
    the stitch keeps one)."""
    def forward(tiles):
        B = tiles.shape[0]
        return {"boxes": jnp.tile(jnp.asarray([[40.0, 40.0, 60.0, 60.0]]), (B, 1, 1)),
                "scores": jnp.full((B, 1), 0.8), "labels": jnp.ones((B, 1), jnp.int32),
                "valid": jnp.ones((B, 1), bool)}

    got, _ = both(forward, np.zeros((128, 256 - overlap, 3), np.float32), tile=128,
                  overlap=overlap, batch=2, max_total=16)
    assert got["valid"].sum() == n_kept


def test_slide_inference_with_masks():
    D, R = 4, 2

    def forward(tiles):
        B = tiles.shape[0]
        out = _fixed_box_forward(tiles)
        fp = jnp.mean(tiles, axis=(1, 2, 3))
        out["masks"] = jnp.tile(fp[:, None, None, None], (1, R, 8, 8))
        out["mask_valid"] = jnp.tile(jnp.asarray([True] + [False] * (R - 1)), (B, 1))
        return out

    H, W, tile, overlap = 200, 328, 128, 28
    slide = np.zeros((H, W, 3), np.float32)
    grid = sliding_window_grid(H, W, tile, overlap)
    for i, (y, x) in enumerate(grid):
        slide[y: y + tile, x: x + tile] = 0.1 * (i + 1)
    expect_fp = {(int(y), int(x)): float(slide[y: y + tile, x: x + tile].mean()) for y, x in grid}
    got, _ = both(forward, slide, tile=tile, overlap=overlap, batch=2, max_total=64)
    v = got["valid"]
    assert v.sum() == len(grid) and got["masks"].shape[1:] == (8, 8)
    for b, m, mv in zip(got["boxes"][v], got["masks"][v], got["mask_valid"][v]):
        assert mv
        np.testing.assert_allclose(m, expect_fp[(int(b[1]) - 10, int(b[0]) - 10)], atol=1e-5)


def _row_forward(D, R, derive=False):
    def forward(tiles):
        B = tiles.shape[0]
        x0 = 20.0 * jnp.arange(D) + 2.0
        boxes = jnp.stack([x0, jnp.full((D,), 2.0), x0 + 16.0, jnp.full((D,), 18.0)], -1)
        out = {"boxes": jnp.tile(boxes[None], (B, 1, 1)),
               "scores": jnp.tile(jnp.linspace(0.9, 0.5, D)[None], (B, 1)),
               "labels": jnp.ones((B, D), jnp.int32), "valid": jnp.ones((B, D), bool),
               "masks": jnp.ones((B, R, 8, 8), jnp.float32)}
        if not derive:
            out["mask_valid"] = jnp.ones((B, R), bool)
        return out
    return forward


@pytest.mark.parametrize("derive", [False, True])
def test_slide_inference_over_mask_capacity(derive):
    """More detections than mask slots: slots >= R carry mask_valid False and
    a zero mask; a forward without mask_valid gets it derived from valid."""
    D, R = 12, 4
    got, _ = both(_row_forward(D, R, derive), np.zeros((256, 256, 3), np.float32), tile=256,
                  overlap=0, batch=1, max_total=64)
    v = got["valid"]
    assert v.sum() == D and got["mask_valid"][v].sum() == R
    for m, ok in zip(got["masks"][v], got["mask_valid"][v]):
        np.testing.assert_allclose(m, 1.0 if ok else 0.0)


def _mean_forward(D, M, mask_lo=0.0, mask_hi=1.0, extra=False, s0=(0.6, 0.3), s1=(0.5, 0.2),
                  labels_from=0):
    def forward(fvars, tiles):
        B = tiles.shape[0]
        mean = tiles.mean(axis=(1, 2, 3))
        boxes = jnp.zeros((B, D, 4))
        boxes = boxes.at[:, 0].set(jnp.asarray([5.0, 7.0, 60.0, 50.0]))
        boxes = boxes.at[:, 1].set(jnp.asarray([70.0, 70.0, 110.0, 100.0]))
        scores = jnp.zeros((B, D))
        scores = scores.at[:, 0].set(s0[0] + s0[1] * mean + fvars["bias"])
        scores = scores.at[:, 1].set(s1[0] + s1[1] * mean)
        labels = jnp.tile(labels_from + jnp.arange(D) % 2, (B, 1)).astype(jnp.int32)
        valid = jnp.zeros((B, D), bool).at[:, :2].set(True)
        masks = (mask_lo + mask_hi * mean[:, None, None, None]) * jnp.ones((B, M, 8, 8))
        out = {"boxes": boxes, "scores": scores, "labels": labels, "valid": valid,
               "masks": masks}
        if extra:
            out["score_vector"] = jnp.ones((B, D, 3))
        return out
    return forward


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("opts", [{}, {"mask_uint8": True}, {"mask_bits": True},
                                  {"packed_fetch": False}, {"class_aware_nms": False},
                                  {"band_limit": False}])
def test_slide_inference_modes_match_jax(rng, fused, opts):
    """12 tiles in batches of 4 and 8 (grid-pad duplicates in fused mode):
    each fetch/quantisation option in both modes."""
    fvars = {"bias": jnp.float32(0.05)}
    slide = rng.uniform(0, 1, (300, 430, 3)).astype(np.float32)
    for batch in (4, 8):
        got, want = both(_mean_forward(6, 3), slide, with_vars=True, fvars=fvars, tile=128,
                         overlap=28, batch=batch, max_total=64, fused=fused, **opts)
        assert got["valid"].sum() > 0
        if opts.get("mask_uint8"):
            assert got["masks"].dtype == np.uint8
        if opts.get("mask_bits"):
            assert got["masks"].dtype == bool


def test_slide_inference_fused_matches_streaming(rng):
    fvars = {"bias": jnp.float32(0.05)}
    slide = rng.uniform(0, 1, (300, 430, 3)).astype(np.float32)
    kw = dict(with_vars=True, fvars=fvars, tile=128, overlap=28, batch=4, max_total=64)
    a, _ = both(_mean_forward(6, 3), slide, **kw)
    b, _ = both(_mean_forward(6, 3), slide, fused=True, **kw)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    q, _ = both(_mean_forward(6, 3), slide, fused=True, mask_uint8=True, **kw)
    np.testing.assert_allclose(q["masks"].astype(np.float32),
                               np.round(np.clip(b["masks"], 0, 1) * 255), atol=1)


@pytest.mark.parametrize("H,W", [(320, 416), (300, 410)])
@pytest.mark.parametrize("band_limit", [False, True])
def test_band_limited_stitch_matches_jax_and_full_nms(rng, H, W, band_limit):
    """Lattice-aligned duplicates in the overlap bands; (300, 410) is a
    snapped grid.  Each side's band stitch equals its full stitch, and the
    port equals JAX in each mode."""
    tile, overlap = 128, 32
    grid = sliding_window_grid(H, W, tile, overlap)
    per_tile = []
    for (y0, x0) in grid:
        cells = [(cy, cx) for cy in range(8, tile - 26, 40) for cx in range(8, tile - 26, 40)]
        take = rng.permutation(len(cells))[: rng.integers(4, len(cells))]
        boxes, scores, labels = [], [], []
        for t in take:
            cy, cx = cells[t]
            gy, gx = y0 + cy, x0 + cx
            gy, gx = gy - gy % 8, gx - gx % 8
            boxes.append([gx - x0, gy - y0, gx - x0 + 24, gy - y0 + 24])
            scores.append(float(rng.uniform(0.2, 0.95)))
            labels.append(int(rng.integers(1, 3)))
        per_tile.append((np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
                         np.asarray(labels, np.int32)))
    D = 16
    calls = {"i": 0}

    def forward(tiles):
        B = tiles.shape[0]
        bx = np.zeros((B, D, 4), np.float32)
        sc = np.zeros((B, D), np.float32)
        lb = np.ones((B, D), np.int32)
        va = np.zeros((B, D), bool)
        for j in range(B):
            b, s, l = per_tile[min(calls["i"], len(per_tile) - 1)]
            n = min(len(b), D)
            bx[j, :n], sc[j, :n], lb[j, :n], va[j, :n] = b[:n], s[:n], l[:n], True
            calls["i"] += 1
        return {"boxes": jnp.asarray(bx), "scores": jnp.asarray(sc), "labels": jnp.asarray(lb),
                "valid": jnp.asarray(va)}

    def reset():
        calls["i"] = 0

    kw = dict(tile=tile, overlap=overlap, batch=2, max_total=256, reset=reset)
    got, _ = both(forward, np.zeros((H, W, 3), np.float32), band_limit=band_limit, **kw)
    full, _ = both(forward, np.zeros((H, W, 3), np.float32), band_limit=False, **kw)

    def rows(out):
        v = out["valid"]
        return {tuple(np.round(b, 2)) + (round(float(s), 4), int(l))
                for b, s, l in zip(out["boxes"][v], out["scores"][v], out["labels"][v])}

    assert rows(got) == rows(full)
    assert got["valid"].sum() > 10


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mask_rows", [None, 32, 4])
def test_mask_row_compaction_and_row_keys(rng, fused, mask_rows):
    """Compaction (mask_rows) equals the dense fetch while the capacity holds;
    over it the lowest-scored rows lose mask_valid; row_keys drops the other
    per-row keys; bit-packed masks through the compact path."""
    fwd = _mean_forward(6, 4, mask_lo=0.6, mask_hi=0.4, extra=True, s0=(0.55, 0.4),
                        s1=(0.25, 0.2), labels_from=1)
    fvars = {"bias": jnp.float32(0.0)}
    slide = rng.uniform(0, 1, (300, 430, 3)).astype(np.float32)
    kw = dict(with_vars=True, fvars=fvars, tile=128, overlap=28, batch=4, max_total=64,
              fused=fused)
    dense, _ = both(fwd, slide, mask_rows=None, **kw)
    comp, _ = both(fwd, slide, mask_rows=mask_rows, **kw)
    mv = dense["mask_valid"]
    if mask_rows != 4:
        np.testing.assert_allclose(dense["masks"][mv], comp["masks"][mv], atol=1e-6)
        assert mask_rows is None or not comp["masks"][~mv].any()  # compacted: zeroed
    else:
        lost = dense["mask_valid"] & ~comp["mask_valid"]
        assert lost.any()
        assert dense["scores"][lost].max() <= dense["scores"][comp["mask_valid"]].min() + 1e-6
    bits, _ = both(fwd, slide, mask_rows=mask_rows, mask_bits=True, **kw)
    kept = bits["mask_valid"]
    np.testing.assert_array_equal(bits["masks"][kept], dense["masks"][kept] > 0.5)
    lite, _ = both(fwd, slide, mask_rows=mask_rows, row_keys=("masks",), **kw)
    assert "score_vector" not in lite and "score_vector" in dense
    np.testing.assert_allclose(lite["boxes"], dense["boxes"], atol=1e-6)


def test_band_limit_snapped_grid_duplicate_suppressed():
    tile, overlap, H, W = 256, 32, 300, 256
    box = np.asarray([100.0, 150.0, 140.0, 190.0])
    D = 4

    def forward(tiles):
        B = tiles.shape[0]
        bx = np.zeros((B, D, 4), np.float32)
        sc = np.zeros((B, D), np.float32)
        va = np.zeros((B, D), bool)
        for j, (y0, x0) in enumerate([(0, 0), (44, 0)][:B]):
            bx[j, 0] = box - np.asarray([x0, y0, x0, y0])
            sc[j, 0] = 0.9 - 0.1 * j
            va[j, 0] = True
        return {"boxes": jnp.asarray(bx), "scores": jnp.asarray(sc),
                "labels": jnp.ones((B, D), jnp.int32), "valid": jnp.asarray(va)}

    for band_limit in (False, True):
        got, _ = both(forward, np.zeros((H, W, 3), np.float32), tile=tile, overlap=overlap,
                      batch=2, max_total=64, band_limit=band_limit)
        assert int(got["valid"].sum()) == 1
        np.testing.assert_allclose(got["boxes"][got["valid"]][0], box, atol=1e-4)
        assert float(got["scores"][got["valid"]][0]) == pytest.approx(0.9)


@pytest.mark.parametrize("fused", [False, True])
def test_band_saturation_warns_like_jax(fused):
    """max_band below the band population: both warn and drop the same rows."""
    def forward(tiles):
        B, D = tiles.shape[0], 8
        x0 = 14.0 * jnp.arange(D) + 1.0
        boxes = jnp.stack([x0, jnp.full((D,), 1.0), x0 + 12.0, jnp.full((D,), 13.0)], -1)
        return {"boxes": jnp.tile(boxes[None], (B, 1, 1)),
                "scores": jnp.tile(jnp.linspace(0.9, 0.3, D)[None], (B, 1))
                + 0.01 * jnp.arange(B)[:, None],
                "labels": jnp.ones((B, D), jnp.int32), "valid": jnp.ones((B, D), bool)}

    kw = dict(tile=128, overlap=28, batch=4, max_total=64, max_band=8, fused=fused)
    slide = np.zeros((200, 328, 3), np.float32)
    with pytest.warns(RuntimeWarning, match="max_band=8"):
        want = jax_slide_inference(forward, jnp.asarray(slide), **kw)
    with pytest.warns(RuntimeWarning, match="max_band=8"):
        got = slide_inference(_torch_forward(forward), torch.from_numpy(slide), **kw)
    assert_same(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        both(forward, slide, **{**kw, "max_band": 1024})
