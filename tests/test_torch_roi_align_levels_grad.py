"""PyTorch port: the gradient of the single-level ROI-align with respect to
its maps (``ops/pallas_roi_align.RoiAlignLevelsFn`` on CPU maps: the plain
forward and ``roi_align_levels_bwd_plain``) against ``jax.vjp`` of the JAX
package's Pallas kernel ``roi_align_pallas`` in interpret mode, whose custom
vjp ``_roi_align_bwd`` takes the XLA vjp of the plain single-level form; on
the same seeded maps, boxes and output cotangents.

Cases: hnet's ROI pyramid (one whole-image ROI an image, each level at its
own output size and scale) with two to four maps; ragged boxes (partly off
the map, zero area, sizes that leave some bins three taps wide); the
confliction loss's site (5 channels, output 28, scale 1/16, boxes of 10-40
px).

Tolerances, per map against max|g| of the map's JAX gradient: f32 1e-5
(sums of more than two terms in another order); bf16 2^-7, one bf16
rounding step at the gradient's scale (both sides round the interpolation
weights, the row gradient and the result to bf16, summing in f32 in other
orders).  The boxes get no gradient (JAX's TPU kernel's vjp gives them
zeros).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.ops.pallas_roi_align import roi_align_pallas
from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.ops import pallas_roi_align
from hd_yolo_tpu_torch.ops.pallas_roi_align import roi_align_levels, roi_align_single

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def pyramid(rng, n_maps, B=2, size=32, C=8):
    """hnet's pyramid at a small size: maps of size >> l, one whole-image ROI
    an image, each level pooled to its own size."""
    feats = [rng.standard_normal((B, size >> l, size >> l, C)).astype(np.float32)
             for l in range(n_maps)]
    rois = np.tile(np.asarray([0.0, 0.0, 4.0 * size, 4.0 * size], np.float32), (B, 1, 1))
    return feats, rois, [size >> l for l in range(n_maps)], [1.0 / (4.0 * 2 ** l)
                                                            for l in range(n_maps)]


def ragged(rng, B=2, K=5):
    feats = [rng.standard_normal((B, 19, 23, 8)).astype(np.float32),
             rng.standard_normal((B, 10, 12, 8)).astype(np.float32)]
    xy = rng.uniform(-20, 150, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 90, (B, K, 2))], -1).astype(np.float32)
    boxes[:, 0, 2:] = boxes[:, 0, :2]                     # zero area
    return feats, boxes, [7, 5], [0.125, 0.0625]


def constrain(rng, B=2, K=6):
    """The confliction loss's pooling: seg probabilities (B, 40, 40, 5) at
    stride 16, detection boxes of 10-40 px, output 28."""
    feats = [rng.uniform(0, 1, (B, 40, 40, 5)).astype(np.float32)]
    xy = rng.uniform(0, 600, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (B, K, 2))], -1).astype(np.float32)
    return feats, boxes, [28], [1.0 / 16]


def jax_grads(feats, rois, sizes, scales, gs, jdt):
    out = []
    for f, M, sc, g in zip(feats, sizes, scales, gs):
        _, vjp = jax.vjp(lambda x: roi_align_pallas(x, jnp.asarray(rois), M, sc, 2, False, 4, True),
                         jnp.asarray(f, jdt))
        out.append(np.asarray(vjp(jnp.asarray(g, jdt))[0]).astype(np.float32))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["pyramid2", "pyramid4", "ragged", "constrain"])
def test_roi_align_levels_gradients_match_jax_vjp(rng, dtype, case):
    if case.startswith("pyramid"):
        feats, rois, sizes, scales = pyramid(rng, int(case[-1]))
    else:
        feats, rois, sizes, scales = {"ragged": ragged, "constrain": constrain}[case](rng)
    B, K = rois.shape[:2]
    gs = [rng.standard_normal((B, K, M, M, f.shape[-1])).astype(np.float32)
          for f, M in zip(feats, sizes)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_grads(feats, rois, sizes, scales, gs, jdt)

    tf = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
    tg = [torch.from_numpy(g).to(dtype) for g in gs]
    n0 = kernels.LAUNCHES["roi_align_single_bwd"]
    outs = roi_align_levels(tf, torch.from_numpy(rois), sizes, scales, 2)
    got = torch.autograd.grad(outs, tf, tg)
    assert kernels.LAUNCHES["roi_align_single_bwd"] == n0       # CPU maps: the plain version
    direct = pallas_roi_align.roi_align_levels_bwd(tg, tf, torch.from_numpy(rois), sizes, scales, 2)
    for g, d, w, f in zip(got, direct, want, feats):
        assert g.shape == f.shape and g.dtype == dtype
        assert torch.equal(g, d)
        scale = np.abs(w).max()
        assert scale > 0.1
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("single", [False, True])
def test_roi_align_levels_gives_the_boxes_no_gradient(rng, single):
    """Autograd reaches the maps only: the boxes (which require grad here)
    get none, and a call whose maps need no gradient detaches the boxes, so
    its output stays out of the graph on either device."""
    feats, rois, sizes, scales = ragged(rng)
    f = torch.from_numpy(feats[0]).requires_grad_()
    b = torch.from_numpy(rois).requires_grad_()
    if single:
        out = roi_align_single(f, b, sizes[0], scales[0], 2)
    else:
        out = roi_align_levels([f], b, sizes[:1], scales[:1], 2)[0]
    gf, gb = torch.autograd.grad((out ** 2).sum(), [f, b], allow_unused=True)
    assert gb is None and gf is not None and float(gf.abs().max()) > 0
    out = roi_align_single(f.detach(), b, sizes[0], scales[0], 2)
    assert not out.requires_grad


def test_roi_align_levels_bwd_raises_off_the_cpu_on_bad_shapes():
    feats = [torch.empty((2, 8, 8, 16), device="meta"), torch.empty((3, 4, 4, 16), device="meta")]
    with pytest.raises(ValueError):
        pallas_roi_align._bwd_plan(feats, torch.empty((2, 1, 4), device="meta"), [8, 4], 2)


@pytest.mark.parametrize("shapes,K,sizes,C,dtype,per_roi", [
    (((160, 160), (80, 80), (40, 40), (20, 20)), 1, (160, 80, 40, 20), 256, torch.bfloat16,
     False),                                                        # hnet's pyramid
    (((40, 40),), 100, (28,), 5, torch.float32, True),              # the confliction loss
    (((40, 37),), 20, (14,), 8, torch.bfloat16, True),
    (((19, 23), (10, 12)), 5, (7, 5), 8, torch.float32, False),     # ragged
    (((33, 17),), 3, (33,), 12, torch.float32, False),
    (((40, 40),), 100, (28,), 5000, torch.float32, False),          # too wide for the per-ROI path
])
def test_bwd_plan_covers_every_cell_once(shapes, K, sizes, C, dtype, per_roi):
    """``roi_align_single_bwd.cu``'s gather items from ``_bwd_plan``, on meta
    tensors: decoded as the kernel decodes its blocks, they cover every
    (image, row, column, channel) of every map exactly once and keep the
    kernel's limits (at most 256 threads a block, a thread per (column,
    channel vector), a slab's vectors within a column's lanes); the per-ROI
    path is taken exactly where its buffers fit."""
    B = 2
    feats = [torch.empty((B, h, w, C), dtype=dtype, device="meta") for h, w in shapes]
    use_vec, roi_path, rows = pallas_roi_align._bwd_plan(
        feats, torch.empty((B, K, 4), device="meta"), sizes, 2)
    assert roi_path == per_roi
    v = 16 // feats[0].element_size() if use_vec else 1
    k = kernels.constants("roi_align_single_bwd")
    band = k["BH"]
    for (h, w), (H, W, CC, M, nband, ncb, cb, nslab, cs, lpc_log2) in zip(shapes, rows):
        assert (H, W, CC) == (h, w, C) and cs % v == 0 and C % v == 0
        assert cs // v <= 1 << lpc_log2 and cb * (1 << lpc_log2) <= 256
        assert cb <= k["MAX_CB"]
        seen = np.zeros((B, h, w, C), np.int32)
        for item in range(B * nband * ncb * nslab):     # the kernel's decode
            slab, u = item % nslab, item // nslab
            blk, u = u % ncb, u // ncb
            bnd, b = u % nband, u // nband
            h0, x0, c0 = bnd * band, blk * cb, slab * cs
            ncv = (min(C, c0 + cs) - c0) // v
            for t in range(256):
                cv, xi = t & ((1 << lpc_log2) - 1), t >> lpc_log2
                if xi < min(cb, w - x0) and cv < ncv:
                    c = c0 + cv * v
                    seen[b, h0:min(h, h0 + band), x0 + xi, c:c + v] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("name,keys", [
    ("roi_align_bwd", ("MAX_L", "MAX_S", "NWARPS", "TW")),
    ("roi_align_single_bwd", ("MAX_L", "MAX_S", "GATHER_SIDE", "BH", "MAX_CB", "NTHREADS",
                              "MAP_BYTES", "ROI_MAX_S", "ROW_CAP", "MAX_SIDE", "BIG_FLOATS",
                              "DENSE_FLOATS")),
])
def test_bwd_plans_read_the_kernel_limits_from_the_source(name, keys):
    """The two backward wrappers plan by their kernels' own ``constexpr``
    limits, read from the ``.cu`` source (``kernels.constants``): every one
    they read is there, each literal one has the source's value, and the
    derived ones (``2 * MAX_S``, ``NTHREADS / 32``) are evaluated."""
    k = kernels.constants(name)
    assert set(keys) <= set(k)
    with open(os.path.join(os.path.dirname(kernels.__file__), name + ".cu")) as f:
        src = f.read()
    literal = re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M)
    assert literal and all(k[key] == int(v) for key, v in literal)
    assert k["MAX_E"] == 2 * k["MAX_S"] and k["NTHREADS"] % 32 == 0
    if "NWARPS" in k:
        assert k["NWARPS"] == k["NTHREADS"] // 32
