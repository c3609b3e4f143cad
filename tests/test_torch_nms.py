"""PyTorch port, NMS: mirrors ``tests/test_nms.py`` case for case, against the
JAX ``nms_padded`` and the Pallas kernel in interpret mode
(``test_nms.py::test_pallas_nms_matches_xla``).  Indices and keep masks
must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.ops import batched_nms_padded as jax_batched_nms_padded
from hd_yolo_tpu.ops import nms_padded as jax_nms_padded
from hd_yolo_tpu.ops.nms import nms_per_image as jax_nms_per_image
from hd_yolo_tpu.ops.pallas_nms import nms_padded_pallas as jax_nms_padded_pallas
from hd_yolo_tpu_torch.ops.nms import batched_nms_padded, nms_padded, nms_per_image
from hd_yolo_tpu_torch.ops.pallas_nms import nms_keep_sorted, nms_padded_pallas


def np_nms(boxes, scores, iou_thr):
    """Sequential greedy NMS, stable desc sort by score (ties: lower index first)."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        for j in order:
            if suppressed[j] or j == i:
                continue
            xx1 = max(boxes[i, 0], boxes[j, 0])
            yy1 = max(boxes[i, 1], boxes[j, 1])
            xx2 = min(boxes[i, 2], boxes[j, 2])
            yy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
            ai = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            aj = (boxes[j, 2] - boxes[j, 0]) * (boxes[j, 3] - boxes[j, 1])
            if inter / (ai + aj - inter) > iou_thr:
                suppressed[j] = True
    return np.array(keep, np.int32)


def random_boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2))
    wh = rng.uniform(4, scale / 2, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def both(boxes, scores, valid, thr, max_det, **kw):
    """(port idx, port keep), (jax idx, jax keep) as numpy."""
    i, k = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(valid), thr, max_det, **kw)
    ji, jk = jax_nms_padded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr,
                            max_det, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    return i.numpy(), k.numpy()


def test_nms_matches_greedy(rng):
    for _ in range(5):
        n = 200
        boxes = random_boxes(rng, n, scale=80.0)
        scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
        idx, keep = both(boxes, scores, np.ones(n, bool), 0.45, 50)
        np.testing.assert_array_equal(idx[keep], np_nms(boxes, scores, 0.45)[:50])


def test_nms_respects_validity(rng):
    n = 64
    boxes = random_boxes(rng, n)
    scores = rng.uniform(0.1, 1.0, n).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[: n // 2] = True
    idx, keep = both(boxes, scores, valid, 0.5, 32)
    np.testing.assert_array_equal(idx[keep], np_nms(boxes[: n // 2], scores[: n // 2], 0.5)[:32])


def test_nms_all_invalid():
    _, keep = both(np.zeros((16, 4), np.float32), np.zeros(16, np.float32), np.zeros(16, bool),
                   0.5, 8)
    assert not keep.any()


def test_nms_max_det_truncation(rng):
    n = 100
    boxes = np.stack([np.arange(n) * 20.0, np.zeros(n), np.arange(n) * 20.0 + 10,
                      np.full(n, 10.0)], -1).astype(np.float32)
    scores = rng.permutation(n).astype(np.float32) / n
    idx, keep = both(boxes, scores, np.ones(n, bool), 0.5, 10)
    np.testing.assert_array_equal(idx[keep], np.argsort(-scores, kind="stable")[:10])


def test_nms_tile_boundaries(rng):
    """Many overlaps across what the JAX sweep cuts into 128-wide tiles."""
    n = 300
    boxes = random_boxes(rng, n, scale=60.0)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    idx, keep = both(boxes, scores, np.ones(n, bool), 0.3, 100)
    np.testing.assert_array_equal(idx[keep], np_nms(boxes, scores, 0.3)[:100])


def test_batched_nms_classes_dont_suppress(rng):
    boxes = np.tile(random_boxes(rng, 1), (2, 1))
    scores = np.array([0.9, 0.8], np.float32)
    labels = np.array([0, 1], np.int32)
    i, k = batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                              torch.from_numpy(labels), torch.ones(2, dtype=torch.bool), 0.5, 4)
    ji, jk = jax_batched_nms_padded(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                    jnp.ones(2, bool), 0.5, 4)
    assert int(k.sum()) == 2
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))


def _preds(rng, K=128, nc=4):
    preds = np.zeros((K, 5 + nc + 1), np.float32)
    preds[:, 0:2] = rng.uniform(100, 500, (K, 2))
    preds[:, 2:4] = rng.uniform(8, 60, (K, 2))
    preds[:, 4] = rng.uniform(0, 1, K)
    preds[:, 5: 5 + nc] = rng.uniform(0, 1, (K, nc))
    preds[:, -1] = rng.integers(0, 4, K)
    return preds


def test_nms_per_image_shapes_and_filtering(rng):
    nc = 4
    preds = _preds(rng, 128, nc)
    out = nms_per_image(torch.from_numpy(preds), nc=nc, conf_thres=0.3, iou_thres=0.45, max_det=32)
    assert tuple(out["boxes"].shape) == (32, 4)
    assert tuple(out["scores"].shape) == (32, 1 + nc)
    assert tuple(out["extra"].shape) == (32, 1)
    v = out["valid"].numpy()
    assert np.all(out["scores"].numpy()[v, 0] > 0.3)
    batch = torch.from_numpy(np.stack([preds] * 3))
    outs = nms_per_image(batch, nc=nc, conf_thres=0.3, iou_thres=0.45, max_det=32)
    assert tuple(outs["boxes"].shape) == (3, 32, 4)
    for k in out:
        np.testing.assert_array_equal(outs[k][1].numpy(), out[k].numpy())


def test_nms_per_image_matches_jax_on_decoded_rows(rng):
    """Batched, with the pre-NMS top-K (stable order, ties to the lower index)."""
    nc, B, K = 4, 3, 600
    preds = np.stack([_preds(rng, K, nc) for _ in range(B)])
    preds[:, 50:90, 4] = 0.75                       # tied objectness across the top-K cut
    kw = dict(nc=nc, conf_thres=0.15, iou_thres=0.45, max_det=100, pre_nms_topk=256)
    got = nms_per_image(torch.from_numpy(preds), **kw)
    want = jax.vmap(lambda p: jax_nms_per_image(p, **kw))(jnp.asarray(preds))
    for k in ("boxes", "scores", "extra", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() > 0


def test_pallas_nms_matches_plain_and_jax(rng):
    """The kernel's contract (plain version on the CPU) against the JAX
    ``nms_padded`` and ``nms_padded_pallas(interpret=True)``, exactly.
    Copies ``tests/test_nms.py::test_pallas_nms_matches_xla``."""
    for K, thr in ((128, 0.45), (384, 0.3), (1024, 0.6)):
        b = np.concatenate([rng.uniform(0, 600, (K, 2)), rng.uniform(4, 64, (K, 2))],
                           -1).astype(np.float32)
        b[:, 2:] += b[:, :2]
        s = rng.uniform(0, 1, K).astype(np.float32)
        v = rng.uniform(0, 1, K) > 0.1
        i1, k1 = nms_padded_pallas(torch.from_numpy(b), torch.from_numpy(s),
                                   torch.from_numpy(v), thr, 300)
        i2, k2 = jax_nms_padded_pallas(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thr, 300,
                                       interpret=True)
        np.testing.assert_array_equal(i1.numpy(), np.asarray(i2))
        np.testing.assert_array_equal(k1.numpy(), np.asarray(k2))

    K = 200                                         # duplicates, all invalid, K % 128 != 0
    b = np.tile(np.asarray([[10, 10, 50, 50]], np.float32), (K, 1))
    s = np.linspace(1, 0, K).astype(np.float32)
    i1, k1 = nms_padded_pallas(torch.from_numpy(b), torch.from_numpy(s),
                               torch.ones(K, dtype=torch.bool), 0.45, 16)
    _, k2 = jax_nms_padded_pallas(jnp.asarray(b), jnp.asarray(s), jnp.ones(K, bool), 0.45, 16,
                                  interpret=True)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(k2))
    assert int(k1.sum()) == 1
    _, k3 = nms_padded_pallas(torch.from_numpy(b), torch.from_numpy(s),
                              torch.zeros(K, dtype=torch.bool), 0.45, 16)
    assert int(k3.sum()) == 0


def test_iou_exactly_at_threshold_is_kept():
    """Strict ``IoU > thr``: a pair at IoU == 0.45 in float32 both survive."""
    b = np.asarray([[0, 0, 10, 10], [0, 0, 10, 4.5], [0, 0, 10, 4.6]], np.float32)
    s = np.asarray([0.9, 0.8, 0.7], np.float32)
    idx, keep = both(b, s, np.ones(3, bool), 0.45, 3)
    np.testing.assert_array_equal(idx[keep], [0, 1])


def test_presorted_fast_path_identical(rng):
    """Copies ``tests/test_nms.py::test_presorted_fast_path_identical``; the
    kernel's sorted-input entry (``nms_keep_sorted``) gives the same slots."""
    K = 300
    b = np.concatenate([rng.uniform(0, 600, (K, 2)), rng.uniform(4, 64, (K, 2))],
                       -1).astype(np.float32)
    b[:, 2:] += b[:, :2]
    s = rng.uniform(0, 1, K).astype(np.float32)
    v = rng.uniform(0, 1, K) > 0.2
    order = np.argsort(-np.where(v, s, -np.inf), kind="stable")
    bs, ss, vs = b[order], s[order], v[order]
    i0, k0 = both(bs, ss, vs, 0.45, 100)
    i1, k1 = both(bs, ss, vs, 0.45, 100, presorted=True)
    pos, keep = nms_keep_sorted(torch.from_numpy(bs)[None], torch.from_numpy(vs)[None], 0.45, 100)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(k0, k1)
    np.testing.assert_array_equal(pos[0].numpy(), i0)
    np.testing.assert_array_equal(keep[0].numpy(), k0)


# ------------------------------------------- the kernel's word-at-a-time sweep
def word_sweep(iou, svalid, thr):
    """Numpy model of ``kernels/nms.cu`` on the (K, K) IoU matrix: the
    conflict bits packed into 64-bit words of the upper triangle only
    (column word >= row word), plus, from the diagonal blocks, each box's
    conflicters inside its own word (read from the lower half, as the kernel
    tests iou(row, column) there: IoU is symmetric).  Then one step per
    word: the greedy keep inside word w resolved in parallel rounds from
    ~removed[w] and the conflicters, and the kept rows' words ORed into
    removed[u] for every later word u.  Returns the keep mask (K,)."""
    K = iou.shape[0]
    nw = (K + 63) // 64
    ok = np.zeros(nw * 64, bool)
    ok[:K] = svalid
    hit = np.zeros((nw * 64, nw * 64), bool)
    hit[:K, :K] = iou > thr
    hit &= ok[:, None] & ok[None, :]
    np.fill_diagonal(hit, False)
    bitv = np.uint64(1) << np.arange(64, dtype=np.uint64)
    pack = lambda bits: np.bitwise_or.reduce(np.where(bits, bitv, np.uint64(0)))
    words, by = {}, {}                                # (column word, row) -> u64
    for rb in range(nw):
        for cb in range(rb, nw):                      # the lower triangle is never built
            for r in range(rb * 64, rb * 64 + 64):
                blk = hit[r, cb * 64:(cb + 1) * 64].copy()
                if cb == rb:
                    by[r] = pack(blk & (np.arange(64) < r - rb * 64))
                    blk &= np.arange(64) > r - rb * 64
                words[cb, r] = pack(blk)
    removed = [pack(~ok[w * 64:(w + 1) * 64]) for w in range(nw)]
    keepw = []
    for w in range(nw):
        rows = range(w * 64, w * 64 + 64)
        und, kept = ~removed[w], np.uint64(0)
        while und:
            live = [bool((int(und) >> (r - w * 64)) & 1) for r in rows]
            fresh = pack(np.array([lv and not (by[r] & (kept | und)) for lv, r in zip(live, rows)]))
            gone = pack(np.array([lv and bool(by[r] & fresh) for lv, r in zip(live, rows)]))
            kept |= fresh
            und &= ~(fresh | gone)
        keepw.append(kept)
        for u in range(w + 1, nw):
            for r in rows:
                if (int(kept) >> (r - w * 64)) & 1:
                    removed[u] |= words[u, r]
    keep = np.array([(int(keepw[i // 64]) >> (i % 64)) & 1 for i in range(nw * 64)], bool)
    return keep[:K]


def popcount_compact(keep, max_det):
    """The kernel's compaction: rank of a kept bit = kept bits before it."""
    idx = np.zeros(max_det, np.int32)
    rank = np.cumsum(keep) - 1
    for i in np.flatnonzero(keep):
        if rank[i] < max_det:
            idx[rank[i]] = i
    return idx, np.arange(max_det) < min(int(keep.sum()), max_det)


def _sweep_case(rng, case):
    thr = 0.45
    if case == "all_invalid":
        K = 70
        b = random_boxes(rng, K)
        return b, np.zeros(K, bool), thr, 20
    if case == "ties_and_exact_pairs":
        K = 130                                       # not a multiple of 64
        b = random_boxes(rng, K, scale=60.0)
        for i in range(0, 40, 2):                     # pairs at IoU exactly 0.45 (f32)
            x, y = 100.0 + 20 * i, 100.0
            b[i] = [x, y, x + 10, y + 10]
            b[i + 1] = [x, y, x + 10, y + 4.5]
        b[60:70] = b[60]                              # identical boxes
        return b, rng.uniform(0, 1, K) > 0.1, thr, 50
    K = {"one": 1, "k63": 63, "k64": 64, "k65": 65, "k300": 300}[case]
    centers = rng.uniform(0, 200, (max(K // 6, 1), 2))
    c = centers[rng.integers(0, len(centers), K)] + rng.normal(0, 4, (K, 2))
    wh = rng.uniform(6, 30, (K, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return b, rng.uniform(0, 1, K) > 0.15, thr, 300 if case == "k300" else 8


@pytest.mark.parametrize("case", ["one", "k63", "k64", "k65", "k300", "all_invalid",
                                  "ties_and_exact_pairs"])
def test_word_sweep_model_equals_greedy_keep(rng, case):
    """The kernel's algorithm, modelled in numpy on the plain version's own
    IoU matrix, keeps exactly ``greedy_keep``'s boxes, and its popcount
    compaction gives ``compact``'s slots (``max_det`` below the kept count
    in most cases)."""
    from hd_yolo_tpu_torch.ops.boxes import box_iou
    from hd_yolo_tpu_torch.ops.nms import compact, greedy_keep

    b, v, thr, max_det = _sweep_case(rng, case)
    K = len(b)
    tb, tv = torch.from_numpy(b), torch.from_numpy(v)
    iou = box_iou(tb, tb).numpy()
    np.testing.assert_array_equal(iou, iou.T)         # symmetric bit for bit
    got = word_sweep(iou, v, thr)
    want = greedy_keep(tb, tv, thr).numpy()
    np.testing.assert_array_equal(got, want)
    idx, keep = popcount_compact(got, max_det)
    ci, ck = compact(torch.from_numpy(want), None, max_det)
    np.testing.assert_array_equal(idx, ci.numpy())
    np.testing.assert_array_equal(keep, ck.numpy())
    if case in ("k65", "k300", "ties_and_exact_pairs"):
        assert 0 < int(ck.sum()) and (int(want.sum()) > max_det or case == "k300")
    if case == "ties_and_exact_pairs":
        assert got[0] and got[1]                      # IoU == thr is not a conflict


def test_nms_keep_sorted_dtypes_on_the_cpu(rng):
    """The CPU path's contract, as the kernel's: int32 positions, bool keep,
    each (B, max_det)."""
    b = np.stack([random_boxes(rng, 90) for _ in range(3)])
    v = rng.uniform(0, 1, (3, 90)) > 0.2
    pos, keep = nms_keep_sorted(torch.from_numpy(b), torch.from_numpy(v), 0.45, 40)
    assert pos.dtype == torch.int32 and keep.dtype == torch.bool
    assert tuple(pos.shape) == tuple(keep.shape) == (3, 40)
    assert bool((pos[~keep] == 0).all())


@pytest.mark.parametrize("case", ["f64_boxes", "box_shape", "u8_valid", "valid_shape",
                                  "not_cuda"])
def test_nms_keep_sorted_raises_on_what_the_kernel_does_not_take(case):
    """Off the CPU (meta tensors here: no data, only the checks run) the
    wrapper takes f32 (B, K, 4) boxes and a (B, K) bool mask on one card."""
    d = "meta"
    boxes = torch.empty((2, 70, 4), device=d)
    valid = torch.empty((2, 70), dtype=torch.bool, device=d)
    if case == "f64_boxes":
        boxes = boxes.double()
    elif case == "box_shape":
        boxes = torch.empty((2, 70, 5), device=d)
    elif case == "u8_valid":
        valid = torch.empty((2, 70), dtype=torch.uint8, device=d)
    elif case == "valid_shape":
        valid = torch.empty((2, 71), dtype=torch.bool, device=d)
    with pytest.raises(ValueError):
        nms_keep_sorted(boxes, valid, 0.45, 10)
