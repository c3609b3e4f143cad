"""The training augmentation recipe on the device (port of
``hd_yolo_tpu/data/device_augment.py``).

The host recipe (``data/augment.py`` on loader threads) feeds the card at
a fraction of the rate its train step takes.  Here the per-step recipe runs
on the batch's device, in the train step, on raw-mode batches (the resized
tile and its padded targets, ``DetectionDataset(host_augment=False)``):

  per tile    scale/translate warp (constant border 114) → flips/transpose
              → (blur, gray) → HSV jitter
  per batch   2 x 2 batch-internal mosaic → random crop → (mixup) →
              candidate filter, small-object rule, slot compaction

The recipe is split in two.  ``draw_augment(rng, B, S, hyp, k_mosaic)``
draws every random number of a step on the host from a numpy generator:
O(B) numbers, uploaded once a step (``upload_draws``).
``apply_augment(batch, draws)`` is a deterministic function of tensors on
the batch's device.  JAX draws with ``jax.random`` inside its graph; the
split lets the tests feed JAX's own draws to the port.

Each output pixel of the warp has at most two bilinear taps per axis, so
the port gathers those two taps (O(B·S²·C)) where JAX multiplies by dense
(B, S, S) resampling matrices; the box-relative 28 x 28 masks are resampled
the same way.  Everything runs in f32.

Only the separable recipe exists on the device: nonzero ``degrees``,
``shear`` or ``perspective`` raise ``ValueError`` (the host pipeline serves
them), as does a ``k_mosaic`` other than 1 or 2.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .preproc import hsv_jitter

Tensor = torch.Tensor

_BORDER = 114.0 / 255.0
# the draws with a leading (quadrant,) axis: one tile chain per quadrant
QUAD_KEYS = ("scale", "tx", "ty", "fliplr", "flipud", "transpose", "hsv", "blur", "gray")


def _const(values, like: Tensor) -> Tensor:
    """A small f32 constant on ``like``'s device, copied from pinned memory
    on the card so that the host does not wait for the stream."""
    t = torch.tensor(values, dtype=torch.float32)
    return t.pin_memory().to(like.device, non_blocking=True) if like.is_cuda else t


# ------------------------------------------------------------------- warps
def _taps(src: Tensor, n: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The two bilinear taps of each sample position ``src`` on a grid of
    ``n``: indices (clamped into the grid) and weights (0 for a tap outside
    it) — the nonzero entries of JAX's ``max(0, 1 − |src − i|)`` rows."""
    f = torch.floor(src)
    w1 = src - f
    w0 = 1.0 - w1
    i0 = f.long()
    i1 = i0 + 1
    w0 = torch.where((i0 >= 0) & (i0 < n), w0, 0.0)
    w1 = torch.where((i1 >= 0) & (i1 < n), w1, 0.0)
    return i0.clamp(0, n - 1), i1.clamp(0, n - 1), w0, w1


def _affine1d_taps(S: int, scale: Tensor, shift: Tensor):
    """The taps of dst = s·(src − S/2) + t per image: output row o samples
    src = (o − t)/s + S/2.  The in-bounds weight of a row is ``w0 + w1``;
    the constant border adds ``(1 − w0 − w1)·border``."""
    o = torch.arange(S, dtype=torch.float32, device=scale.device)
    src = (o[None, :] - shift[:, None]) / scale[:, None] + S / 2.0      # (B, S)
    return _taps(src, S)


def _resample_rows(x: Tensor, i0: Tensor, i1: Tensor, w0: Tensor, w1: Tensor) -> Tensor:
    """out[b, o] = w0[b, o]·x[b, i0[b, o]] + w1[b, o]·x[b, i1[b, o]] along
    dim 1 of a (B, N, ...) tensor."""
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    shape = w0.shape + (1,) * (x.dim() - 2)
    return w0.view(shape) * x[bi, i0] + w1.view(shape) * x[bi, i1]


def _warp_images(img: Tensor, scale: Tensor, tx: Tensor, ty: Tensor) -> Tensor:
    """(B, S, S, C) float in [0, 1] → warped, border 114/255: rows, then
    columns."""
    S = img.shape[1]
    y0, y1, wy0, wy1 = _affine1d_taps(S, scale, ty)
    tmp = _resample_rows(img, y0, y1, wy0, wy1)
    tmp = tmp + (1.0 - (wy0 + wy1))[:, :, None, None] * _BORDER
    x0, x1, wx0, wx1 = _affine1d_taps(S, scale, tx)
    out = _resample_rows(tmp.transpose(1, 2), x0, x1, wx0, wx1).transpose(1, 2)
    return out + (1.0 - (wx0 + wx1))[:, None, :, None] * _BORDER


def _window_resample(masks: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Re-sample box-relative masks (..., M, M) over a fractional sub-window
    ``lo``/``hi`` (..., 2) = (y, x) in [0, 1] box coordinates: out[j]
    samples src = (lo + (j + 0.5)/M·(hi − lo))·M − 0.5; taps outside the box
    contribute 0.  An identity window returns the mask."""
    M = masks.shape[-1]
    j = (torch.arange(M, dtype=torch.float32, device=masks.device) + 0.5) / M

    def taps(l, h):                                   # (...,) → 4 x (..., M)
        return _taps((l[..., None] + j * (h - l)[..., None]) * M - 0.5, M)

    y0, y1, wy0, wy1 = taps(lo[..., 0], hi[..., 0])
    x0, x1, wx0, wx1 = taps(lo[..., 1], hi[..., 1])
    full = masks.shape
    rows = lambda i: masks.gather(-2, i[..., :, None].expand(full))      # noqa: E731
    out = wy0[..., :, None] * rows(y0) + wy1[..., :, None] * rows(y1)
    cols = lambda i: out.gather(-1, i[..., None, :].expand(full))        # noqa: E731
    return wx0[..., None, :] * cols(x0) + wx1[..., None, :] * cols(x1)


def _clip_boxes_recrop_masks(boxes: Tensor, masks: Tensor, S: float):
    """Clip px boxes to [0, S] and re-sample masks to the visible window."""
    c = boxes.clamp(0.0, S)
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
    lo = torch.stack([(c[..., 1] - boxes[..., 1]) / h, (c[..., 0] - boxes[..., 0]) / w], -1)
    hi = torch.stack([(c[..., 3] - boxes[..., 1]) / h, (c[..., 2] - boxes[..., 0]) / w], -1)
    ident = ((lo[..., 0] <= 1e-6) & (lo[..., 1] <= 1e-6)
             & (hi[..., 0] >= 1.0 - 1e-6) & (hi[..., 1] >= 1.0 - 1e-6))
    return c, torch.where(ident[..., None, None], masks, _window_resample(masks, lo, hi))


def _box_candidates(b1: Tensor, b2: Tensor, wh_thr=2.0, ar_thr=20.0, area_thr=0.1,
                    eps=1e-16) -> Tensor:
    """``augment.box_candidates`` on tensors: b1 before, b2 after."""
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _box_blur3(img: Tensor) -> Tensor:
    """cv2.blur(img, (3, 3)) with edge replication, separable."""
    p = torch.cat([img[:, :1], img, img[:, -1:]], 1)
    v = (p[:, :-2] + p[:, 1:-1] + p[:, 2:]) / 3.0
    p = torch.cat([v[:, :, :1], v, v[:, :, -1:]], 2)
    return (p[:, :, :-2] + p[:, :, 1:-1] + p[:, :, 2:]) / 3.0


# ------------------------------------------------------------ per-tile chain
def _augment_tiles(img: Tensor, tgts: Dict[str, Dict[str, Tensor]], d: Dict[str, Tensor]):
    """One tile chain for a (B, S, S, C) float batch and px targets: the
    image's transform (``d``: this quadrant's (B,) draws) applied to the
    image and to every task's annotations."""
    S = img.shape[1]
    s, tx, ty = d["scale"], d["tx"], d["ty"]
    img = _warp_images(img, s, tx, ty)
    do_lr, do_ud, do_tp = d["fliplr"], d["flipud"], d["transpose"]
    img = torch.where(do_lr[:, None, None, None], img.flip(2), img)
    img = torch.where(do_ud[:, None, None, None], img.flip(1), img)
    img = torch.where(do_tp[:, None, None, None], img.transpose(1, 2), img)

    out = {}
    for task, tg in tgts.items():
        b0 = tg["boxes"]                                 # (B, T, 4) px, before the warp
        sv = s[:, None]
        c = torch.stack([sv * (b0[..., 0] - S / 2) + tx[:, None],
                         sv * (b0[..., 1] - S / 2) + ty[:, None],
                         sv * (b0[..., 2] - S / 2) + tx[:, None],
                         sv * (b0[..., 3] - S / 2) + ty[:, None]], -1)
        clipped, masks = _clip_boxes_recrop_masks(c, tg["masks"], float(S))
        keep = _box_candidates(b0, clipped)
        lr, ud, tp = do_lr[:, None], do_ud[:, None], do_tp[:, None]
        x1, y1, x2, y2 = clipped.unbind(-1)
        x1, x2 = torch.where(lr, S - x2, x1), torch.where(lr, S - x1, x2)
        y1, y2 = torch.where(ud, S - y2, y1), torch.where(ud, S - y1, y2)
        masks = torch.where(lr[..., None, None], masks.flip(-1), masks)
        masks = torch.where(ud[..., None, None], masks.flip(-2), masks)
        bx = torch.stack([torch.where(tp, y1, x1), torch.where(tp, x1, y1),
                          torch.where(tp, y2, x2), torch.where(tp, x2, y2)], -1)
        masks = torch.where(tp[..., None, None], masks.transpose(-1, -2), masks)
        out[task] = {"boxes": bx, "labels": tg["labels"], "masks": masks,
                     "valid": tg["valid"] & keep, "active": tg["active"]}

    if "blur" in d:                                      # photometric extras, p each
        img = torch.where(d["blur"][:, None, None, None], _box_blur3(img), img)
        gray = (img * _const([0.299, 0.587, 0.114], img)).sum(-1, keepdim=True)
        img = torch.where(d["gray"][:, None, None, None], gray.expand(img.shape), img)
    hsv = d["hsv"]
    return hsv_jitter(img, hsv[:, 0], hsv[:, 1], hsv[:, 2]), out


# ----------------------------------------------------------------- top level
def _compact(tg: Dict[str, Tensor], T: int, S: float) -> Dict[str, Tensor]:
    """Reduce overfull target slots to T, largest first among the valid (a
    stable sort: the many ties keep their order); zero the padded slots."""
    b = tg["boxes"]
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) / (S * S)
    score = tg["valid"].float() * (1.0 + area.clamp(0.0, 1.0))
    order = torch.argsort(-score, dim=-1, stable=True)[..., :T]             # (B, T)
    take = lambda a: torch.take_along_dim(                                  # noqa: E731
        a, order.view(order.shape + (1,) * (a.dim() - 2)), dim=1)
    valid = take(tg["valid"])
    return {"boxes": torch.where(valid[..., None], take(b), 0.0),
            "labels": torch.where(valid, take(tg["labels"]), 0),
            "masks": torch.where(valid[..., None, None], take(tg["masks"]), 0.0),
            "valid": valid, "active": tg["active"]}


def _concat_tasks(parts) -> Dict[str, Tensor]:
    cat = {k: torch.cat([p[k] for p in parts], 1) for k in ("boxes", "labels", "masks", "valid")}
    active = parts[0]["active"]
    for p in parts[1:]:
        active = active | p["active"]
    cat["active"] = active
    return cat


def _check(hyp: Dict, k_mosaic: int) -> None:
    for k in ("degrees", "shear", "perspective"):
        if float(hyp.get(k, 0.0)) != 0.0:
            raise ValueError(f"device augmentation supports the separable recipe only; "
                             f"hyp[{k!r}]={hyp[k]} needs the host pipeline")
    if k_mosaic not in (1, 2):
        raise ValueError(f"k_mosaic={k_mosaic} not supported on device (1 or 2)")


def draw_augment(rng: np.random.Generator, B: int, S: int, hyp: Dict,
                 k_mosaic: int = 2) -> Dict[str, np.ndarray]:
    """Every random number of one step of the recipe, drawn on the host.

    Per quadrant q (1 with ``k_mosaic`` 1, else 4) and image: ``scale`` in
    1 ± hyp scale, the shifts ``tx``/``ty`` in (0.5 ± translate)·S, the
    flip bits ``fliplr``/``flipud``/``transpose``, the HSV gains ``hsv``
    (B, 3) = (hue shift, saturation and value factors) and, where
    ``photometric`` > 0, the ``blur`` and ``gray`` bits.  With ``k_mosaic``
    2: the quadrants' ``partners`` (3, B) permutations and the ``crop``
    (B, 2) (y, x) offsets in [0, S].  Where ``mixup`` > 0: its permutation
    ``mix_perm``, the Beta(32, 32) ``mix_lam`` and the bit ``mix_do``."""
    _check(hyp, k_mosaic)
    Q = 1 if k_mosaic == 1 else 4
    f32 = lambda a: np.asarray(a, np.float32)            # noqa: E731
    sc, tr = float(hyp.get("scale", 0.5)), float(hyp.get("translate", 0.1))
    hh, hs, hv = (float(hyp.get(k, g)) for k, g in (("hsv_h", 0.015), ("hsv_s", 0.7),
                                                     ("hsv_v", 0.4)))
    d = {"scale": f32(rng.uniform(1.0 - sc, 1.0 + sc, (Q, B))),
         "tx": f32(rng.uniform((0.5 - tr) * S, (0.5 + tr) * S, (Q, B))),
         "ty": f32(rng.uniform((0.5 - tr) * S, (0.5 + tr) * S, (Q, B))),
         "fliplr": rng.random((Q, B)) < float(hyp.get("fliplr", 0.5)),
         "flipud": rng.random((Q, B)) < float(hyp.get("flipud", 0.5)),
         "transpose": rng.random((Q, B)) < float(hyp.get("transpose", 0.0)),
         "hsv": f32(np.stack([rng.uniform(-hh, hh, (Q, B)), 1.0 + rng.uniform(-hs, hs, (Q, B)),
                              1.0 + rng.uniform(-hv, hv, (Q, B))], -1))}
    p_ph = float(hyp.get("photometric", 0.0))
    if p_ph > 0:
        d["blur"] = rng.random((Q, B)) < p_ph
        d["gray"] = rng.random((Q, B)) < p_ph
    if k_mosaic == 2:
        d["partners"] = np.stack([rng.permutation(B) for _ in range(3)])
        d["crop"] = rng.integers(0, S + 1, (B, 2))
    p_mix = float(hyp.get("mixup", 0.0))
    if p_mix > 0:
        d["mix_perm"] = rng.permutation(B)
        d["mix_lam"] = f32(rng.beta(32.0, 32.0, B))
        d["mix_do"] = rng.random(B) < p_mix
    return d


def upload_draws(draws: Dict[str, np.ndarray], device) -> Dict[str, Tensor]:
    """The host draws as tensors on ``device``: one copy a dtype (from
    pinned memory on the card)."""
    device = torch.device(device)
    groups: Dict[np.dtype, list] = {}
    for k, v in draws.items():
        groups.setdefault(np.asarray(v).dtype, []).append(k)
    out = {}
    for keys in groups.values():
        buf = torch.from_numpy(np.concatenate([np.asarray(draws[k]).ravel() for k in keys]))
        if device.type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        off = 0
        for k in keys:
            shape = np.shape(draws[k])
            n = int(np.prod(shape))
            out[k] = buf[off: off + n].view(shape)
            off += n
    return out


def gather_rows(tree: Dict, idx: Tensor) -> Dict:
    """The rows ``idx`` of every leaf of a batch tree (leading axis)."""
    return {k: gather_rows(v, idx) if isinstance(v, dict) else v.index_select(0, idx)
            for k, v in tree.items()}


def _mosaics(img: Tensor, tgts0: Dict, draws: Dict[str, Tensor], rows: Optional[Tensor]):
    """The per-tile chains, the 2 x 2 mosaic and its crop of the batch's rows
    ``rows`` (all rows where None): each row's draws are its own, its
    partners any rows of the batch.  Returns (images, px targets)."""
    take = (lambda a: a) if rows is None else (lambda a: a.index_select(0, rows))  # noqa: E731
    quad = lambda q: {k: take(draws[k][q]) for k in QUAD_KEYS if k in draws}    # noqa: E731
    own_img = take(img)
    own_t = tgts0 if rows is None else gather_rows(tgts0, rows)
    if "partners" not in draws:                          # k_mosaic 1
        return _augment_tiles(own_img, own_t, quad(0))
    # 2 x 2 batch-internal mosaic: quadrant 0 is the batch itself, the
    # partners of quadrants 1-3 are permutations of it
    S = img.shape[1]
    quads_img, quads_tgt = [], []
    for q in range(4):
        if q == 0:
            gi, gt = own_img, own_t
        else:
            perm = take(draws["partners"][q - 1])
            gi, gt = img.index_select(0, perm), gather_rows(tgts0, perm)
        wi, wt = _augment_tiles(gi, gt, quad(q))
        off = _const([(q % 2) * S, (q // 2) * S] * 2, wi)
        quads_img.append(wi)
        quads_tgt.append({t: {**tg, "boxes": tg["boxes"] + off} for t, tg in wt.items()})
    canvas = torch.cat([torch.cat(quads_img[0:2], 2), torch.cat(quads_img[2:4], 2)], 1)
    merged = {t: _concat_tasks([qt[t] for qt in quads_tgt]) for t in tgts0}

    # a random S-crop of each image's canvas, as one gather
    yx0 = take(draws["crop"])
    ar = torch.arange(S, device=img.device)
    rws, cols = yx0[:, 0, None] + ar, yx0[:, 1, None] + ar
    bi = torch.arange(yx0.shape[0], device=img.device)[:, None, None]
    out_img = canvas[bi, rws[:, :, None], cols[:, None, :]]
    off = torch.stack([yx0[:, 1], yx0[:, 0], yx0[:, 1], yx0[:, 0]], -1).float()[:, None, :]
    for t, tg in merged.items():
        moved = tg["boxes"] - off
        clipped, masks = _clip_boxes_recrop_masks(moved, tg["masks"], float(S))
        w = clipped[..., 2] - clipped[..., 0]
        h = clipped[..., 3] - clipped[..., 1]
        a0 = ((moved[..., 2] - moved[..., 0]) * (moved[..., 3] - moved[..., 1])).clamp_min(1e-9)
        vis = (w * h / a0 > 0.1) & (w > 2) & (h > 2)
        merged[t] = {**tg, "boxes": clipped, "masks": masks, "valid": tg["valid"] & vis}
    return out_img, merged


def apply_augment(batch: Dict, draws: Dict[str, Tensor], rows: Optional[Tensor] = None) -> Dict:
    """The recipe on a raw-mode batch, on its device: ``batch`` = {'image':
    (B, S, S, 3) uint8 or float, 'targets': {task: {boxes (normalized
    xyxy), labels, masks (B, T, 28, 28), valid, active}}}; ``draws`` from
    ``draw_augment`` on the same device.  Returns the float32 image in
    [0, 1] and the compacted, normalized targets, T slots a task.

    ``rows`` (an int64 index on the device): only those rows of the
    batch's result, computed alone: their own chains and mosaics and those
    of their mixup partners (one process of several, which gathered the
    global batch and drew for it, computes its own rows)."""
    img = batch["image"]
    if not img.is_floating_point():
        img = img.float() / 255.0
    S = img.shape[1]
    tgts0 = {t: {**tg, "boxes": tg["boxes"] * S} for t, tg in batch["targets"].items()}
    T = next(iter(tgts0.values()))["boxes"].shape[1]
    out_img, merged = _mosaics(img, tgts0, draws, rows)

    if "mix_perm" in draws:                              # mixup: a Beta(32, 32) blend
        perm, do, lam = draws["mix_perm"], draws["mix_do"], draws["mix_lam"]
        if rows is None:
            mix_img = out_img.index_select(0, perm)
            mix_t = {t: gather_rows(tg, perm) for t, tg in merged.items()}
        else:
            perm, do, lam = perm.index_select(0, rows), do[rows], lam[rows]
            mix_img, mix_t = _mosaics(img, tgts0, draws, perm)
        lam = torch.where(do, lam, 1.0)[:, None, None, None]
        out_img = lam * out_img + (1 - lam) * mix_img
        for t, tg in merged.items():
            other = dict(mix_t[t])
            other["valid"] = other["valid"] & do[:, None]
            other["active"] = tg["active"]
            merged[t] = _concat_tasks([tg, other])

    out_t = {}
    for t, tg in merged.items():                         # the final small-object rule
        w = tg["boxes"][..., 2] - tg["boxes"][..., 0]
        h = tg["boxes"][..., 3] - tg["boxes"][..., 1]
        tg = _compact({**tg, "valid": tg["valid"] & (w > 10) & (h > 10)}, T, float(S))
        out_t[t] = {**tg, "boxes": tg["boxes"] / S}
    return {"image": out_img.clamp(0.0, 1.0), "targets": out_t}


class DeviceAugment:
    """The recipe of one ``hyp`` and ``k_mosaic``: ``draw(rng, B, S)`` on
    the host, ``augment(batch, draws)`` on the batch's device (draws as
    numpy are uploaded first)."""

    def __init__(self, hyp: Dict, k_mosaic: int = 2):
        _check(hyp, k_mosaic)
        self.hyp, self.k_mosaic = dict(hyp), k_mosaic

    def draw(self, rng: np.random.Generator, B: int, S: int) -> Dict[str, np.ndarray]:
        return draw_augment(rng, B, S, self.hyp, self.k_mosaic)

    def __call__(self, batch: Dict, draws: Dict, rows: Optional[Tensor] = None) -> Dict:
        if isinstance(next(iter(draws.values())), np.ndarray):
            draws = upload_draws(draws, batch["image"].device)
        return apply_augment(batch, draws, rows)


def make_device_augment(hyp: Dict, k_mosaic: int = 2) -> DeviceAugment:
    """The device recipe for ``hyp`` (raises for a rotational recipe or a
    ``k_mosaic`` outside {1, 2})."""
    return DeviceAugment(hyp, k_mosaic)
