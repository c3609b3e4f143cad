"""Slide tiling, tile extraction and stitched inference (port of
``hd_yolo_tpu/wsi/tiling.py``).

The slide lives on the device once; tiles are gathered on the device (no
host round trip per tile), tile batches stream through the forward, and the
stitch runs a band-limited class-aware NMS on the device through
``ops/nms.batched_nms_padded`` (the NMS kernel on a CUDA tensor).  Only the
final rows come to the host, as one flat byte buffer in one copy.

PyTorch runs eagerly, so ``fused=True`` runs the same loop as streaming;
each mode returns what its JAX mode returns: fused runs the padded tile
grid and invalidates the grid-pad duplicate tiles' rows, streaming drops
them, so the stitched set holds padded tiles x D rows in one and n x D in
the other.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import parallel
from ..ops.nms import batched_nms_padded

Tensor = torch.Tensor


def sliding_window_grid(h: int, w: int, tile: int = 640, overlap: int = 64) -> np.ndarray:
    """(N, 2) int32 (y, x) tile origins covering an h×w slide.

    Stride = tile − overlap; the final row/col snaps inward so tiles never
    cross the border (full static tile shapes)."""
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} must be smaller than the tile {tile}")

    def starts(size):
        if size <= tile:
            return [0]
        s = list(range(0, size - tile, stride))
        s.append(size - tile)
        return s

    return np.asarray([(y, x) for y in starts(h) for x in starts(w)], np.int32)


def extract_tiles(slide: Tensor, origins: Tensor, tile: int) -> Tensor:
    """Gather the (N, tile, tile, C) tile batch from an (H, W, C) slide, on
    the slide's device, as one indexed read."""
    origins = torch.as_tensor(origins, device=slide.device).long()
    ar = torch.arange(tile, device=slide.device)
    rows = origins[:, 0, None] + ar
    cols = origins[:, 1, None] + ar
    return slide[rows[:, :, None], cols[:, None, :]]


def slide_inference_sharded(
    forward: Callable[..., Dict[str, Tensor]],
    slide,
    tile: int = 640,
    overlap: int = 64,
    batch_per_device: int = 4,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """Slide inference over the ranks of the process group, one card each:
    each tile batch holds ``batch_per_device`` x world tiles, rank r
    forwards its contiguous share (rows ``[r·bpd, (r+1)·bpd)``), the padded
    outputs are gathered from every rank in rank order, and every rank
    stitches the same result through :func:`slide_inference`.  Without a
    group (or at world 1) it is :func:`slide_inference` with ``batch =
    batch_per_device``.  ``kwargs`` go to :func:`slide_inference`.  Each
    rank's forward runs inside ``parallel.global_batch()``, so work that
    spans the forward's batch spans the global tile batch, as the JAX
    package's one program does: the packed mask branch ranks its ROI
    budget over every rank's tiles."""
    world, rank = parallel.world_size(), parallel.rank()
    if world == 1:
        return slide_inference(forward, slide, tile=tile, overlap=overlap,
                               batch=batch_per_device, **kwargs)

    def sharded_forward(tiles: Tensor) -> Dict[str, Tensor]:
        own = tiles[rank * batch_per_device:(rank + 1) * batch_per_device]
        with parallel.global_batch():
            out = forward(own)
        return parallel.all_gather_rows(out)

    return slide_inference(sharded_forward, slide, tile=tile, overlap=overlap,
                           batch=batch_per_device * world, **kwargs)


def slide_inference(
    forward: Callable[..., Dict[str, Tensor]],
    slide,
    tile: int = 640,
    overlap: int = 64,
    batch: int = 8,
    iou_thres: float = 0.45,
    max_total: int = 4096,
    class_aware_nms: bool = True,
    preprocess: Optional[Callable[[Tensor], Tensor]] = None,
    mask_uint8: bool = False,
    fused: bool = False,
    forward_vars=None,
    band_limit: bool = True,
    band_margin: int = 32,
    max_band: int = 1024,
    mask_bits: bool = False,
    packed_fetch: bool = True,
    mask_rows: Optional[int] = 1024,
    row_keys: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    """Run tiled inference over a slide and stitch detections globally.

    Args:
      forward: (B, tile, tile, C) → per-image output dict with 'boxes'
        (B, D, 4), 'scores' (B, D), 'labels' (B, D), 'valid' (B, D) (one
        task's outputs).  With ``forward_vars`` set, the signature is
        ``forward(vars, tiles)``.
      slide: (H, W, C) tensor (it stays on its device) or numpy array (a
        CPU tensor).
      max_total: capacity of the stitched detection set.
      mask_uint8: return mask probabilities quantized to uint8 (p*255).
      fused: the JAX package's one-program mode: the padded tile grid runs
        and the grid-pad duplicates' rows are invalidated (see the module
        docstring).
      band_limit: run the stitching NMS only over detections in the shared
        overlap bands (exact when the per-tile and stitch passes share
        ``iou_thres``; see ``_band_flags``).
      band_margin / max_band: band width slack (px) and band-NMS capacity;
        a band population that reaches ``max_band`` drops the rest and warns.
      mask_bits: masks thresholded at 0.5 and bit-packed on the device; host
        masks come back as bool (K, S, S).
      packed_fetch: bring rows and masks to the host as one flat byte buffer
        in one copy (rows as f32 columns, masks as their own bytes).
      mask_rows: mask-row compaction capacity: only the top-``mask_rows``
        mask-carrying rows' masks are fetched, re-expanded on the host; rows
        past it lose ``mask_valid`` (lowest scores first) without a warning,
        as in the JAX package.  None disables compaction.
      row_keys: optional whitelist of per-row output keys; the core keys
        are always kept.

    Returns a dict of host arrays: boxes (slide coords), scores, labels,
    valid (+ masks/mask_valid when the forward provides them).
    """
    slide = torch.as_tensor(slide)
    H, W = slide.shape[:2]
    origins = sliding_window_grid(H, W, tile, overlap)
    n = len(origins)
    pad = (-n) % batch
    origins_p = np.concatenate([origins, np.tile(origins[-1:], (pad, 1))]) if pad else origins
    b_y, b_x = _band_widths(origins, tile, overlap, band_margin)
    keep = (None if row_keys is None
            else frozenset(row_keys) | {"boxes", "scores", "labels", "valid"})
    mask_uint8 = mask_uint8 and not mask_bits  # bitpack reads probabilities
    call = (lambda t: forward(forward_vars, t)) if forward_vars is not None else forward
    origins_dev = torch.from_numpy(origins_p).to(slide.device)

    chunks = []
    for i in range(0, len(origins_p), batch):
        ob = origins_dev[i: i + batch]
        tiles = extract_tiles(slide, ob, tile)
        if preprocess is not None:
            tiles = preprocess(tiles)
        chunk = _shift_and_pad(_filter_keys(call(tiles), keep), ob)
        if band_limit:
            chunk["band"] = _band_flags(chunk["boxes"], ob, H, W, tile, b_y, b_x)
        chunks.append(chunk)

    merged = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    if fused:  # rows of the grid-pad duplicate tiles are invalidated, not dropped
        tile_ok = torch.arange(len(origins_p), device=slide.device) < n
        merged["valid"] = merged["valid"] & tile_ok[:, None]
    else:
        merged = {k: v[:n] for k, v in merged.items()}
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in merged.items()}
    labels_for_nms = flat["labels"] if class_aware_nms else torch.zeros_like(flat["labels"])
    gathered = _global_stitch_nms(flat, labels_for_nms, iou_thres, max_total, mask_uint8,
                                  max_band=max_band, max_mask_rows=mask_rows)
    return _warn_band_saturation(_fetch_gathered(gathered, mask_bits, packed_fetch), max_band)


def _band_widths(origins: np.ndarray, tile: int, overlap: int,
                 margin: int) -> Tuple[float, float]:
    """Per-axis band width (b_y, b_x) from the actual grid geometry.

    ``sliding_window_grid`` snaps the last row/col inward, so the effective
    overlap between the last two tiles along an axis is ``tile − Δ`` where
    ``Δ`` is their origin delta.  Band-NMS ≡ full-NMS needs the two tiles'
    trimmed interiors to be spatially disjoint; the width is the
    conservative ``max(overlap, tile − Δ_min) + margin``."""
    out = []
    for ax in (0, 1):
        vs = np.unique(origins[:, ax])
        d = int(np.diff(vs).min()) if len(vs) > 1 else tile
        out.append(float(max(overlap, tile - d) + margin))
    return out[0], out[1]


def _warn_band_saturation(host: Dict[str, np.ndarray], max_band: int) -> Dict[str, np.ndarray]:
    """Pop the band-population diagnostic and warn when the band top-K
    saturated (band detections beyond ``max_band`` are dropped)."""
    count = host.pop("band_count", None)
    if count is not None and count.size and int(count.flat[0]) >= max_band:
        warnings.warn(
            f"slide_inference: band population {int(count.flat[0])} hit the "
            f"max_band={max_band} capacity; detections past the top-"
            f"{max_band} band scores were DROPPED. Raise max_band "
            f"(~n_band_tiles × max_det) or disable band_limit.",
            RuntimeWarning, stacklevel=3)
    return host


def _band_flags(boxes_slide: Tensor, ob: Tensor, H: int, W: int, tile: int, b_y: float,
                b_x: float) -> Tensor:
    """(B, D) bool: the detection may interact with another tile's.

    A box inside its tile's non-shared core (the tile shrunk by the band
    width on every edge that has a neighbour) cannot intersect another
    tile's box, so only band boxes need the cross-tile NMS."""
    y0 = ob[:, 0:1].float()
    x0 = ob[:, 1:2].float()
    zero = torch.zeros_like(y0)
    lo_y = y0 + torch.where(y0 > 0, b_y + zero, zero)
    hi_y = y0 + tile - torch.where(y0 + tile < H, b_y + zero, zero)
    lo_x = x0 + torch.where(x0 > 0, b_x + zero, zero)
    hi_x = x0 + tile - torch.where(x0 + tile < W, b_x + zero, zero)
    bx = boxes_slide.float()
    interior = ((bx[..., 0] >= lo_x) & (bx[..., 2] <= hi_x)
                & (bx[..., 1] >= lo_y) & (bx[..., 3] <= hi_y))
    return ~interior


def _filter_keys(out: Dict[str, Tensor], keep) -> Dict[str, Tensor]:
    """Apply the ``row_keys`` whitelist (None = keep everything); ``masks``
    ride along only when whitelisted, ``mask_valid`` follows ``masks``."""
    if keep is None:
        return out
    return {k: v for k, v in out.items()
            if k in keep or (k == "mask_valid" and "masks" in keep)}


def _shift_and_pad(out: Dict[str, Tensor], ob: Tensor) -> Dict[str, Tensor]:
    """Shift per-tile boxes into slide coords; zero-pad keys whose capacity
    is below the detection axis (masks) to it, so one flat index addresses
    every key.  ``mask_valid`` (derived from ``valid`` when the forward
    gives none) marks the slots that carry a computed mask."""
    shift = ob[:, None, [1, 0, 1, 0]].to(out["boxes"].dtype)
    chunk = dict(out)
    chunk["boxes"] = out["boxes"] + shift
    D = chunk["boxes"].shape[1]
    if "masks" in chunk and "mask_valid" not in chunk:
        chunk["mask_valid"] = out["valid"][:, : chunk["masks"].shape[1]]
    for k, v in chunk.items():
        if v.shape[1] != D:
            pad = torch.zeros((v.shape[0], D - v.shape[1]) + tuple(v.shape[2:]), dtype=v.dtype,
                              device=v.device)
            chunk[k] = torch.cat([v, pad], 1)
    return chunk


def _top_k(x: Tensor, k: int) -> Tensor:
    """Indices of the k largest, in ``lax.top_k`` order: descending, ties to
    the lower index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _global_stitch_nms(flat: Dict[str, Tensor], labels_for_nms: Tensor, iou_thres: float,
                       max_total: int, mask_uint8: bool = False, max_band: int = 1024,
                       max_mask_rows: Optional[int] = None) -> Dict[str, Tensor]:
    """Device-side stitch: band-limited cross-tile NMS + top-K row gather.

    Per-tile NMS already ran in the forward, so cross-tile suppression only
    exists among detections flagged ``band``: the NMS runs over the
    top-``max_band`` band detections, interior detections pass through, and
    the final top-``max_total`` gather is score-ordered.  Without a ``band``
    key the full global NMS runs over the top-``max_total``.  Returns the
    gathered rows (one NMS launch either way)."""
    boxes, scores, valid = flat["boxes"], flat["scores"], flat["valid"]
    band = flat.pop("band", None)
    K = boxes.shape[0]
    neg_inf = torch.full_like(scores, float("-inf"))
    if band is None:
        masked = torch.where(valid, scores, neg_inf)
        k = min(max_total, K)
        sel = _top_k(masked, k)
        idx, keep = batched_nms_padded(boxes[sel], masked[sel], labels_for_nms[sel].clamp(min=0),
                                       valid[sel], iou_thres, max_det=k)
        rows = sel[idx.long()]
        gathered = {k_: v[rows] for k_, v in flat.items()}
        gathered["valid"] = keep & gathered["valid"]
    else:
        band = band & valid
        kb = min(max_band, K)
        band_score = torch.where(band, scores, neg_inf)
        selb = _top_k(band_score, kb)
        idxb, keepb = batched_nms_padded(boxes[selb], band_score[selb],
                                         labels_for_nms[selb].clamp(min=0), band[selb],
                                         iou_thres, max_det=kb)
        # band rows past the max_band capacity are dropped (like max_total).
        # A max-scatter: unfilled slots repeat index 0 with keep False, and a
        # plain write could let one of them overwrite the True of a real slot.
        band_kept = torch.zeros(K, dtype=torch.int32, device=boxes.device).scatter_reduce(
            0, selb[idxb.long()], keepb.to(torch.int32), "amax") > 0
        kept = (valid & ~band) | band_kept
        k = min(max_total, K)
        sel = _top_k(torch.where(kept, scores, neg_inf), k)
        gathered = {k_: v[sel] for k_, v in flat.items()}
        gathered["valid"] = kept[sel]
        # band population, broadcast to rows so the packed fetch carries it
        gathered["band_count"] = band.sum(dtype=torch.int32).expand(k)
    if "mask_valid" in gathered:
        gathered["mask_valid"] = gathered["mask_valid"] & gathered["valid"]
    if mask_uint8 and "masks" in gathered:
        gathered["masks"] = torch.round(gathered["masks"].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    if ("masks" in gathered and max_mask_rows is not None
            and max_mask_rows < gathered["masks"].shape[0]):
        # mask-row compaction: fetch the top-K mask rows + a per-row slot
        # index instead of a dense (max_total, S, S) buffer; the host
        # re-expands it (rows past the capacity lose mask_valid)
        mv = gathered.get("mask_valid", gathered["valid"])
        k_rows = gathered["boxes"].shape[0]
        Km = min(max_mask_rows, k_rows)
        prio = torch.where(mv, gathered["scores"].float(),
                           torch.full_like(gathered["scores"], float("-inf"), dtype=torch.float32))
        msel = _top_k(prio, Km)
        slot = torch.full((k_rows,), -1, dtype=torch.int32, device=mv.device)
        slot[msel] = torch.arange(Km, dtype=torch.int32, device=mv.device)
        keep_m = mv & (slot >= 0)
        gathered["masks"] = gathered["masks"][msel]
        gathered["mask_slot"] = torch.where(keep_m, slot, torch.full_like(slot, -1))
        gathered["mask_valid"] = keep_m
    return gathered


_NP_DTYPE = {torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8", torch.int16: "int16",
             torch.int32: "int32", torch.int64: "int64", torch.float16: "float16",
             torch.bfloat16: "float32", torch.float32: "float32", torch.float64: "float64"}


def _to_numpy(t: Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _fetch_gathered(gathered: Dict[str, Tensor], mask_bits: bool,
                    packed_fetch: bool) -> Dict[str, np.ndarray]:
    """Bring the stitched rows to the host: with ``packed_fetch`` one flat
    byte buffer in one device-to-host copy (the row keys as f32 columns, then
    the mask bytes as they are), unpacked on the host; then the mask slots
    are re-expanded.  Mask bytes are never reinterpreted as floats."""
    masks = gathered.get("masks")
    if mask_bits and masks is not None:
        masks = _bitpack_masks(masks)
    if not packed_fetch:
        host = {k: _to_numpy(v) for k, v in gathered.items() if k != "masks"}
        if masks is not None:
            side = gathered["masks"].shape[-1]
            host["masks"] = (_bitunpack_masks(_to_numpy(masks), side) if mask_bits
                             else _to_numpy(masks))
        return _expand_mask_slots(host)
    rest = {k: v for k, v in gathered.items() if k != "masks"}
    layout = tuple((k, int(np.prod(rest[k].shape[1:])) if rest[k].dim() > 1 else 1,
                    _NP_DTYPE[rest[k].dtype], tuple(rest[k].shape[1:])) for k in sorted(rest))
    n_rows = rest["boxes"].shape[0]
    row_w = sum(w for _, w, _, _ in layout)
    rows = torch.cat([rest[k].reshape(n_rows, -1).float() for k in sorted(rest)], 1)
    parts = [rows.reshape(-1).view(torch.uint8)]
    if masks is not None:
        m = masks.contiguous()
        parts.append((m if m.dtype == torch.uint8 else m.float()).reshape(-1).view(torch.uint8))
    buf = (torch.cat(parts) if len(parts) > 1 else parts[0]).cpu().numpy()  # ONE copy
    n_row_bytes = n_rows * row_w * 4
    host = _unpack_rows(buf[:n_row_bytes].view(np.float32).reshape(n_rows, row_w), layout)
    if masks is not None:
        side = gathered["masks"].shape[-1]
        K = gathered["masks"].shape[0]
        tail = buf[n_row_bytes:]
        if mask_bits:
            host["masks"] = _bitunpack_masks(tail.reshape(K, -1), side)
        elif masks.dtype == torch.uint8:
            host["masks"] = tail.reshape(K, side, side).copy()
        else:
            host["masks"] = tail.view(np.float32).reshape(K, side, side)
    return _expand_mask_slots(host)


def _expand_mask_slots(host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Re-expand device-compacted masks: ``mask_slot`` maps each stitched row
    to its row in the compact fetched mask array (−1 = no mask)."""
    slot = host.pop("mask_slot", None)
    if slot is None or "masks" not in host:
        return host
    slot = np.rint(np.asarray(slot)).astype(np.int64)
    compact = host["masks"]
    full = np.zeros((slot.shape[0],) + compact.shape[1:], compact.dtype)
    ok = slot >= 0
    full[ok] = compact[slot[ok]]
    host["masks"] = full
    return host


def _unpack_rows(packed: np.ndarray, layout: Tuple) -> Dict[str, np.ndarray]:
    out, off = {}, 0
    for k, w, dtype, shape in layout:
        sl = packed[:, off: off + w].reshape((-1,) + tuple(shape))
        if dtype == "bool":
            out[k] = sl > 0.5
        elif dtype.startswith("int") or dtype.startswith("uint"):
            out[k] = np.rint(sl).astype(dtype)
        else:
            out[k] = sl.astype(dtype)
        off += w
    return out


def _bitpack_masks(masks: Tensor) -> Tensor:
    """(K, S, S) probabilities → (K, S·S/8) uint8, 8 px per byte (little
    bit order) at the 0.5 threshold."""
    K = masks.shape[0]
    bits = (masks.reshape(K, -1, 8) > 0.5).to(torch.uint8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=masks.device)
    return (bits * weights).sum(-1, dtype=torch.uint8)


def _bitunpack_masks(packed: np.ndarray, side: int) -> np.ndarray:
    K = packed.shape[0]
    bits = np.unpackbits(packed, axis=-1, bitorder="little")
    return bits.reshape(K, side, side).astype(bool)
