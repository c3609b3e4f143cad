"""NMS on the card: wrapper of the bitmask kernel ``kernels/nms.cu``
(the Hopper port of ``hd_yolo_tpu/ops/pallas_nms.py``).

``nms_keep_sorted`` takes score-sorted boxes and a bool valid mask and
returns the compacted ``(positions int32, keep bool)``: on a CUDA tensor it
launches the kernel, on a CPU tensor it runs the plain version
(``ops/nms.py`` ``greedy_keep`` + ``compact``).  Both are exact greedy NMS
and agree bit for bit.  The kernel is the ``torch.library`` op
``hd_yolo_tpu_torch::nms_keep`` (the ``ctypes`` launch in its body, a fake
implementation of its output shapes), so ``torch.export`` keeps it as one
call in the graph; eager calls on the card go through the same op.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .nms import compact, greedy_keep, sort_by_score

Tensor = torch.Tensor


def nms_keep_sorted_plain(sboxes: Tensor, svalid: Tensor, iou_threshold: float,
                          max_det: int) -> Tuple[Tensor, Tensor]:
    return compact(greedy_keep(sboxes, svalid, iou_threshold), None, max_det)


def nms_keep_sorted(sboxes: Tensor, svalid: Tensor, iou_threshold: float,
                    max_det: int) -> Tuple[Tensor, Tensor]:
    """Score-sorted boxes (B, K, 4) f32 + valid (B, K) bool → (positions (B, max_det)
    int32 into the sorted order, keep (B, max_det) bool).

    On the card the kernel reads ``svalid``'s storage and writes ``keep``'s
    directly (torch ``bool`` is one byte, 0 or 1): no dtype conversion runs."""
    if sboxes.device.type == "cpu":
        return nms_keep_sorted_plain(sboxes, svalid, iou_threshold, max_det)
    shape = sboxes.shape
    if len(shape) != 3 or shape[2] != 4 or sboxes.dtype != torch.float32:
        raise ValueError(f"nms kernel takes (B, K, 4) float32 boxes, got {tuple(sboxes.shape)} "
                         f"{sboxes.dtype}")
    B, K = shape[0], shape[1]
    if svalid.dtype != torch.bool or svalid.shape != (B, K):
        raise ValueError(f"nms kernel takes a ({B}, {K}) bool valid mask, got "
                         f"{tuple(svalid.shape)} {svalid.dtype}")
    sboxes, svalid = sboxes.contiguous(), svalid.contiguous()
    kernels.require_cuda(sboxes, svalid)
    return nms_keep_op(sboxes, svalid, float(iou_threshold), int(max_det))


def _launch(sboxes: Tensor, svalid: Tensor, iou_threshold: float,
            max_det: int) -> Tuple[Tensor, Tensor]:
    B, K = sboxes.shape[:2]
    if sboxes.data_ptr() % 16:                    # read as float4s
        sboxes = sboxes.clone()
    if B == 0 or K == 0:
        return (torch.zeros((B, max_det), dtype=torch.int32, device=sboxes.device),
                torch.zeros((B, max_det), dtype=torch.bool, device=sboxes.device))
    idx = torch.empty((B, max_det), dtype=torch.int32, device=sboxes.device)
    keep = torch.empty((B, max_det), dtype=torch.bool, device=sboxes.device)
    mask = torch.empty((B, (K + 63) // 64 + 1, K), dtype=torch.int64, device=sboxes.device)
    dev, stream = kernels.device_and_stream(sboxes)
    code = kernels.fn("nms_keep")(
        sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(), idx.data_ptr(), keep.data_ptr(),
        B, K, max_det, float(iou_threshold), dev, stream)
    kernels.check(code, "nms_keep")
    kernels.LAUNCHES["nms"] += 1
    return idx, keep


def _fake(sboxes, svalid, iou_threshold, max_det):
    B = sboxes.shape[0]
    return (sboxes.new_empty((B, max_det), dtype=torch.int32),
            sboxes.new_empty((B, max_det), dtype=torch.bool))


nms_keep_op = kernels.register_op(
    "nms_keep", "(Tensor sboxes, Tensor svalid, float iou_threshold, int max_det) "
                "-> (Tensor, Tensor)", _launch, _fake)


def nms_padded_pallas(boxes: Tensor, scores: Tensor, valid: Tensor, iou_threshold: float,
                      max_det: int, presorted: bool = False) -> Tuple[Tensor, Tensor]:
    """``ops/nms.py`` ``nms_padded`` contract on the kernel: (indices into
    the original order, keep), for one image (K, 4) or a batch (B, K, 4)."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    if presorted:
        sboxes, svalid, order = boxes, valid, None
    else:
        order = sort_by_score(scores, valid)
        sboxes = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
        svalid = torch.gather(valid, -1, order)
    pos, keep = nms_keep_sorted(sboxes.float(), svalid, iou_threshold, max_det)
    if order is not None:
        mapped = torch.gather(order, -1, pos.to(torch.int64)).to(torch.int32)
        pos = torch.where(keep, mapped, torch.zeros_like(mapped))
    return (pos[0], keep[0]) if single else (pos, keep)
