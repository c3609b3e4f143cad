"""Load torchvision-layout Mask R-CNN and FPN weights into the port's
``hnet.mask_rcnn.MaskRCNN`` and ``hnet.fpn.FeaturePyramidNetwork`` (port of
``hd_yolo_tpu/utils/import_maskrcnn.py``).

The key layout is torchvision's GeneralizedRCNN as the reference container
exposes it: ``rpn.head.{conv,cls_logits,bbox_pred}``,
``roi_heads.box_head.{fc6,fc7}``, ``roi_heads.box_predictor.{cls_score,
bbox_pred}`` and, when present, ``roi_heads.mask_head.mask_fcn{1..4}`` with
``roi_heads.mask_predictor.{conv5_mask,mask_fcn_logits}``, and the keypoint
branch ``roi_heads.keypoint_head.*`` / ``roi_heads.keypoint_predictor.*``.
The port keeps torch's layouts (OIHW convs, (O, I) linears, the box head's
fc6 on the reference's (C, 7, 7) flattening, which ``BoxHead`` permutes
itself), so nothing is transposed or permuted: the JAX importer's
conversions to flax layouts have no counterpart here.  The mask head takes
the port's ``MaskHead`` names.
"""

from __future__ import annotations

from typing import Dict

import torch

_DIRECT = ("rpn.head.conv", "rpn.head.cls_logits", "rpn.head.bbox_pred",
           "roi_heads.box_head.fc6", "roi_heads.box_head.fc7",
           "roi_heads.box_predictor.cls_score", "roi_heads.box_predictor.bbox_pred")


def _copy(sd: Dict, out: Dict, src: str, dst: str) -> None:
    for suffix in (".weight", ".bias"):
        if src + suffix in sd:
            out[dst + suffix] = torch.as_tensor(sd[src + suffix])


def import_maskrcnn_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision-layout Mask R-CNN ``sd`` → a state dict for the port's
    ``MaskRCNN``: the box branch always, the mask branch when
    ``roi_heads.mask_head`` keys are present, the keypoint branch when
    ``roi_heads.keypoint_head`` keys are."""
    out: Dict[str, torch.Tensor] = {}
    for key in _DIRECT:
        _copy(sd, out, key, key)
    m = "roi_heads.mask_head"
    if f"{m}.mask_fcn1.weight" in sd:
        for i in range(4):
            _copy(sd, out, f"{m}.mask_fcn{i + 1}", f"{m}.maskrcnn_heads.mask_fcn{i + 1}")
        _copy(sd, out, "roi_heads.mask_predictor.conv5_mask", f"{m}.maskrcnn_preds.conv5_mask")
        _copy(sd, out, "roi_heads.mask_predictor.mask_fcn_logits",
              f"{m}.maskrcnn_preds.mask_fcn_logits")
    for k, v in sd.items():
        if k.startswith(("roi_heads.keypoint_head.", "roi_heads.keypoint_predictor.")):
            out[k] = torch.as_tensor(v)
    return out


def import_fpn_state_dict(sd: Dict, prefix: str = "fpn.", num_levels: int = 4,
                          p6p7: bool = True) -> Dict[str, torch.Tensor]:
    """torchvision ``FeaturePyramidNetwork`` (+ ``LastLevelP6P7``) keys under
    ``prefix`` → a state dict for the port's ``FeaturePyramidNetwork``:
    ``inner_blocks.{i}``, ``layer_blocks.{i}``, ``extra_blocks.p6`` / ``p7``."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_levels):
        for block in ("inner_blocks", "layer_blocks"):
            _copy(sd, out, f"{prefix}{block}.{i}", f"{block}.{i}")
    if p6p7 and f"{prefix}extra_blocks.p6.weight" in sd:
        for p in ("p6", "p7"):
            _copy(sd, out, f"{prefix}extra_blocks.{p}", f"extra_blocks.{p}")
    return out
