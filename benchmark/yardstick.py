"""The yardstick, frozen here so that no change to the program moves it: the
H100's published peaks, the least time a piece of work can take on them,
the work of the stem and of the mask head, and the model's operations
counted from the configuration's layer shapes.

Copied from ``chip_smoke.py`` (the lines named at each), which later
changes may move or delete: ``HBM_BPS`` / ``BF16_FLOPS`` / ``TF32_FLOPS`` /
``F32_FLOPS`` (:409-412), ``bound`` (:612), ``stem_bound`` (:696),
``mask_head_flops`` (:1219).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

# NVIDIA H100 SXM, published dense peaks (chip_smoke.py:409-412)
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
PEAK = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "float32": TF32_FLOPS}
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_seconds(nbytes: float, flops: float, peak_flops: float) -> Tuple[float, str]:
    """The least time for the work and which side bounds it (chip_smoke.py:612,
    in seconds)."""
    tb, tf = nbytes / HBM_BPS, flops / peak_flops
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def stem_work(B: int, H: int, W: int, C: int, N: int, k: int, s: int, p: int,
              dtype: str) -> Tuple[float, float]:
    """(bytes, operations) of the stem conv + BatchNorm + SiLU
    (chip_smoke.py:696): the float32 input, the float32 kernel, scale and
    bias read once, the output written once in the compute dtype;
    2·B·Ho·Wo·N·k²·C operations."""
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    nbytes = B * H * W * C * 4 + k * k * C * N * 4 + 2 * N * 4 + B * Ho * Wo * N * BYTES[dtype]
    return float(nbytes), 2.0 * B * Ho * Wo * N * k * k * C


def mask_head_flops(n: float, C: int = 256) -> float:
    """Operations of the mask head on ``n`` ROIs: four 3x3 convs at 14 x 14,
    the 2x2/s2 deconv to 28 x 28, the 1x1 logits of the one selected
    channel (chip_smoke.py:1219)."""
    return float(n) * (4 * 196 * 9 * C * C * 2 + 4 * 196 * C * C * 2 + 4 * 196 * C * 2)


def mask_head_bytes(n: float, C: int = 256, dtype: str = "bfloat16") -> float:
    """The mask head's pooled input and its weights read once, the selected
    28 x 28 float32 probabilities written once."""
    e = BYTES[dtype]
    weights = (4 * 9 * C * C + 4 * C * C + C) * e + (4 * C + C + 1) * 4
    return float(n) * (196 * C * e + 784 * 4) + weights


@torch.no_grad()
def model_flops(model, tag: str, B: int, S: int) -> Dict[str, float]:
    """Operations of one forward of ``B`` tiles of ``S`` px through the
    plain reference ``model`` (on the meta device), counted from its layer
    shapes by torch's ``FlopCounterMode``: the trunk with the det convs,
    and the mask branch's per-level convs."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros((B, S, S, 3), dtype=torch.uint8, device="meta")
    det = model.headers[tag]
    out = {}
    with FlopCounterMode(display=False) as fc:
        feats = model.trunk(x)
        lv = [feats[j] for j in det.h["from"]]
        det.det_logits(lv)
    out["trunk"] = float(fc.get_total_flops())
    if det.h["nc_masks"] > 0:
        with FlopCounterMode(display=False) as fc:
            det.seg_feats(lv)
        out["seg"] = float(fc.get_total_flops())
    return out
