"""Re-wire a trained Detect header for another label order or subset (port
of ``hd_yolo_tpu/utils/label_remap.py``).

A det conv's output channels are laid out anchor-major as [x, y, w, h, obj,
cls_1..cls_nc] per anchor.  A label remap selects and permutes the class
channels of the 1x1 det convs, so a checkpoint serves a re-ordered label
set.  The port's det conv ``headers.<tag>.m.<level>`` holds a weight of
shape (na·(5+nc), C, 1, 1) and a bias (na·(5+nc),): the select runs along
dim 0.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Tensor = torch.Tensor


def remap_det_conv(weight: Tensor, bias: Tensor, na: int, nc_old: int,
                   label_map: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """weight (na·(5+nc_old), C, 1, 1), bias (na·(5+nc_old),) → the same
    with the class channels selected and permuted by ``label_map`` (old
    1-based class ids; 0 copies the objectness prior into a fresh slot)."""
    no_old = 5 + nc_old
    sel = [0, 1, 2, 3, 4] + [4 if m == 0 else 4 + m for m in label_map]
    idx = torch.tensor([a * no_old + j for a in range(na) for j in sel], dtype=torch.long,
                       device=weight.device)
    return weight.index_select(0, idx), bias.index_select(0, idx)


def manipulate_header_label_order(state_dict: Dict[str, Tensor], header_name: str, na: int,
                                  nc_old: int, label_map: Sequence[int]) -> Dict[str, Tensor]:
    """A copy of the model ``state_dict`` with every det conv of the header
    ``header_name`` (its tag) remapped.  ``label_map``: new class index → old
    1-based class id (0: a new blank class seeded from the objectness).  The
    caller builds the model anew with ``nc = len(label_map)``."""
    out = dict(state_dict)
    prefix = f"headers.{header_name}.m."
    for key in state_dict:
        if key.startswith(prefix) and key.endswith(".weight"):
            base = key[: -len(".weight")]
            out[key], out[base + ".bias"] = remap_det_conv(
                state_dict[key], state_dict[base + ".bias"], na, nc_old, label_map)
    return out
