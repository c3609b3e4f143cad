"""Load upstream (Microsoft / timm / mmdet) Swin Transformer weights into the
port's ``hnet.swin.SwinTransformer`` (port of
``hd_yolo_tpu/utils/import_swin.py``).

The port's module names already are upstream's (``patch_embed.proj`` /
``norm``, ``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,
attn.relative_position_bias_table,norm2,mlp.fc1,mlp.fc2}``,
``layers.{i}.downsample.{reduction,norm}``, the output norms ``norm{k}``),
and so is the PatchMerging channel order, so the import is by name: a
``backbone.`` prefix (mmdet) is stripped, the buffers the port recomputes
(``relative_position_index``, ``attn_mask``) are dropped, every key of the
model must be present with its shape, and the keys left over are reported
in the log, as the JAX importer reports them.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .. import LOGGER

_RECOMPUTED = ("relative_position_index", "attn_mask")


def import_swin_state_dict(sd: Dict, model: nn.Module) -> List[str]:
    """Load the upstream-layout ``sd`` into ``model`` (strictly: every key of
    the model, each of its shape); returns the keys of ``sd`` not used."""
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v for k, v in sd.items()}
    want = model.state_dict()
    out = {}
    for k, ref in want.items():
        if k not in sd:
            raise KeyError(f"swin importer: {k!r} missing from the state dict")
        v = torch.as_tensor(sd[k])
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"swin importer: {k!r} has shape {tuple(v.shape)}, the model "
                             f"{tuple(ref.shape)}")
        out[k] = v.to(ref.dtype)
    model.load_state_dict(out, strict=True)
    unused = [k for k in sd if k not in want and not any(r in k for r in _RECOMPUTED)]
    if unused:
        LOGGER.info(f"swin importer: {len(unused)} keys unused (first: {unused[:4]})")
    return unused
