"""Inference checkpoints (port of ``hd_yolo_tpu/engines/checkpoint.py``,
the inference half).

The JAX package writes orbax directories of flax trees; the port writes a
``.pt`` file of the model's ``state_dict`` in the reference torch layout
(``conv``/``bn``, ``backbone.i``, ``headers.<tag>``), which the reference
code and ``utils/convert.load_weights`` read.  ``load_inference`` also takes
a pickled flax ``{'params', 'batch_stats'}`` tree.  A JAX orbax checkpoint
reaches the port as a ``.pt``: JAX ``load_inference`` →
``utils/convert.state_dict_from_flax`` → :func:`save_inference` (the port
imports no orbax).  The training-state half (``save_checkpoint``,
``restore_train_state``) comes with yolo training.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..utils.convert import load_weights


def save_inference(path: str, model: nn.Module) -> str:
    """Write ``model``'s ``state_dict`` (host copies) to the ``.pt`` file ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_inference(path: str, model: nn.Module) -> nn.Module:
    """Load an inference checkpoint into ``model``, strictly: a ``.pt``
    ``state_dict`` (this package's :func:`save_inference` or a reference
    file, also under ``{'model'|'ema': ...}``) or a pickled flax tree.
    Returns ``model``."""
    load_weights(model, path)
    return model
