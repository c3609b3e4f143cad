"""Checkpoints (port of ``hd_yolo_tpu/engines/checkpoint.py``).

Inference: the JAX package writes orbax directories of flax trees; the port
writes a ``.pt`` file of the model's ``state_dict`` in the reference torch
layout (``conv``/``bn``, ``backbone.i``, ``headers.<tag>``), which the
reference code and ``utils/convert.load_weights`` read.  ``load_inference``
also takes a pickled flax ``{'params', 'batch_stats'}`` tree.  A JAX orbax
checkpoint reaches the port as a ``.pt``: JAX ``load_inference`` →
``utils/convert.state_dict_from_flax`` → :func:`save_inference` (the port
imports no orbax).

Training: ``save_checkpoint(path, state, epoch, ...)`` writes the whole
``TrainState`` (step, the model's parameters and buffers, the optimizer's
state, the EMA) to ``<path>.pt`` and its metadata (epoch, best fitness,
date) to the JSON sidecar ``<path>.json``, written after the ``.pt`` so a
crash mid-write leaves the previous metadata; ``async_save`` copies the
state to the host at once and writes it in a background thread
(``wait_for_saves`` joins them).  ``restore_train_state`` loads one back.
Inside a process group only rank 0 writes; every rank restores.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..parallel.distributed import is_main_process
from ..utils.convert import load_weights


def save_inference(path: str, model: nn.Module) -> str:
    """Write ``model``'s ``state_dict`` (host copies) to the ``.pt`` file
    ``path`` (on rank 0 only, inside a process group)."""
    if not is_main_process():
        return path
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


def _payload(state) -> Dict[str, Any]:
    """The train state as host tensors."""
    return {
        "step": state.step.detach().cpu(),
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "opt": state.opt.state_dict(),
        "ema": [p.detach().cpu() for p in state.ema.params],
        "ema_updates": state.ema.updates.detach().cpu(),
    }


_PENDING: Dict[str, threading.Thread] = {}   # path → thread of an in-flight save


def _write(path: str, payload: Dict[str, Any], meta: Dict[str, Any]) -> None:
    tmp = path + ".pt.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path + ".pt")
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def wait_for_saves() -> None:
    """Block until every background save has written its files."""
    for path in list(_PENDING):
        _PENDING.pop(path).join()


def save_checkpoint(path: str, state, epoch: int, best_fitness: float = 0.0,
                    extra: Optional[Dict[str, Any]] = None, async_save: bool = False) -> None:
    """Save a full training checkpoint to ``<path>.pt`` + ``<path>.json``
    (on rank 0 only, inside a process group: every rank holds the same state)."""
    if not is_main_process():
        return
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {"epoch": epoch, "best_fitness": float(best_fitness),
            "date": datetime.datetime.now().isoformat(), **(extra or {})}
    if path in _PENDING:                       # a save to this path still in flight
        _PENDING.pop(path).join()
    payload = _payload(state)
    if not async_save:
        _write(path, payload, meta)
        return
    t = threading.Thread(target=_write, args=(path, payload, meta), daemon=False)
    t.start()
    _PENDING[path] = t


def load_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.abspath(path) + ".json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


@torch.no_grad()
def restore_train_state(path: str, state):
    """Load ``<path>.pt`` into ``state`` (its model, optimizer and EMA on
    their device), in place; returns (state, meta)."""
    ckpt = torch.load(os.path.abspath(path) + ".pt", map_location="cpu", weights_only=False)
    dev = state.step.device
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.opt.load_state_dict(ckpt["opt"])
    torch._foreach_copy_(state.ema.params, [p.to(dev) for p in ckpt["ema"]])
    state.ema.updates = ckpt["ema_updates"].to(dev)
    state.step = ckpt["step"].to(dev)
    return state, load_meta(path)
