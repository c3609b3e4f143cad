"""Reference PyTorch checkpoints into the port's ``Model`` (port of
``hd_yolo_tpu/utils/import_torch.py``).

The port's module tree uses the reference's torch keys, so no per-layer map
is needed: a metayolo checkpoint (``backbone.{i}`` / ``neck.{j}`` /
``headers.{tag}``) loads by key and shape, deconvolutions torch to torch as
they are.  An ultralytics checkpoint's ``model.{i}.*`` keys are renumbered
straight to the port's keys: ``backbone.{i}`` below the model's backbone
length, ``neck.{i − n_backbone}`` above it, and the last index (the Detect
row) to the header.  A checkpoint whose single header carries another tag
than the model's single header (``headers.det`` for a ``detSC`` model) is
renamed to the model's.  ``{'ema' | 'model' | 'state_dict': module or
state_dict}`` wrappers are unwrapped, in that order.

Unlike the JAX package's importer, which writes a ``C3Ghost`` or ``C3TR``
layer's inner blocks under ``Bottleneck_{j}`` where its flax tree names them
``GhostBottleneck_{j}`` / ``TransformerBlock_0`` (and so leaves them at
their initial values), every key of such a layer loads here.
"""

from __future__ import annotations

import pickle
import types
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import LOGGER


class CheckpointClassError(ImportError):
    """A checkpoint pickles a class this machine cannot import."""


def _unpickler_module(path: str) -> types.ModuleType:
    """``pickle`` with an ``Unpickler`` whose failed class lookups raise
    ``CheckpointClassError`` naming ``path`` and the class."""
    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError) as e:
                raise CheckpointClassError(
                    f"{path}: the checkpoint pickles the class {module}.{name}, which cannot be "
                    f"imported here ({e}); save its state_dict instead") from e

    mod = types.ModuleType("checkpoint_pickle")
    mod.__dict__.update({k: getattr(pickle, k) for k in dir(pickle) if not k.startswith("__")})
    mod.Unpickler = Unpickler
    mod.load = lambda f, **kw: Unpickler(f, **kw).load()
    return mod


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file → its flat state_dict: a pickled module or a
    ``{'ema' | 'model' | 'state_dict': ...}`` wrapper unwrapped (the first
    of those keys that holds a module or a dict: a train state's ``ema``
    list of tensors is passed over for its ``model``), values as tensors;
    entries that hold no array are dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_unpickler_module(str(path)))
    if isinstance(ckpt, dict):
        for key in ("ema", "model", "state_dict"):
            v = ckpt.get(key)
            if isinstance(v, dict) or hasattr(v, "state_dict"):
                ckpt = v
                break
    if hasattr(ckpt, "state_dict"):
        ckpt = ckpt.state_dict()
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a state_dict or a checkpoint holding one "
                         f"({type(ckpt).__name__})")
    out = {}
    for k, v in ckpt.items():
        if torch.is_tensor(v):
            out[k] = v
        elif isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = torch.from_numpy(v)
    return out


def renumber_ultralytics(sd: Dict[str, torch.Tensor], n_backbone: int,
                         tag: str = "det") -> Dict[str, torch.Tensor]:
    """Ultralytics ``model.{i}.*`` keys → ``backbone.{i}`` (i < n_backbone),
    ``neck.{i − n_backbone}``, and ``headers.{tag}`` for the last index (the
    Detect row); other keys pass through."""
    idxs = sorted({int(k.split(".")[1]) for k in sd if k.startswith("model.")})
    if not idxs:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        if not k.startswith("model."):
            out[k] = v
            continue
        _, i, rest = k.split(".", 2)
        i = int(i)
        if i == idxs[-1]:
            out[f"headers.{tag}.{rest}"] = v
        elif i < n_backbone:
            out[f"backbone.{i}.{rest}"] = v
        else:
            out[f"neck.{i - n_backbone}.{rest}"] = v
    return out


def to_model_keys(model, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's keys as ``model`` names them: ultralytics keys
    renumbered, and the header of a single-header checkpoint under a
    single-header model's tag."""
    tags = list(model.headers.keys())
    one = tags[0] if len(tags) == 1 else "det"
    sd = renumber_ultralytics(sd, model.spec.n_backbone, one)
    saved = {k.split(".")[1] for k in sd if k.startswith("headers.")}
    if len(tags) == 1 and len(saved) == 1 and saved != {one}:
        old = saved.pop()
        sd = {k.replace(f"headers.{old}.", f"headers.{one}.", 1): v for k, v in sd.items()}
    return sd


def import_state_dict(model, sd: Dict[str, torch.Tensor]) -> Tuple[int, List[str]]:
    """Copy a port, reference-layout or ultralytics state_dict into
    ``model`` where key and shape agree (``to_model_keys``).  Returns the
    tensors loaded and the checkpoint's keys left over (``anchors``,
    ``anchor_grid``, ``mask_indices``, the loss buffers, ...)."""
    sd = to_model_keys(model, sd)
    own = model.state_dict()
    hits, left = 0, []
    with torch.no_grad():
        for k, v in sd.items():
            if k in own and own[k].shape == v.shape:
                own[k].copy_(v)
                hits += 1
            else:
                left.append(k)
    if left:
        LOGGER.info(f"importer: {len(left)} checkpoint keys not in the model (first: {left[:5]})")
    return hits, left


def load_torch_weights(model, path: str) -> Tuple[int, List[str]]:
    """``import_state_dict`` of the checkpoint at ``path``."""
    return import_state_dict(model, read_checkpoint(path))
