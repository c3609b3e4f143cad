"""The training step: forward, loss, backward, optimizer and EMA in one call
(port of ``hd_yolo_tpu/engines/train_step.py``).

Where the JAX step is a pure function of an immutable state, the port's
``TrainState`` holds the model (its parameters and buffers), the optimizer
(its state) and the EMA, and ``step(state, batch)`` updates them in place:
the model's BatchNorm running statistics in the forward, the parameters,
momentum and accumulation in ``Optimizer.update``, then the EMA.  The
metrics come back as 0-d device tensors: nothing in a step waits for the
card.  A model with drop path or dropout (``model.stochastic``: an
``hnet.HNet`` whose backbone has nonzero rates) seeds each step's generator
from ``(seed, step)``, as JAX folds the step into its dropout key; the step
reads the state's host copy of the count for that.

With ``augment_fn`` (``--device-augment``) the training recipe runs on
the step's device before the losses (``data/device_augment.py``), on
draws made on the host from the generator of ``(seed, step)``.  With
``resident_data`` (``--cache-device``) the step takes the whole raw-mode
set resident on the device and a (B,) row index, and gathers its batch
there: only the index and the draws go up each step.

The step takes the flagship ``Model`` and ``hnet.HNet`` alike: both have
``losses(images, targets, compute_masks)`` and ``total_loss(losses,
mask_weight)``.  The metrics follow JAX's rule: a task's ``loss_items``
where it has them (yolo), else its flat 0-d losses (hnet's headers and its
``constrains`` pseudo-task).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..data.device_augment import gather_rows
from .optim import EMA, Optimizer

Tensor = torch.Tensor


class TrainState:
    """step: 0-d int64 count of micro-steps on the model's device, with its
    host copy ``count`` (set with it, read by the step without a sync);
    model: the module (parameters and buffers); opt: its optimizer; ema: the
    EMA of its parameters."""

    def __init__(self, step: Tensor, model: nn.Module, opt: Optimizer, ema: EMA):
        self.model, self.opt, self.ema = model, opt, ema
        self.step = step

    @property
    def step(self) -> Tensor:
        return self._step

    @step.setter
    def step(self, value: Tensor) -> None:
        self._step = value
        self.count = int(value)

    def advance(self) -> None:
        """One micro-step more, on the device and on the host."""
        self._step = self._step + 1
        self.count += 1

    @classmethod
    def create(cls, model: nn.Module, opt: Optimizer) -> "TrainState":
        dev = opt.params[0].device
        return cls(step=torch.zeros((), dtype=torch.int64, device=dev), model=model, opt=opt,
                   ema=EMA(opt.params))


def to_device(batch: Dict, device) -> Dict:
    """A loader batch (numpy or tensors) as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=True)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The drop path / dropout generator of micro-step ``step``, seeded from
    ``(seed, step)``."""
    state = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def augment_rng(seed: int, step: int) -> np.random.Generator:
    """The host generator of micro-step ``step``'s augmentation draws."""
    return np.random.default_rng(np.random.SeedSequence([seed, step, 0x5EED]))


def augment_batch(augment_fn, batch: Dict, seed: int, step: int,
                  distributed: bool = False, group=None) -> Dict:
    """The device recipe on the raw ``batch`` of micro-step ``step``, its draws
    from ``augment_rng(seed, step)``.  ``distributed``: ``batch`` is this
    rank's rows of the global batch; the raw rows of every rank are gathered,
    the draws made for the global batch (the same on every rank) and this
    rank's rows of the result computed, so the mosaic and mixup partners come
    from the whole global batch, as on one device."""
    B, S = batch["image"].shape[:2]
    rows = None
    if distributed:
        batch = parallel.all_gather_rows(batch, group)
        r = torch.distributed.get_rank(group)
        rows = torch.arange(r * B, (r + 1) * B, device=batch["image"].device)
        B = batch["image"].shape[0]
    return augment_fn(batch, augment_fn.draw(augment_rng(seed, step), B, S), rows)


def loss_items(losses: Dict) -> Dict[str, Tensor]:
    """``'<task>/<item>'`` → detached 0-d loss: each task's ``loss_items``
    where it has them, else its flat 0-d entries."""
    items = {}
    for task, tl in losses.items():
        sub = tl.get("loss_items", tl) if isinstance(tl, dict) else {}
        for k, v in sub.items():
            if torch.is_tensor(v) and v.dim() == 0:
                items[f"{task}/{k}"] = v.detach()
    return items


def make_train_step(mask_weight: float = 1.0, ema_decay: float = 0.9999, seed: int = 0,
                    augment_fn=None, resident_data: bool = False, distributed: bool = False,
                    group=None):
    """``step(state, batch) → (state, metrics)``.  ``batch``: {'image': (B,
    H, W, 3) uint8 or float, 'targets': {task: {...}}} as tensors on the
    model's device (yolo: boxes, labels, masks, valid[, active]; hnet: each
    header's targets, ``loss_items``' rule above).  Metrics: the loss items
    and the total ``'loss'``.

    ``augment_fn``: a ``data/device_augment.DeviceAugment``, run on the raw
    batch with the micro-step's draws (``augment_rng``).  ``resident_data``:
    the signature becomes ``step(state, data, idx)``, ``data`` the whole set
    as one batch tree on the device, ``idx`` the (B,) rows of this step.

    ``distributed``: one step of the global batch over the default process
    group (``parallel``), each rank passing its own rows: the BatchNorm
    statistics and the losses' counts span the group
    (``parallel.global_batch``), so each rank's loss is its share of the
    global one; the gradients are summed over the group in buckets
    (``parallel.all_reduce_grads``) before the optimizer, and the metrics
    summed, so every rank updates identical tensors.  The device recipe
    draws for the global batch, gathers the raw rows of every rank and
    computes its own rows; hnet's drop path and dropouts draw for the global
    batch and keep this rank's rows (``parallel.draw_rows``).  ``group``: the
    process group the step spans (the default group where None; a mesh's
    ``data`` axis under ``parallel.make_mesh_train_step``).  Without a group
    it is the plain step."""

    def step(state: TrainState, batch: Dict) -> tuple:
        model, opt = state.model, state.opt
        model.train()
        dist_on = distributed and parallel.is_initialized()
        if augment_fn is not None:
            batch = augment_batch(augment_fn, batch, seed, state.count, dist_on, group)
        kw = {}
        if getattr(model, "stochastic", False):
            kw["generator"] = step_generator(seed, state.count, opt.params[0].device)
        with parallel.global_batch(group) if dist_on else contextlib.nullcontext():
            losses, _ = model.losses(batch["image"], batch["targets"],
                                     compute_masks=mask_weight > 0, **kw)
            total = model.total_loss(losses, mask_weight)
            grads = torch.autograd.grad(total, opt.params, allow_unused=True)
        metrics = loss_items(losses)
        metrics["loss"] = total.detach()
        if dist_on:
            grads = parallel.all_reduce_grads(grads, opt.params, group)
            metrics = _sum_metrics(metrics, group)
        opt.update(grads)
        state.ema.update(opt.params, decay=ema_decay)
        state.advance()
        return state, metrics

    if not resident_data:
        return step

    def resident_step(state: TrainState, data: Dict, idx) -> tuple:
        dev = data["image"].device
        idx = torch.as_tensor(idx, dtype=torch.int64)
        if idx.device != dev:
            idx = (idx.pin_memory() if dev.type == "cuda" else idx).to(dev, non_blocking=True)
        return step(state, gather_rows(data, idx))

    return resident_step


def _sum_metrics(metrics: Dict[str, Tensor], group=None) -> Dict[str, Tensor]:
    """The 0-d metrics summed over the process group, in one collective."""
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    torch.distributed.all_reduce(flat, group=group)
    return dict(zip(keys, flat.unbind()))


class swap_ema:
    """``with swap_ema(state):`` the model holds the EMA parameters (with its
    live BatchNorm statistics) inside the block and its own outside."""

    def __init__(self, state: TrainState):
        self.state = state

    @torch.no_grad()
    def __enter__(self):
        params = self.state.opt.params
        self.saved = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, self.state.ema.params)
        return self.state.model

    @torch.no_grad()
    def __exit__(self, *exc):
        torch._foreach_copy_(self.state.opt.params, self.saved)
        self.saved = None
        return False


def make_eval_step(compute_masks: bool = True, use_ema: bool = True):
    """``eval_step(state, images, targets=None)``: the eval-mode forward
    (running BatchNorm statistics), with the EMA parameters by default →
    (losses, outputs) with targets, else (``{}``, outputs)."""

    @torch.no_grad()
    def eval_step(state: TrainState, images: Tensor, targets: Optional[Dict] = None):
        model = state.model
        model.eval()
        if use_ema:
            with swap_ema(state):
                return _eval(model, images, targets, compute_masks)
        return _eval(model, images, targets, compute_masks)

    return eval_step


def _eval(model, images, targets, compute_masks):
    if targets is not None:
        return model.losses(images, targets, compute_masks=compute_masks)
    out = model(images, compute_masks=compute_masks)
    return out if isinstance(out, tuple) else ({}, out)    # hnet returns (losses, outputs)
