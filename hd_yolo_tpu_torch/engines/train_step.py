"""The training step: forward, loss, backward, optimizer and EMA in one call
(port of ``hd_yolo_tpu/engines/train_step.py``).

Where the JAX step is a pure function of an immutable state, the port's
``TrainState`` holds the model (its parameters and buffers), the optimizer
(its state) and the EMA, and ``step(state, batch)`` updates them in place:
the model's BatchNorm running statistics in the forward, the parameters,
momentum and accumulation in ``Optimizer.update``, then the EMA.  The
metrics come back as 0-d device tensors: nothing in a step waits for the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from .optim import EMA, Optimizer

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    """step: 0-d int64 count of micro-steps; model: the module (parameters and
    buffers); opt: its optimizer; ema: the EMA of its parameters."""

    step: Tensor
    model: nn.Module
    opt: Optimizer
    ema: EMA

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


def make_train_step(mask_weight: float = 1.0, ema_decay: float = 0.9999):
    """``step(state, batch) → (state, metrics)``.  ``batch``: {'image': (B,
    H, W, 3) uint8 or float, 'targets': {task: {boxes, labels, masks, valid[,
    active]}}} as tensors on the model's device.  Metrics: each task's loss
    items as ``'<task>/<item>'`` and the total ``'loss'``."""

    def step(state: TrainState, batch: Dict) -> tuple:
        model, opt = state.model, state.opt
        model.train()
        losses, _ = model.losses(batch["image"], batch["targets"], compute_masks=mask_weight > 0)
        total = model.total_loss(losses, mask_weight)
        grads = torch.autograd.grad(total, opt.params, allow_unused=True)
        opt.update(grads)
        state.ema.update(opt.params, decay=ema_decay)
        state.step = state.step + 1
        metrics = {f"{task}/{k}": v for task, tl in losses.items()
                   for k, v in tl["loss_items"].items()}
        metrics["loss"] = total.detach()
        return state, metrics

    return step


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
    if targets is None:
        return {}, model(images, compute_masks=compute_masks)
    return model.losses(images, targets, compute_masks=compute_masks)
