"""Optimizer, LR schedules, warmup and EMA (port of
``hd_yolo_tpu/engines/optim.py``, which builds them from optax).

* Param groups by module type (``label_params``): the scales of the
  normalization layers (BatchNorm, LayerNorm, GroupNorm: every flax
  ``scale``) ``bn_scale``, every bias ``bias``, every other weight ``kernel``, and
  parameters whose name holds a ``--freeze`` substring ``frozen``.  SGD with
  nesterov momentum (weight decay on kernels only, added to the gradient),
  or Adam / AdamW (decoupled decay) with b1 = ``momentum``.
* Per-update warmup of the lr (the bias group ramps down from
  ``warmup_bias_lr``, the others up from 0) and of the momentum, and the
  linear / cosine epoch factor (``make_lr_schedules``).  As in the JAX
  package, the schedules count applied updates: the count lives inside the
  accumulation (optax ``MultiSteps``), so with ``accumulate`` k a loader
  epoch advances them by steps/k.
* ``accumulate`` k: the mean of k micro-batch gradients, in optax's running
  form ``acc + (g − acc)/(i + 1)``, applied every k-th micro-step.
* ``skip_nonfinite``: a micro-step whose gradient holds inf / NaN leaves the
  parameters, the momentum and the accumulation untouched (optax
  ``apply_if_finite``; after more than 100 such steps in a row the update is
  applied).
* ``clip_grad_norm`` > 0: the accumulated gradient clipped to that global norm.
* EMA of the parameters (not the buffers), updated every micro-step with the
  decay ramp ``decay·(1 − exp(−updates/tau))``.

Everything stays on the device: the finite check, the schedules and the
gating are tensor operations (no host synchronisation in a step), and the
update runs as multi-tensor (``torch._foreach_*``) operations.  The
parameters are updated in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

Tensor = torch.Tensor

DEFAULT_HYP = {
    "lr0": 0.01, "lrf": 0.1, "momentum": 0.937, "weight_decay": 0.0005,
    "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
    "clip_grad_norm": 0.0,   # global grad-norm clip; 0 disables
}
GROUPS = ("kernel", "bn_scale", "bias", "frozen")
NORMS = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm, nn.GroupNorm)
MAX_CONSECUTIVE_ERRORS = 100


def one_cycle(y1: float = 1.0, y2: float = 1.0, steps: int = 100) -> Callable[[float], float]:
    """Cosine ramp from y1 to y2 over steps."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def linear_lf(lrf: float, epochs: int) -> Callable[[float], float]:
    """Linear decay factor."""
    return lambda x: (1 - x / max(epochs - 1, 1)) * (1.0 - lrf) + lrf


def _hyp(hyp: dict) -> dict:
    return {**DEFAULT_HYP, **{k: v for k, v in hyp.items() if k in DEFAULT_HYP}}


def label_params(model: nn.Module, freeze: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """{parameter name: group}: the weight of a normalization layer
    (BatchNorm, LayerNorm, GroupNorm, whose flax parameter is ``scale``) is
    ``bn_scale``, every bias ``bias``, every other weight ``kernel``; a name
    holding any ``freeze`` substring is ``frozen``."""
    labels = {}
    for mod_name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if freeze and any(f in name for f in freeze):
                labels[name] = "frozen"
            elif isinstance(mod, NORMS) and pname == "weight":
                labels[name] = "bn_scale"
            elif pname.endswith("bias"):        # also attention's in_proj_bias
                labels[name] = "bias"
            else:
                labels[name] = "kernel"
    return labels


def make_lr_schedules(hyp: Dict[str, float], epochs: int, steps_per_epoch: int,
                      schedule: str = "linear"):
    """(lr_main, lr_bias, momentum) as functions of the update count (a
    Python number or a 0-d tensor).  Warmup spans ``nw = max(warmup_epochs
    · steps_per_epoch, 100)`` counts; the epoch factor steps every
    ``steps_per_epoch`` counts."""
    hyp = _hyp(hyp)
    lr0, lrf = hyp["lr0"], hyp["lrf"]
    lf = one_cycle(1, lrf, epochs) if schedule == "cosine" else linear_lf(lrf, epochs)
    nw = max(round(hyp["warmup_epochs"] * steps_per_epoch), 100)
    table = [lf(e) for e in range(max(epochs, 1))]
    tables: Dict[torch.device, Tensor] = {}

    def base_lr(step):
        if torch.is_tensor(step):
            t = tables.get(step.device)
            if t is None:
                t = tables[step.device] = torch.tensor(table, dtype=torch.float32,
                                                       device=step.device)
            epoch = torch.clamp(torch.div(step, steps_per_epoch, rounding_mode="floor"),
                                max=epochs - 1).long()
            return lr0 * t[epoch]
        return lr0 * table[min(int(step) // steps_per_epoch, epochs - 1)]

    def ramp(step):
        if torch.is_tensor(step):
            return torch.clamp(step.float() / nw, 0.0, 1.0)
        return min(max(float(step) / nw, 0.0), 1.0)

    def lr_main(step):
        return base_lr(step) * ramp(step)

    def lr_bias(step):
        w = ramp(step)
        warm = hyp["warmup_bias_lr"] * (1 - w) + base_lr(step) * w
        if torch.is_tensor(step):
            return torch.where(step < nw, warm, base_lr(step))
        return warm if step < nw else base_lr(step)

    def momentum(step):
        w = ramp(step)
        return hyp["warmup_momentum"] * (1 - w) + hyp["momentum"] * w

    return lr_main, lr_bias, momentum


class Optimizer:
    """The JAX package's optimizer chain over a model's parameters, updated
    in place: ``skip_nonfinite(accumulate(clip(per-group SGD | Adam)))``.

    ``update(grads)`` takes one micro-step's gradients (in ``self.params``
    order, None = zero).  State (all tensors on the parameters' device):
    ``count`` (applied updates, the schedules' step), ``mini_step``,
    ``notfinite``, and per parameter ``acc`` (k > 1), ``trace`` (SGD
    momentum or Adam's first moment) and ``nu`` (Adam)."""

    def __init__(self, model: nn.Module, hyp: Dict[str, float], epochs: int, steps_per_epoch: int,
                 schedule: str = "linear", accumulate: int = 1,
                 freeze: Optional[Sequence[str]] = None, skip_nonfinite: bool = True,
                 optimizer: str = "sgd"):
        self.hyp = _hyp(hyp)
        self.kind = optimizer.lower()
        if self.kind not in ("sgd", "adam", "adamw"):
            raise ValueError(f"optimizer must be sgd, adam or adamw, got {optimizer!r}")
        self.k = max(int(accumulate), 1)
        self.skip_nonfinite = skip_nonfinite
        self.labels = label_params(model, freeze)
        named = dict(model.named_parameters())
        self.names = list(self.labels)
        self.params: List[Tensor] = [named[n] for n in self.names]
        self.schedules = make_lr_schedules(self.hyp, epochs, steps_per_epoch, schedule)
        dev = self.params[0].device
        z = lambda dt: torch.zeros((), dtype=dt, device=dev)
        self.state: Dict[str, object] = {
            "count": z(torch.int64), "mini_step": z(torch.int64), "notfinite": z(torch.int64),
            "trace": [torch.zeros_like(p) for p in self.params],
        }
        if self.kind != "sgd":
            self.state["nu"] = [torch.zeros_like(p) for p in self.params]
        if self.k > 1:
            self.state["acc"] = [torch.zeros_like(p) for p in self.params]
        self.last = {}     # the hyperparameters of the last micro-step, 0-d tensors

        self.groups = {grp: [i for i, n in enumerate(self.names) if self.labels[n] == grp]
                       for grp in GROUPS}

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[Tensor]]) -> Tensor:
        """One micro-step; returns the 0-d bool "gradient was finite"."""
        st = self.state
        clip = float(self.hyp["clip_grad_norm"])
        g = [torch.zeros_like(p) if t is None else t.to(p.dtype) for p, t in zip(self.params, grads)]
        norms = torch._foreach_norm(g)
        finite = torch.isfinite(torch.stack(norms)).all()
        if self.skip_nonfinite:
            st["notfinite"] = torch.where(finite, torch.zeros_like(st["notfinite"]),
                                          st["notfinite"] + 1)
            advance = finite | (st["notfinite"] > MAX_CONSECUTIVE_ERRORS)
        else:
            advance = torch.ones_like(finite)
        # a rejected micro-step changes no state: its gradient enters as 0 and
        # every state change below is gated by `advance`
        zero = torch.zeros((), dtype=g[0].dtype, device=g[0].device)
        g = [torch.where(advance, t, zero) for t in g]
        adv = advance.to(g[0].dtype)
        if self.k > 1:
            acc = st["acc"]
            n = (st["mini_step"] + 1).to(g[0].dtype)
            delta = torch._foreach_sub(g, acc)
            torch._foreach_div_(delta, n)
            torch._foreach_mul_(delta, adv)
            torch._foreach_add_(acc, delta)
            emit = advance & (st["mini_step"] == self.k - 1)
            st["mini_step"] = torch.where(advance, (st["mini_step"] + 1) % self.k,
                                          st["mini_step"])
            g = [a.clone() for a in acc] if clip > 0 else list(acc)
        else:
            emit = advance
        emit_f = emit.to(g[0].dtype)
        if clip > 0:
            gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            scale = torch.where(gn < clip, torch.ones_like(gn), clip / gn)
            torch._foreach_mul_(g, scale)

        lr_main, lr_bias, mom_fn = self.schedules
        count = st["count"]
        lrs = {"kernel": lr_main(count), "bn_scale": lr_main(count), "bias": lr_bias(count)}
        mom = mom_fn(count)
        self.last = {"lr_kernel": lrs["kernel"], "lr_bias": lrs["bias"], "momentum": mom}
        wd = float(self.hyp["weight_decay"])
        for grp in ("kernel", "bn_scale", "bias"):
            idx = self.groups[grp]
            if not idx:
                continue
            p = [self.params[i] for i in idx]
            u = [g[i] for i in idx]
            tr = [st["trace"][i] for i in idx]
            if self.kind == "sgd":
                if grp == "kernel" and wd:
                    u = torch._foreach_add(u, p, alpha=wd)
                # trace ← u + m·trace ; step = u + m·trace (nesterov)
                new_tr = torch._foreach_mul(tr, mom)
                torch._foreach_add_(new_tr, u)
                step = torch._foreach_mul(new_tr, mom)
                torch._foreach_add_(step, u)
                self._gated_set(tr, new_tr, emit_f)
            else:
                b1, b2, eps = float(self.hyp["momentum"]), 0.999, 1e-8
                if grp == "kernel" and wd and self.kind == "adam":
                    u = torch._foreach_add(u, p, alpha=wd)
                nu = [st["nu"][i] for i in idx]
                new_mu = torch._foreach_mul(u, 1 - b1)
                torch._foreach_add_(new_mu, torch._foreach_mul(tr, b1))
                new_nu = torch._foreach_mul(torch._foreach_mul(u, u), 1 - b2)
                torch._foreach_add_(new_nu, torch._foreach_mul(nu, b2))
                c = (count + 1).to(g[0].dtype)
                mu_hat = torch._foreach_div(new_mu, 1 - b1 ** c)
                nu_hat = torch._foreach_div(new_nu, 1 - b2 ** c)
                den = torch._foreach_sqrt(nu_hat)
                torch._foreach_add_(den, eps)
                step = torch._foreach_div(mu_hat, den)
                if grp == "kernel" and wd and self.kind == "adamw":
                    torch._foreach_add_(step, p, alpha=wd)
                self._gated_set(tr, new_mu, emit_f)
                self._gated_set(nu, new_nu, emit_f)
            torch._foreach_mul_(step, -lrs[grp] * emit_f)
            torch._foreach_add_(p, step)
        if self.k > 1:
            torch._foreach_mul_(st["acc"], 1.0 - emit_f)
        st["count"] = count + emit.long()
        return finite

    @staticmethod
    def _gated_set(dst: List[Tensor], new: List[Tensor], gate: Tensor) -> None:
        """dst ← new where ``gate`` is 1, unchanged where it is 0 (finite values)."""
        delta = torch._foreach_sub(new, dst)
        torch._foreach_mul_(delta, gate)
        torch._foreach_add_(dst, delta)

    def state_dict(self) -> Dict[str, object]:
        return {k: (v.detach().cpu() if torch.is_tensor(v) else [t.detach().cpu() for t in v])
                for k, v in self.state.items()}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, object]) -> None:
        for k, v in self.state.items():
            if torch.is_tensor(v):
                self.state[k] = sd[k].to(v.device, v.dtype).reshape(v.shape)
            else:
                for dst, src in zip(v, sd[k]):
                    dst.copy_(src)


def build_optimizer(model: nn.Module, hyp: Dict[str, float], epochs: int, steps_per_epoch: int,
                    schedule: str = "linear", accumulate: int = 1,
                    freeze: Optional[list] = None, skip_nonfinite: bool = True,
                    optimizer: str = "sgd") -> Optimizer:
    """The training optimizer of ``model`` (see ``Optimizer``)."""
    return Optimizer(model, hyp, epochs, steps_per_epoch, schedule, accumulate, freeze,
                     skip_nonfinite, optimizer)


class EMA:
    """Exponential moving average of parameters: ``params`` (copies, f32)
    and ``updates`` (a 0-d device counter)."""

    def __init__(self, params: Sequence[Tensor]):
        self.params = [p.detach().clone() for p in params]
        self.updates = torch.zeros((), dtype=torch.int64, device=self.params[0].device)

    @torch.no_grad()
    def update(self, params: Sequence[Tensor], decay: float = 0.9999, tau: float = 2000.0) -> None:
        self.updates = self.updates + 1
        d = decay * (1.0 - torch.exp(-self.updates.float() / tau))
        torch._foreach_mul_(self.params, d)
        torch._foreach_add_(self.params, torch._foreach_mul([p.detach() for p in params], 1.0 - d))


def ema_init(params: Sequence[Tensor]) -> EMA:
    return EMA(params)


def ema_update(ema: EMA, params: Sequence[Tensor], decay: float = 0.9999,
               tau: float = 2000.0) -> EMA:
    ema.update(params, decay, tau)
    return ema
