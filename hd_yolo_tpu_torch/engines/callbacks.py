"""Callback hook registry (port of ``hd_yolo_tpu/engines/callbacks.py``)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

HOOKS = (
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start", "on_val_batch_start", "on_val_image_end",
    "on_val_batch_end", "on_val_end",
    "on_fit_epoch_end", "on_model_save", "on_train_end",
    "on_params_update", "teardown",
)


class Callbacks:
    def __init__(self):
        self._callbacks: Dict[str, List[dict]] = {h: [] for h in HOOKS}
        self.stop_training = False

    def _check(self, hook: str) -> None:
        if hook not in self._callbacks:
            raise KeyError(f"hook {hook!r} not in {list(self._callbacks)}")

    def register_action(self, hook: str, name: str = "", callback: Optional[Callable] = None):
        self._check(hook)
        if not callable(callback):
            raise TypeError(f"callback {callback!r} is not callable")
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: Optional[str] = None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook: str, *args, **kwargs):
        self._check(hook)
        for logger in self._callbacks[hook]:
            logger["callback"](*args, **kwargs)
