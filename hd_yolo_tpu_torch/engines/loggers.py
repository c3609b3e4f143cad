"""Training loggers: console, ``results.json`` (json lines) and
``results.csv``, plus TensorBoard scalars when ``use_tb`` and
``torch.utils.tensorboard`` imports (port of
``hd_yolo_tpu/engines/loggers.py``)."""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict

from .. import LOGGER
from .callbacks import Callbacks


class Loggers:
    def __init__(self, save_dir: str, use_csv: bool = True, use_tb: bool = False):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.json_path = os.path.join(save_dir, "results.json")
        self.csv_path = os.path.join(save_dir, "results.csv") if use_csv else None
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:       # TensorBoard is optional
                LOGGER.warning(f"TensorBoard unavailable: {e}")
            else:
                self.tb = SummaryWriter(save_dir)

    def register(self, callbacks: Callbacks):
        callbacks.register_action("on_fit_epoch_end", "loggers", self.on_fit_epoch_end)
        callbacks.register_action("on_train_end", "loggers", self.on_train_end)

    def on_fit_epoch_end(self, vals: Dict[str, Any], epoch: int, best_fitness: float = 0.0,
                         fitness: float = 0.0):
        row = {"epoch": epoch, **{k: _tofloat(v) for k, v in vals.items()}}
        with open(self.json_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.csv_path:
            write_header = not os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(row))
                if write_header:
                    w.writeheader()
                w.writerow(row)
        if self.tb:
            for k, v in row.items():
                if k != "epoch":
                    self.tb.add_scalar(k, v, epoch)

    def on_train_end(self, *args, **kwargs):
        if self.tb:
            self.tb.flush()


def _tofloat(v) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")
