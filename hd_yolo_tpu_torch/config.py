"""Config plane: YAML model/hyp configs (port of ``hd_yolo_tpu/config.py``).

The package reads its own copies of the YAMLs under ``configs/``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Union

import yaml

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CONFIG_DIR = os.path.join(_PKG_DIR, "configs")


def load_cfg(cfg: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Load a YAML config by path / bare name (searched in configs/), or pass a dict through."""
    if isinstance(cfg, dict):
        return copy.deepcopy(cfg)
    path = cfg
    if not os.path.isfile(path):
        cand = os.path.join(CONFIG_DIR, path if path.endswith((".yaml", ".yml")) else path + ".yaml")
        if os.path.isfile(cand):
            path = cand
    with open(path, "r", errors="ignore") as f:
        return yaml.safe_load(f)
