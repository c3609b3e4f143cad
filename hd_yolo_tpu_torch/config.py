"""Config plane: YAML model / hyp / data configs (port of ``hd_yolo_tpu/config.py``).

The package reads its own copies of the model and hyp YAMLs under
``configs/``.  A data YAML names the dataset's csv indexes (``train``,
``val``) and a ``meta_info`` mapping (or the path of a YAML holding it) of
per-task ``labels_text`` / ``labels_color``.
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


def load_dataset_info(data_cfg: Union[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Load a data YAML; resolve the nested per-task ``meta_info`` yaml if given as a path."""
    cfg = load_cfg(data_cfg)
    meta = cfg.get("meta_info")
    if isinstance(meta, str):
        cfg["meta_info"] = load_cfg(meta)
    return cfg


def save_cfg(cfg: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
