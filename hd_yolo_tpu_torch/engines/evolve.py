"""Hyperparameter evolution: GA mutation over the hyp plane (port of
``hd_yolo_tpu/engines/evolve.py``).

Per-key (gain, low, high) mutation metadata, parent selection among the
top results (single or weighted), sigma-scaled multiplicative mutation,
one ``evolve.csv`` row a generation.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import LOGGER

# key: (mutation gain, lower bound, upper bound)
META = {
    "lr0": (1.0, 1e-5, 0.1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "warmup_bias_lr": (1.0, 0.0, 0.2),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "cls_pw": (1.0, 0.5, 2.0),
    "obj": (1.0, 0.2, 4.0),
    "obj_pw": (1.0, 0.5, 2.0),
    "iou_t": (0.0, 0.1, 0.7),
    "anchor_t": (1.0, 2.0, 8.0),
    "fl_gamma": (0.0, 0.0, 2.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "perspective": (0.0, 0.0, 0.001),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
}


def mutate(hyp: Dict[str, float], results: List[Tuple[float, Dict[str, float]]],
           mp: float = 0.8, sigma: float = 0.2, parent: str = "single",
           rng: Optional[random.Random] = None) -> Dict[str, float]:
    """One GA mutation step."""
    rng = rng or random.Random()
    keys = [k for k in META if k in hyp and META[k][0] > 0]
    base = dict(hyp)
    if results:
        top = sorted(results, key=lambda r: -r[0])[:5]
        if parent == "single" or len(top) == 1:
            w = np.array([max(r[0], 1e-6) for r in top])
            pick = top[int(rng.choices(range(len(top)), weights=w)[0])][1]
            base.update({k: pick[k] for k in keys if k in pick})
        else:  # weighted combination
            w = np.array([max(r[0], 1e-6) for r in top])
            w = w / w.sum()
            for k in keys:
                vals = [r[1].get(k, hyp[k]) for r in top]
                base[k] = float(np.dot(w, vals))

    npr = np.random.default_rng(rng.randrange(2**31))
    v = np.ones(len(keys))
    while all(v == 1):
        g = np.array([META[k][0] for k in keys])
        v = ((npr.random(len(keys)) < mp) * npr.random() * npr.standard_normal(len(keys))
             * sigma * g + 1).clip(0.3, 3.0)
    out = dict(base)
    for k, f in zip(keys, v):
        lo, hi = META[k][1], META[k][2]
        out[k] = float(np.clip(float(base[k]) * f, lo, hi))
    return out


def evolve(
    train_fn: Callable[[Dict[str, float]], float],
    hyp: Dict[str, float],
    generations: int = 30,
    save_dir: str = "runs/evolve",
    seed: int = 0,
) -> Tuple[Dict[str, float], float]:
    """Run GA: train_fn(hyp) → fitness; returns (best_hyp, best_fitness).

    Appends every generation to ``evolve.csv``.
    """
    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(save_dir, "evolve.csv")
    rng = random.Random(seed)
    results: List[Tuple[float, Dict[str, float]]] = []
    best = (-1.0, dict(hyp))
    for gen in range(generations):
        cand = mutate(hyp, results, rng=rng) if gen > 0 else dict(hyp)
        fitness = float(train_fn(cand))
        results.append((fitness, cand))
        if fitness > best[0]:
            best = (fitness, cand)
        row = {"generation": gen, "fitness": fitness,
               **{k: cand.get(k) for k in META if k in cand}}
        write_header = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if write_header:
                w.writeheader()
            w.writerow(row)
        LOGGER.info(f"evolve gen {gen}: fitness={fitness:.4f} (best {best[0]:.4f})")
    return best[1], best[0]
