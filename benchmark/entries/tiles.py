"""``Detector.tiles`` on host uint8 batches: a closed loop with one client
over a pool of distinct batches; a batch completes when its outputs are
synchronised on the card."""

from __future__ import annotations

from typing import List

import torch

from entries import common
from reference.judge import RefTiles, judge_tiles
from reference.model import Prec
from reference.serve import serve_tiles


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.device = cfg, traffic, device
        B, S = traffic["batch"], cfg["input_size"]
        self.pool = common.host_pool((B, S, S, 3), traffic["pool"], seed, device)
        self.tag = None
        self.items, self.pixels = B, B * S * S

    def calibration_input(self) -> torch.Tensor:
        return torch.from_numpy(self.pool[0][: self.t["calibrate"]["tiles"]]).to(self.device)

    def build(self, state):
        det = common.detector(self.cfg, self.t.get("detector", {}), state, self.device)
        self.tag = det.model.spec.headers[0].tag
        return det

    def call(self, det, i: int):
        return det.tiles(self.pool[i % len(self.pool)])[self.tag]

    def done(self, out) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _x(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[i % len(self.pool)]).to(self.device)

    def judge(self, model, i: int, out, prec: Prec) -> dict:
        kw = self.cfg["detector"]
        ref = RefTiles(model, self.tag, self._x(i), kw["pre_nms_topk"], prec)
        return judge_tiles(ref, out, self.t.get("detector", {}).get("mask_budget"),
                           kw.get("mask_window", 16), prec)

    def serve_reference(self, model, i: int, prec: Prec):
        kw = self.cfg["detector"]
        return serve_tiles(model, self.tag, self._x(i), kw["pre_nms_topk"],
                           kw.get("max_masks", 100),
                           self.t.get("detector", {}).get("mask_budget"),
                           kw.get("mask_window", 16), prec)

    def mask_rois(self, outs: List, span_args: dict) -> float:
        """Mask ROIs served a request (the head's useful work), or 0."""
        n = [float(o["mask_valid"].sum()) for o in outs if "mask_valid" in o]
        return sum(n) / len(n) if n else 0.0
