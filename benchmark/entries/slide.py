"""``Detector.slide`` on host uint8 slides: a closed loop with one client
over a pool of distinct slides; a slide completes when ``Detector.slide``
returns (its rows are on the host)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from entries import common
from reference.judge import RefSlide, judge_slide
from reference.model import Prec
from reference.postprocess import tile_grid
from reference.serve import serve_slide


class Entry:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.t, self.device = cfg, traffic, device
        S = traffic["slide_px"]
        self.pool = common.host_pool((S, S, 3), traffic["pool"], seed, device)
        self.s = traffic["slide"]
        self.n_tiles = len(tile_grid(S, S, self.s["tile"], self.s["overlap"]))
        self.items, self.pixels = self.n_tiles, S * S
        self.tag = None

    def calibration_input(self) -> torch.Tensor:
        tile, n = self.s["tile"], self.t["calibrate"]["tiles"]
        org = tile_grid(*self.pool[0].shape[:2], tile, self.s["overlap"])[:n]
        return torch.from_numpy(np.stack([self.pool[0][y:y + tile, x:x + tile]
                                          for y, x in org])).to(self.device)

    def build(self, state):
        det = common.detector(self.cfg, self.t.get("detector", {}), state, self.device)
        self.tag = det.model.spec.headers[0].tag
        return det

    def call(self, det, i: int):
        kw = {k: v for k, v in self.s.items() if k in self.t["slide_args"]}
        return det.slide(self.pool[i % len(self.pool)], **kw).records[0][self.tag]

    def done(self, out) -> None:
        pass                                   # the rows are on the host already

    def _slide(self, i: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[i % len(self.pool)]).to(self.device)

    def judge(self, model, i: int, out, prec: Prec) -> dict:
        ref = RefSlide(model, self.tag, self._slide(i), self.s,
                       self.cfg["detector"]["pre_nms_topk"], prec)
        return judge_slide(ref, out, self.s, self.cfg["detector"].get("mask_window", 16), prec)

    def serve_reference(self, model, i: int, prec: Prec):
        return serve_slide(model, self.tag, self._slide(i), self.s,
                           self.cfg["detector"]["pre_nms_topk"],
                           self.cfg["detector"].get("mask_window", 16), prec)

    def mask_rois(self, outs: List, span_args: dict) -> float:
        """Mask ROIs a slide's real tiles carry (a valid detection in their
        first ``max_masks`` slots), from the mask branch's recorded ``valid``
        arguments; 0 where none were recorded."""
        valids = span_args.get("bench.masks", [])
        if not valids:
            return 0.0
        R = self.cfg["detector"].get("max_masks", 100)
        per_slide = -(-self.n_tiles // self.s["batch"])
        total = 0.0
        for j in range(0, len(valids) - per_slide + 1, per_slide):
            v = torch.cat([t[:, :R] for t in valids[j:j + per_slide]])[: self.n_tiles]
            total += float(v.sum())
        return total / max(1, len(valids) // per_slide)
