"""Faults planted in a cell's timed path (its served outputs rewritten as
they are produced), for the tests and for ``control.py``'s readings on the
card: each must come out ``correct`` false.  (A step that keeps its state
and the exchange between cards do not exist in one-card inference cells.)"""

import torch


def half_left_out(out, i):
    """Half of the request's work left out: the tiles of the second half of
    the batch, the right half of the slide, serve nothing."""
    if isinstance(out["boxes"], torch.Tensor):
        out = dict(out)
        B = out["valid"].shape[0]
        out["valid"] = out["valid"].clone()
        out["valid"][B // 2:] = False
        if "mask_valid" in out:
            out["mask_valid"] = out["mask_valid"].clone()
            out["mask_valid"][B // 2:] = False
            out["masks"] = out["masks"].clone()
            out["masks"][B // 2:] = 0
        return out
    keep = (out["boxes"][:, 0] + out["boxes"][:, 2]) / 2 < out_width(out) / 2
    return {k: v[keep] for k, v in out.items()}


def answer_altered(out, i):
    """One served detection's box moved by 16 px where it is produced."""
    out = dict(out)
    b = out["boxes"].clone() if isinstance(out["boxes"], torch.Tensor) else out["boxes"].copy()
    if b.ndim == 3:
        j = int(out["valid"][0].nonzero()[0])
        b[0, j] += 16
    else:
        b[0] += 16
    out["boxes"] = b
    return out


def out_width(out) -> float:
    """The served slide's width, as far as its boxes show it."""
    return float(out["boxes"][:, 2].max()) if len(out["boxes"]) else 0.0


FAULTS = {"half_left_out": half_left_out, "answer_altered": answer_altered}
