"""Seeded weights made on the card, and the objectness calibration the plain
reference computes; both sides are then handed the same state dict."""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference import postprocess as pp
from reference.model import C3, Model as RefModel

Tensor = torch.Tensor


def ref_model(cfg: dict, device, state: Dict[str, Tensor] = None) -> RefModel:
    """The plain reference of ``cfg`` on ``device``: built on the meta
    device, then its tensors taken from ``state`` as they are (shared)."""
    with torch.device("meta"):
        m = RefModel(cfg["model"], cfg["hyp"])
    if state is not None:
        m.load_state_dict(state, strict=True, assign=True)
        m.to(device)
    return m.eval()


@torch.no_grad()
def seeded_state(cfg: dict, seed: int, device) -> Dict[str, Tensor]:
    """Every tensor of the configuration's state dict, from ``seed``, on
    ``device``, float32, in a few large draws: He-normal conv and deconv
    kernels, BatchNorm scale 1 (1 / sqrt(n) on the n residual branches of
    a C3), shift 0, running mean N(0, 0.1²), running variance
    U(0.75, 1.25), conv biases 0, and yolov5's Detect prior biases (objectness log(8 / cells),
    classes log(0.6 / (nc − 0.999999)))."""
    meta = ref_model(cfg, "meta")
    shapes = {k: v.shape for k, v in meta.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [k for k, s in shapes.items() if k.endswith("weight") and len(s) == 4]
    draw = torch.randn(sum(shapes[k].numel() for k in kernels), generator=gen, device=device)
    state, off = {}, 0
    for k in kernels:
        s = shapes[k]
        fan_in = s[0] * s[2] * s[3] if k.endswith("conv5_mask.weight") else s[1] * s[2] * s[3]
        state[k] = draw[off:off + s.numel()].view(s) * math.sqrt(2.0 / fan_in)
        off += s.numel()
    bn_mean = [k for k in shapes if k.endswith("running_mean")]
    n_bn = sum(shapes[k].numel() for k in bn_mean)
    means = torch.randn(n_bn, generator=gen, device=device) * 0.1
    varis = torch.rand(n_bn, generator=gen, device=device) * 0.5 + 0.75
    off = 0
    for k in bn_mean:
        n, p = shapes[k].numel(), k[: -len("running_mean")]
        state[k] = means[off:off + n]
        state[p + "running_var"] = varis[off:off + n]
        state[p + "weight"] = torch.ones(n, device=device)
        state[p + "bias"] = torch.zeros(n, device=device)
        state[p + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=device)
        off += n
    for k, s in shapes.items():
        if k not in state:
            state[k] = torch.zeros(s, device=device)
    # each residual branch enters its sum scaled by 1 / sqrt(n) (its last
    # BatchNorm's scale), n the bottlenecks of its C3: the sum's second
    # moment then grows at most e-fold along a C3, not 2^n-fold as with
    # unit scales, which leaves some seeds' logits in the thousands
    for name, mod in meta.named_modules():
        if isinstance(mod, C3):
            res = [j for j, b in enumerate(mod.m) if b.add]
            for j in res:
                state[f"{name}.m.{j}.cv2.bn.weight"].fill_(1.0 / math.sqrt(len(res)))
    for h in meta.hspecs:
        no = h["nc"] + 5
        for l, s in enumerate(h["strides"]):
            b = state[f"headers.{h['tag']}.m.{l}.bias"].view(h["na"], no)
            b[:, 4] = math.log(8.0 / (640.0 / s) ** 2)
            b[:, 5:] = math.log(0.6 / (h["nc"] - 0.999999))
    return state


def set_objectness(state: Dict[str, Tensor], h: dict, value: float) -> None:
    for l in range(len(h["strides"])):
        state[f"headers.{h['tag']}.m.{l}.bias"].view(h["na"], h["nc"] + 5)[:, 4] = value


# the objectness and class logits' spread over anchors, as a trained
# detector's (the seeded kernel's rows leave every logit within a few
# hundredths of its mean on these tiles, where bf16 rounding alone moves
# thousands of anchors over the threshold and flips labels)
OBJ_STD, CLS_STD, CLS_PCS, CLS_MEAN = 1.5, 1.0, 8, 3.0


@torch.no_grad()
def principal_rows(det, feats, h: dict) -> None:
    """The objectness and class rows of each level's det conv, from the
    principal directions of the level's features over ``feats`` (the
    directions in which they vary most over the tiles), each with the mean
    feature's direction taken out (so that no constant part cancels against
    the bias) and scaled to an output standard deviation of ``OBJ_STD`` or
    ``CLS_STD``: anchor a's objectness the a-th direction, its class c the
    (na + (a·nc + c) mod ``CLS_PCS``)-th, class c's bias ``CLS_MEAN`` − 0.05 c
    (classes that share a direction kept apart; the best class's
    probability near 1, so that a final score moves little where its label
    turns confident)."""
    nc, na = h["nc"], h["na"]
    no = nc + 5
    for conv, f in zip(det.m, feats):
        F0 = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1]).double()
        mu = F0.mean(0)
        X = F0 - mu
        _, evecs = torch.linalg.eigh(X.T @ X / X.shape[0])
        m = mu / mu.norm().clamp(min=1e-30)

        def row(k: int, std: float):
            v = evecs[:, -1 - k]
            v = v - v.dot(m) * m
            return (v * (std / float((X @ v).std().clamp(min=1e-30)))).to(conv.weight.dtype)

        for a in range(na):
            conv.weight[a * no + 4, :, 0, 0] = row(a, OBJ_STD)
            for c in range(nc):
                conv.weight[a * no + 5 + c, :, 0, 0] = row(na + (a * nc + c) % CLS_PCS, CLS_STD)
                conv.bias[a * no + 5 + c] = CLS_MEAN - 0.05 * c


@torch.no_grad()
def calibrate(model: RefModel, state: Dict[str, Tensor], x: Tensor, how: dict) -> dict:
    """Calibrate every Detect header (in ``state``, which ``model`` shares)
    on the reference's own float32 trunk on ``x``: the objectness and class
    rows (``principal_rows``), then the objectness bias of every anchor:
    ``{"frac": f}`` lifts a share ``f`` of all anchors over ``conf_thres``
    among those with a box of the 2-px minimum side; ``{"per_tile": n}``
    bisects that share until the reference's per-image NMS keeps about
    ``n`` detections a tile (their first ``max_masks`` slots carry a mask)."""
    out = {}
    for h in model.hspecs:
        det = model.headers[h["tag"]]
        set_objectness(state, h, 0.0)
        feats = model.trunk(x)
        lv = [feats[j] for j in h["from"]]
        del feats
        principal_rows(det, lv, h)
        logits = det.det_logits(lv)
        dense = pp.decode(h, logits)
        raw = torch.cat([d[..., 4].reshape(d.shape[0], -1) for d in logits], 1)    # bias 0
        b = dense["boxes"]
        big = ((b[..., 2] - b[..., 0]) >= pp.MIN_BOX) & ((b[..., 3] - b[..., 1]) >= pp.MIN_BOX)
        flat = raw[big].float()
        conf = h["conf_thres"]
        logit_conf = math.log(conf / (1 - conf))

        def bias_for(frac: float) -> float:
            share = min(1.0, frac * raw.numel() / max(flat.numel(), 1))
            k = max(1, min(flat.numel(), int(round((1.0 - share) * flat.numel()))))
            return logit_conf - float(flat.kthvalue(k).values)

        def kept(bias: float) -> float:
            d = dict(dense, obj=torch.sigmoid(raw + bias))
            a = pp.per_image_nms(h, d, how.get("topk", 1024))["anchor"]
            return float((a[:, : how.get("max_masks", a.shape[1])] >= 0).sum()) / x.shape[0]

        if "frac" in how:
            frac = how["frac"]
            bias = bias_for(frac)
            n = kept(bias)
        else:
            lo, hi = 1e-5, 0.05
            for _ in range(14):
                frac = math.sqrt(lo * hi)
                bias = bias_for(frac)
                n = kept(bias)
                if abs(n - how["per_tile"]) <= 1.5:
                    break
                lo, hi = (frac, hi) if n < how["per_tile"] else (lo, frac)
        set_objectness(state, h, bias)
        out[h["tag"]] = {"frac": frac, "bias": bias, "per_tile": n}
    return out
