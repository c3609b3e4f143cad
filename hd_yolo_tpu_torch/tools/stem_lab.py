"""Stem formulation lab (port of ``tools/stem_lab.py``): time every
formulation of the flagship stem on the card.

The flagship stem, ``Conv(3, 64, 6, 2, 2)`` with its inference BatchNorm
folded to a per-channel affine, computes ``silu(conv6x6/s2/p2(x) * scale +
bias)`` at (B, 640, 640, 3) f32 → (B, 320, 320, 64) bf16.  Candidates, all
with bf16 operands and f32 accumulation:

  direct         cuDNN conv on the NHWC bytes (channels-last), as the model
                 would run it without a kernel of its own
  direct_bf16in  the same with x cast to bf16 first
  direct_nchw    a real NCHW transpose, conv, transpose back
  merged_in      x through a (B, H, W*3) view first (free in torch)
  s2d            pad + space-to-depth(2) → dense 3x3 conv over 12 channels
  im2col         s2d + 9-tap concat (K = 108) → one matmul
  stem_cu        ``ops/pallas_stem.stem_conv(form="direct")``: the direct
                 stem kernel (the family's tensor-core kernel, ``kernels/stem.cu``)
  stem_k108      ``stem_k108``: the K=108 tensor-core product in the s2d
                 tap-major K order, image rows streamed through a
                 shared-memory ring (``kernels/stem_k108.cu``)
  stem_dot108    ``stem_dot108``: torch builds the K=108 im2col, the kernel
                 does the product + BN + SiLU (``kernels/stem_dot108.cu``)
  stem_tc        ``ops/pallas_stem.stem_conv(form="tc")``: the trunk's bf16
                 stem, image rows streamed through a shared-memory ring +
                 one K=108 tensor-core product (``kernels/stem_tc.cu``)

Run::

    python -m hd_yolo_tpu_torch.tools.stem_lab [--batch 16 --img 640 --iters 50 --only a,b]

It prints one JSON line per candidate: ``name``, ``ms_per_batch`` (CUDA
events on the card, the host clock with ``--device cpu``), ``max_abs_err``
against the plain f32-accumulating version, and ``device``.  A failing
candidate raises.

This module also holds the wrappers of kernels 6 and 7 and their shared
plain version (``dot108_plain``): on a CUDA tensor a wrapper launches its
kernel, on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..ops import pallas_stem

Tensor = torch.Tensor

K, S, P, CIN, N = 6, 2, 2, 3, 64
KS = K // S          # dense tap grid after space-to-depth
CS = S * S * CIN     # s2d channels
KDIM = KS * KS * CS  # 108


def out_size(n: int) -> int:
    """Output rows (or columns) of the 6x6/s2/p2 conv over ``n`` input rows."""
    return (n + 2 * P - K) // S + 1


def s2d(x: Tensor) -> Tensor:
    """Pad + space-to-depth(2): (B, H, W, 3) → (B, Ho + 2, Wo + 2, 12) bf16;
    channel (dy * 2 + dx) * 3 + c of (r, q) is x[2r + dy - 2, 2q + dx - 2, c]."""
    B, H, W, C = x.shape
    hs, ws = out_size(H) + KS - 1, out_size(W) + KS - 1
    xp = F.pad(x, (0, 0, P, S * ws - W - P, P, S * hs - H - P))
    return (xp.reshape(B, hs, S, ws, S, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(B, hs, ws, S * S * C).to(torch.bfloat16))


def w_dense(w: Tensor) -> Tensor:
    """(6, 6, 3, N) → (3, 3, 12, N) bf16: the dense tap weights in s2d space."""
    n = w.shape[-1]
    return (w.reshape(KS, S, KS, S, CIN, n).permute(0, 2, 1, 3, 4, 5)
            .reshape(KS, KS, CS, n).to(torch.bfloat16))


def w_108(w: Tensor) -> Tensor:
    """(6, 6, 3, N) → (108, N) bf16, tap-major rows."""
    return w_dense(w).reshape(KDIM, -1)


def im2col108(xs: Tensor, hout: int, wout: int) -> Tensor:
    """(B, Ho + 2, Wo + 2, 12) s2d → (B, Ho, Wo, 108): the 9 taps concatenated."""
    return torch.cat([xs[:, ky:ky + hout, kx:kx + wout] for ky in range(KS) for kx in range(KS)],
                     -1)


def dot108_plain(cols: Tensor, w108: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """silu(cols · w108 * scale + bias) → bf16: the products of the bf16
    operands in f32 (exact), f32 accumulation, affine and SiLU in f32."""
    acc = cols.float() @ w108.float()
    return F.silu(acc * scale.float() + bias.float()).to(torch.bfloat16)


def stem_k108_plain(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """The plain version of kernels 6 and 7: (B, H, W, 3) f32 → (B, Ho, Wo, N) bf16."""
    cols = im2col108(s2d(x), out_size(x.shape[1]), out_size(x.shape[2]))
    return dot108_plain(cols, w_108(w), scale, bias)


def _check(x: Tensor, w: Tensor) -> None:
    if (x.dim() != 4 or x.shape[-1] != CIN or x.dtype != torch.float32
            or tuple(w.shape) != (K, K, CIN, N)):
        raise ValueError(f"the K=108 stem kernels take x (B, H, W, 3) f32 and w (6, 6, 3, 64), "
                         f"got x {tuple(x.shape)} {x.dtype}, w {tuple(w.shape)}")


def stem_k108(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """silu(conv6x6/s2/p2(x) * scale + bias) as one K=108 product per pixel
    in the s2d tap-major K order: kernel 6 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return stem_k108_plain(x, w, scale, bias)
    _check(x, w)
    B, H, W, _ = x.shape
    x = x.contiguous()
    w = w.float().contiguous()        # the kernel stages w_108's rows from it, in bf16
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    kernels.require_cuda(x, w, scale, bias)
    y = torch.empty((B, out_size(H), out_size(W), N), dtype=torch.bfloat16, device=x.device)
    dev, stream = kernels.device_and_stream(x)
    code = kernels.fn("stem_k108")(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                                   bias.data_ptr(), y.data_ptr(), B, H, W, y.shape[1],
                                   y.shape[2], dev, stream)
    kernels.check(code, "stem_k108")
    kernels.LAUNCHES["stem_k108"] += 1
    return y


def dot108(cols: Tensor, w108: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """silu(cols · w108 * scale + bias) over a (..., 108) bf16 im2col: kernel
    7 on a CUDA tensor, the plain version on a CPU tensor."""
    if cols.device.type == "cpu":
        return dot108_plain(cols, w108, scale, bias)
    if (cols.shape[-1] != KDIM or cols.dtype != torch.bfloat16 or tuple(w108.shape) != (KDIM, N)
            or w108.dtype != torch.bfloat16):
        raise ValueError(f"dot108 takes a (..., 108) bf16 im2col and (108, 64) bf16 weights, "
                         f"got {tuple(cols.shape)} {cols.dtype}, {tuple(w108.shape)} {w108.dtype}")
    cols, w108 = cols.contiguous(), w108.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    kernels.require_cuda(cols, w108, scale, bias)
    if cols.data_ptr() % 16:
        raise ValueError("dot108 needs a 16-byte aligned im2col")
    y = torch.empty(cols.shape[:-1] + (N,), dtype=torch.bfloat16, device=cols.device)
    dev, stream = kernels.device_and_stream(cols)
    code = kernels.fn("stem_dot108")(cols.data_ptr(), w108.data_ptr(), scale.data_ptr(),
                                     bias.data_ptr(), y.data_ptr(), cols.numel() // KDIM, dev,
                                     stream)
    kernels.check(code, "stem_dot108")
    kernels.LAUNCHES["stem_dot108"] += 1
    return y


def stem_dot108(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """The stem with torch building the K=108 im2col and kernel 7 taking the
    product (the plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        return stem_k108_plain(x, w, scale, bias)
    _check(x, w)
    cols = im2col108(s2d(x), out_size(x.shape[1]), out_size(x.shape[2]))
    return dot108(cols, w_108(w), scale, bias)


# ---------------------------------------------------------------- candidates
def _affine_silu_nchw(y: Tensor, sc: Tensor, bi: Tensor) -> Tensor:
    return F.silu(y.float() * sc[:, None, None] + bi[:, None, None]).to(torch.bfloat16)


def direct(x, w, sc, bi):
    xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)          # NCHW view of the NHWC bytes
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(torch.bfloat16), stride=S, padding=P)
    return _affine_silu_nchw(y, sc, bi).permute(0, 2, 3, 1)


def direct_bf16in(x, w, sc, bi):
    return direct(x.to(torch.bfloat16), w, sc, bi)


def direct_nchw(x, w, sc, bi):
    xt = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
    y = F.conv2d(xt, w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(), stride=S, padding=P)
    return _affine_silu_nchw(y, sc, bi).permute(0, 2, 3, 1).contiguous()


def merged_in(x, w, sc, bi):
    B, H, W, C = x.shape
    return direct(x.to(torch.bfloat16).reshape(B, H, W * C).reshape(B, H, W, C), w, sc, bi)


def s2d_conv(x, w, sc, bi):
    xs = s2d(x).permute(0, 3, 1, 2)
    y = F.conv2d(xs, w_dense(w).permute(3, 2, 0, 1))
    return _affine_silu_nchw(y, sc, bi).permute(0, 2, 3, 1)


def im2col(x, w, sc, bi):
    cols = im2col108(s2d(x), out_size(x.shape[1]), out_size(x.shape[2]))
    y = torch.matmul(cols, w_108(w))
    return F.silu(y.float() * sc + bi).to(torch.bfloat16)


def stem_cu(x, w, sc, bi):
    return pallas_stem.stem_conv(x, w, sc, bi, stride=S, padding=P, out_dtype=torch.bfloat16,
                                 form="direct")


def stem_tc(x, w, sc, bi):
    return pallas_stem.stem_conv(x, w, sc, bi, stride=S, padding=P, out_dtype=torch.bfloat16,
                                 form="tc")


CANDIDATES: Dict[str, Callable] = {
    "direct": direct,
    "direct_bf16in": direct_bf16in,
    "direct_nchw": direct_nchw,
    "merged_in": merged_in,
    "s2d": s2d_conv,
    "im2col": im2col,
    "stem_cu": stem_cu,
    "stem_k108": stem_k108,
    "stem_dot108": stem_dot108,
    "stem_tc": stem_tc,
}


def reference(x, w, sc, bi):
    """The plain f32-accumulating stem on bf16-rounded operands."""
    return pallas_stem.stem_conv_plain(x, w, sc, bi, stride=S, padding=P,
                                       out_dtype=torch.bfloat16)


def inputs(batch: int, img: int, device, seed: int = 0):
    """The lab's inputs, from numpy with ``seed`` (the JAX lab's draws)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, img, img, CIN)).astype(np.float32)
    w = (rng.standard_normal((K, K, CIN, N)) * 0.05).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, (N,)).astype(np.float32)
    bi = rng.uniform(-0.1, 0.1, (N,)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, w, sc, bi)]


def time_ms(fn: Callable[[], Tensor], iters: int, device: torch.device) -> float:
    """Median milliseconds of ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(name: str, fn: Callable, args: List[Tensor], want: Tensor, iters: int,
        device: torch.device) -> dict:
    y = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if y.shape != want.shape or y.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: got {tuple(y.shape)} {y.dtype}, want "
                             f"{tuple(want.shape)} bf16")
    err = float((y.float() - want.float()).abs().max())
    ms = time_ms(lambda: fn(*args), iters, device)
    rec = {"name": name, "ms_per_batch": ms, "max_abs_err": err, "device": device.type}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--img", type=int, default=640)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default="", help="comma-separated candidate names")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    from ..detector import resolve_device

    device = resolve_device(a.device)
    todo = [n for n in a.only.split(",") if n] or list(CANDIDATES)
    unknown = sorted(set(todo) - set(CANDIDATES))
    if unknown:
        raise SystemExit(f"unknown candidates {unknown}; choose from {list(CANDIDATES)}")
    if device.type == "cuda":
        # the reference is a full-f32 conv of bf16-rounded operands
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    args = inputs(a.batch, a.img, device)
    want = reference(*args)
    return [run(n, CANDIDATES[n], args, want, a.iters, device) for n in todo]


if __name__ == "__main__":
    main(sys.argv[1:])
