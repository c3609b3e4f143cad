"""Stem convolution on the card: wrapper of ``kernels/stem.cu`` (the Hopper
port of ``hd_yolo_tpu/ops/pallas_stem.py``).

``stem_conv(x, w, scale, bias, stride=, padding=, out_dtype=)`` computes
``silu(conv2d(x, w, stride, padding) * scale + bias)`` in NHWC, the yolov5
stem with its inference BatchNorm folded to a per-channel affine.
Matmul inputs are rounded to the compute dtype (bf16 when ``out_dtype`` is
bf16, else f32) and accumulate in f32; the affine and SiLU run in f32 before
the single output write.  On a CUDA tensor it launches the kernel; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

Tensor = torch.Tensor


def stem_conv_plain(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, *, stride: int,
                    padding: int, out_dtype=torch.bfloat16) -> Tensor:
    """x (B, H, W, C) f32; w (K, K, C, N); scale/bias (N,) f32 → (B, Ho, Wo, N)."""
    cd = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    xf = x.to(cd).float().permute(0, 3, 1, 2)
    wf = w.to(cd).float().permute(3, 2, 0, 1)
    y = F.conv2d(xf, wf, stride=stride, padding=padding)
    y = F.silu(y * scale.float()[:, None, None] + bias.float()[:, None, None])
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def stem_conv(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, *, stride: int, padding: int,
              out_dtype=torch.bfloat16) -> Tensor:
    """silu(conv2d(x, w, stride, padding) * scale + bias), NHWC."""
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, scale, bias, stride=stride, padding=padding,
                               out_dtype=out_dtype)
    B, H, W, C = x.shape
    K, K2, C2, N = w.shape
    out_codes = {torch.float32: 0, torch.bfloat16: 1}
    if K != K2 or C != C2 or N % 8 or x.dtype != torch.float32 or out_dtype not in out_codes:
        raise ValueError(f"stem kernel cannot take x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(w.shape)}, out {out_dtype}")
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    cd = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    x = x.contiguous()
    wk = w.to(cd).float().contiguous()            # weights rounded like the plain version
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    kernels.require_cuda(x, wk, scale, bias)
    y = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
    dev, stream = kernels.device_and_stream(x)
    code = kernels.fn("stem_conv")(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        B, H, W, C, K, stride, padding, N, Ho, Wo, out_codes[out_dtype],
        1 if cd == torch.bfloat16 else 0, dev, stream)
    kernels.check(code, "stem_conv")
    kernels.LAUNCHES["stem"] += 1
    return y
