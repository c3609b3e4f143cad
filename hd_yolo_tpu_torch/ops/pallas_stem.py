"""Stem convolution on the card: wrapper of ``kernels/stem_tc.cu``,
``kernels/stem_tf32.cu`` and ``kernels/stem.cu`` (the Hopper ports of
``hd_yolo_tpu/ops/pallas_stem.py``).

``stem_conv(x, w, scale, bias, stride=, padding=, out_dtype=)`` computes
``silu(conv2d(x, w, stride, padding) * scale + bias)`` in NHWC, the yolov5
stem with its inference BatchNorm folded to a per-channel affine.
Matmul inputs are rounded to the compute dtype (bf16 when ``out_dtype`` is
bf16, else f32) and accumulate in f32; the affine and SiLU run in f32 before
the single output write.  On a CPU tensor it runs the plain version.  On a
CUDA tensor :func:`stem_form` picks the kernel for the 6x6/s2/p2 stem over
3 channels: at bf16 compute (N a multiple of 16 up to 64, both yolo
configs) the bf16 tensor-core kernel ``stem_tc``, at f32 compute (N a
multiple of 8 from 8 to 64, images up to ``stem_tf32.cu``'s ``MAX_W``
wide) the split-TF32 tensor-core kernel ``stem_tf32``; every other shape of
the family (yolov5x6's N 80 stem in either dtype, f32 wider than
``MAX_W`` or N above 64, any other k, s, p or C) launches the direct kernel
``stem``: the same products on the tensor cores (bf16, or split TF32) for
any (k, s, C), over a ring of raw input rows of a 64-column window, N tiled
across blocks.

All three take, per output pixel, K = k·k·C in the weight's own (ky, kx, c)
order: for each ky the k·C floats of input row oy·s-p+ky from column
ox·s-p on, contiguous in the image (at the 6x6/s2/p2 stem the 18 floats of
row 2oy-2+ky from column 2ox-2), against the (k, k, C, N) weight seen as
(k·k·C, N).  At bf16 compute the kernels round both to bf16 as they stage
them; at f32 they split both into tf32 hi and lo (``split_tf32`` of
``ops/pallas_mask_head``) and form each product as lo·hi + hi·lo + hi·hi.

Each kernel is a ``torch.library`` op (``hd_yolo_tpu_torch::stem_tc``,
``hd_yolo_tpu_torch::stem_tf32``, ``hd_yolo_tpu_torch::stem``) whose body is
the ``ctypes`` launch, with a fake implementation of its output shape and
dtype, so ``torch.export`` keeps the kernel as one call in the graph.
Eager calls on the card go through the same ops.
"""

from __future__ import annotations

from typing import Optional

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


def stem_form(x_shape, w_shape, stride: int, padding: int, out_dtype) -> str:
    """Which kernel takes a stem on the card, for the 6x6/s2/p2 conv over 3
    channels: ``"tc"`` (``stem_tc.cu``) at bf16 with N in {16, 32, 48, 64},
    ``"tf32"`` (``stem_tf32.cu``) at f32 with N a multiple of 8 from 8 to 64
    and a width up to its ``MAX_W``; else ``"direct"`` (``stem.cu``)."""
    K, K2, C, N = w_shape
    if (K, K2, C, stride, padding) != (6, 6, 3, 2, 2) or x_shape[-1] != 3:
        return "direct"
    if out_dtype == torch.bfloat16 and N % 16 == 0 and 16 <= N <= 64:
        return "tc"
    if (out_dtype == torch.float32 and N % 8 == 0 and 8 <= N <= 64
            and x_shape[2] <= kernels.constants("stem_tf32")["MAX_W"]):
        return "tf32"
    return "direct"


def _out_hw(x, w, stride: int, padding: int):
    K = w.shape[0]
    return ((x.shape[1] + 2 * padding - K) // stride + 1,
            (x.shape[2] + 2 * padding - K) // stride + 1)


def _launch_direct(x, w, scale, bias, stride, padding, out_dtype):
    B, H, W, C = x.shape
    K, N = w.shape[0], w.shape[-1]
    Ho, Wo = _out_hw(x, w, stride, padding)
    if x.data_ptr() % 16:                         # its 16-byte row copies need an aligned image
        x = x.clone()
    wk = w.float().contiguous()                   # rounded or split by the kernel as it stages it
    y = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
    dev, stream = kernels.device_and_stream(x)
    code = kernels.fn("stem_conv")(
        x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        B, H, W, C, K, stride, padding, N, Ho, Wo, 1 if out_dtype == torch.bfloat16 else 0,
        dev, stream)
    kernels.check(code, "stem_conv")
    kernels.LAUNCHES["stem"] += 1
    return y


def _ring_launch(name: str, out_dtype):
    """The launch of a ring kernel, ``stem_tc`` (bf16 out) or ``stem_tf32``
    (f32 out): the same arguments, the (6, 6, 3, N) f32 weight rounded or
    split by the kernel as it stages it."""
    def launch(x, w, scale, bias):
        B, H, W, _ = x.shape
        N = w.shape[-1]
        Ho, Wo = _out_hw(x, w, 2, 2)
        if x.data_ptr() % 16:                     # its 16-byte row copies need an aligned image
            x = x.clone()
        wk = w.float().contiguous()
        y = torch.empty((B, Ho, Wo, N), dtype=out_dtype, device=x.device)
        dev, stream = kernels.device_and_stream(x)
        code = kernels.fn(name)(x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                y.data_ptr(), B, H, W, Ho, Wo, N, dev, stream)
        kernels.check(code, name)
        kernels.LAUNCHES[name] += 1
        return y

    return launch


_launch_tc = _ring_launch("stem_tc", torch.bfloat16)
_launch_tf32 = _ring_launch("stem_tf32", torch.float32)


def _ring_fake(out_dtype):
    return lambda x, w, scale, bias: x.new_empty(
        (x.shape[0], *_out_hw(x, w, 2, 2), w.shape[-1]), dtype=out_dtype)


def _stem_fake(x, w, scale, bias, stride, padding, out_bf16):
    return x.new_empty((x.shape[0], *_out_hw(x, w, stride, padding), w.shape[-1]),
                       dtype=torch.bfloat16 if out_bf16 else torch.float32)


_RING_SCHEMA = "(Tensor x, Tensor w, Tensor scale, Tensor bias) -> Tensor"
stem_tc_op = kernels.register_op("stem_tc", _RING_SCHEMA, _launch_tc, _ring_fake(torch.bfloat16))
stem_tf32_op = kernels.register_op("stem_tf32", _RING_SCHEMA, _launch_tf32,
                                   _ring_fake(torch.float32))
stem_op = kernels.register_op(
    "stem", "(Tensor x, Tensor w, Tensor scale, Tensor bias, int stride, int padding, "
            "bool out_bf16) -> Tensor",
    lambda x, w, scale, bias, stride, padding, out_bf16: _launch_direct(
        x, w, scale, bias, stride, padding, torch.bfloat16 if out_bf16 else torch.float32),
    _stem_fake)


def stem_conv(x: Tensor, w: Tensor, scale: Tensor, bias: Tensor, *, stride: int, padding: int,
              out_dtype=torch.bfloat16, form: Optional[str] = None) -> Tensor:
    """silu(conv2d(x, w, stride, padding) * scale + bias), NHWC.  ``form``
    forces a kernel on the card: ``"direct"``, or the form :func:`stem_form`
    picks (its default)."""
    if x.device.type == "cpu":
        return stem_conv_plain(x, w, scale, bias, stride=stride, padding=padding,
                               out_dtype=out_dtype)
    B, H, W, C = x.shape
    K, K2, C2, N = w.shape
    if K != K2 or C != C2 or N % 8 or x.dtype != torch.float32 or out_dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"stem kernel cannot take x {tuple(x.shape)} {x.dtype}, "
                         f"w {tuple(w.shape)}, out {out_dtype}")
    auto = stem_form(x.shape, w.shape, stride, padding, out_dtype)
    form = form or auto
    if form not in (auto, "direct"):
        raise ValueError(f"stem form {form!r} cannot take x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"stride {stride}, padding {padding}, out {out_dtype}")
    x, w = x.contiguous(), w.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    kernels.require_cuda(x, w, scale, bias)
    if form == "tc":
        return stem_tc_op(x, w, scale, bias)
    if form == "tf32":
        return stem_tf32_op(x, w, scale, bias)
    return stem_op(x, w, scale, bias, stride, padding, out_dtype == torch.bfloat16)
