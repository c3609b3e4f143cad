"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the
card, at small and odd shapes (the flagship shapes are ``chip_smoke.py``'s).

Marked ``gpu``: every test skips when ``torch.cuda.is_available()`` is false.
Run on a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's machine need not have.)
"""

import math

import pytest
import torch

from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.models.detect_head import MaskHead
from hd_yolo_tpu_torch.ops import pallas_mask_head, pallas_nms, pallas_roi_align, pallas_stem
from hd_yolo_tpu_torch.ops.nms import nms_padded
from hd_yolo_tpu_torch.ops.roi_align import multiscale_roi_align_canvas, roi_align
from hd_yolo_tpu_torch.tools import stem_lab

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("H,W,K,s,p,C,N", [(64, 64, 6, 2, 2, 3, 64), (40, 48, 4, 4, 0, 3, 96),
                                           (64, 64, 2, 2, 0, 4, 32), (37, 91, 6, 2, 2, 3, 64)])
def test_stem_kernel_f32_matches_plain(cuda, H, W, K, s, p, C, N):
    """The direct kernel (stem.cu) at f32 compute, its only form on the card
    for these shapes."""
    x = torch.randn((2, H, W, C), generator=cuda, device="cuda")
    w = torch.randn((K, K, C, N), generator=cuda, device="cuda") * 0.1
    scale = torch.rand(N, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(N, generator=cuda, device="cuda") * 0.1
    kw = dict(stride=s, padding=p, out_dtype=torch.float32)
    n0 = kernels.LAUNCHES["stem"]
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    assert kernels.LAUNCHES["stem"] == n0 + 1
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("K,thr", [(64, 0.45), (200, 0.3), (1024, 0.45), (1300, 0.6)])
def test_nms_kernel_bit_identical(cuda, K, thr):
    B = 3
    xy = torch.rand((B, K, 2), generator=cuda, device="cuda") * 300
    wh = torch.rand((B, K, 2), generator=cuda, device="cuda") * 60 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand((B, K), generator=cuda, device="cuda")
    scores[:, : K // 4] = 0.5
    valid = torch.rand((B, K), generator=cuda, device="cuda") > 0.2
    i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, valid, thr, 300)
    i2, k2 = nms_padded(boxes, scores, valid, thr, 300)
    assert torch.equal(i1.long(), i2.long()) and torch.equal(k1, k2)


@pytest.mark.parametrize("B,H,W,N", [(16, 640, 640, 64), (1, 256, 256, 32), (2, 600, 904, 64),
                                     (3, 37, 91, 64), (2, 255, 130, 32), (1, 9, 6, 16),
                                     (2, 61, 50, 48)])
def test_stem_tc_kernel_matches_plain(cuda, B, H, W, N):
    """The bf16 stem form: odd H, widths that are not 16-pixel multiples,
    W % 4 != 0 (4-byte row copies), each N the kernel takes, pre-activations
    out to |v| ~ 15 (SiLU's negative tail included).  One bf16 ulp:
    |d| <= 1e-3 + 2^-7·|plain|; the direct kernel is not launched."""
    x = torch.rand((B, H, W, 3), generator=cuda, device="cuda")
    w = torch.randn((6, 6, 3, N), generator=cuda, device="cuda") * 0.6
    scale = torch.rand(N, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(N, generator=cuda, device="cuda") * 3
    kw = dict(stride=2, padding=2, out_dtype=torch.bfloat16)
    assert pallas_stem.stem_form(x.shape, w.shape, 2, 2, torch.bfloat16) == "tc"
    n0, d0 = kernels.LAUNCHES["stem_tc"], kernels.LAUNCHES["stem"]
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    assert (kernels.LAUNCHES["stem_tc"], kernels.LAUNCHES["stem"]) == (n0 + 1, d0)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw).float()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert ((got.float() - want).abs() <= 1e-3 + 2 ** -7 * want.abs()).all()


def test_stem_tc_silu_over_its_range(cuda):
    """SiLU alone, v over [-20, 20]: a one-hot centre tap makes each output
    bf16(x) + bias, so the kernel's SiLU meets the f32 one on 65,536
    pre-activations; within one bf16 ulp, |d| <= 2^-7·|plain|."""
    x = torch.zeros((1, 64, 64, 3), device="cuda")
    x[0, :, :, 0] = torch.linspace(-20.0, 20.0, 64 * 64, device="cuda").view(64, 64)
    w = torch.zeros((6, 6, 3, 64), device="cuda")
    w[2, 2, 0] = 1.0
    scale = torch.ones(64, device="cuda")
    bias = torch.linspace(0.0, 0.04, 64, device="cuda")
    kw = dict(stride=2, padding=2, out_dtype=torch.bfloat16)
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw).float()
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw).float()
    assert float(want[0, 0, 0, 0]) < 0 and float(want.max()) > 19.0   # silu(-20), silu(~20)
    assert ((got - want).abs() <= 2 ** -7 * want.abs()).all()


def test_roi_align_kernel_f32_canvas_matches_plain(cuda):
    B, K, C = 2, 9, 8
    feats = [torch.randn((B, 64 >> i, 64 >> i, C), generator=cuda, device="cuda")
             for i in range(4)]
    boxes = torch.rand((B, K, 4), generator=cuda, device="cuda") * 560 - 40
    boxes[..., 2:] = boxes[..., :2] + torch.rand((B, K, 2), generator=cuda, device="cuda") * 118 + 2
    levels = torch.randint(0, 4, (B, K), generator=cuda, device="cuda")
    strides = (8.0, 16.0, 32.0, 64.0)
    got = multiscale_roi_align_canvas(feats, boxes, levels, strides, 7)
    want = multiscale_roi_align_canvas([f.cpu() for f in feats], boxes.cpu(), levels.cpu(),
                                       strides, 7)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C,dtype,M,n", [(5, torch.float32, 7, 2), (16, torch.float32, 40, 2),
                                         (256, torch.bfloat16, 20, 2), (24, torch.bfloat16, 14, 1),
                                         (6, torch.bfloat16, 28, 2)])
def test_roi_align_single_kernel_matches_plain(cuda, C, dtype, M, n):
    """Boxes partly off the map and one of zero area; (40, 2) is 80 samples
    per axis.  f32 atol 1e-5; bf16 to bf16 rounding (the plain version rounds
    its matrices and row sums to bf16, the kernel stays f32)."""
    B, K, H, W, scale = 2, 9, 37, 23, 0.25
    f = torch.randn((B, H, W, C), generator=cuda, device="cuda").to(dtype)
    xy = torch.rand((B, K, 2), generator=cuda, device="cuda") * 110 - 10
    boxes = torch.cat([xy, xy + torch.rand((B, K, 2), generator=cuda, device="cuda") * 70], -1)
    boxes[:, 0, 2:] = boxes[:, 0, :2]
    n0 = kernels.LAUNCHES["roi_align_single"]
    got = pallas_roi_align.roi_align_single(f, boxes, M, scale, n)
    assert kernels.LAUNCHES["roi_align_single"] == n0 + 1
    want = roi_align(f, boxes, M, scale, n)
    assert got.dtype == dtype and got.shape == (B, K, M, M, C)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=3e-2)


def _mask_head(nc, seed):
    head = MaskHead(nc, 256)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for prm in head.parameters():
            scale = math.sqrt(2.0 / prm[0].numel()) if prm.dim() > 1 else 0.05
            prm.copy_(torch.randn(prm.shape, generator=g) * scale)
    return head.cuda()


@pytest.mark.parametrize("N,nc,active", [(1, 2, None), (7, 2, None), (7, 2, 0), (37, 3, None),
                                         (768, 2, None), (768, 2, 0), (768, 2, 360),
                                         (400, 5, None), (400, 5, 360)])
def test_mask_head_kernel_matches_plain(cuda, N, nc, active):
    """Within 2e-2 of the plain version on the active slots, exactly 0 past
    them, and two launches bit-identical."""
    head = _mask_head(nc, 2)
    pooled = torch.randn((N, 14, 14, 256), generator=cuda, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, nc, (N,), generator=cuda, device="cuda")
    act = None if active is None else torch.tensor(active, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        n0 = kernels.LAUNCHES["mask_head"]
        got = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
        again = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
        assert kernels.LAUNCHES["mask_head"] == n0 + 2
        want = pallas_mask_head.fused_mask_probs_plain(head, pooled, labels, act)
    k = N if active is None else active
    assert torch.equal(got, again)
    assert bool((got[k:] == 0).all())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("B,H,W,bh", [(2, 64, 64, 4), (1, 50, 94, 3), (3, 36, 20, 8)])
def test_stem_k108_kernels_match_plain(cuda, B, H, W, bh):
    """Kernels 6 and 7 against their shared plain version; widths that are
    not multiples of the 16-pixel tile, a last band of fewer rows than bh,
    and an im2col whose row count is odd (kernel 7's 8-byte tail copy).
    One bf16 ulp of the output: |d| <= 1e-3 + 2^-7·|plain|."""
    x = torch.rand((B, H, W, 3), generator=cuda, device="cuda")
    w = torch.randn((6, 6, 3, 64), generator=cuda, device="cuda") * 0.1
    scale = torch.rand(64, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(64, generator=cuda, device="cuda") * 0.1
    want = stem_lab.stem_k108_plain(x, w, scale, bias).float()
    n6, n7 = kernels.LAUNCHES["stem_k108"], kernels.LAUNCHES["stem_dot108"]
    got6 = stem_lab.stem_k108(x, w, scale, bias, bh=bh)
    got7 = stem_lab.stem_dot108(x, w, scale, bias)
    assert (kernels.LAUNCHES["stem_k108"], kernels.LAUNCHES["stem_dot108"]) == (n6 + 1, n7 + 1)
    for got in (got6, got7):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert ((got.float() - want).abs() <= 1e-3 + 2 ** -7 * want.abs()).all()
    odd = stem_lab.im2col108(stem_lab.s2d(x), want.shape[1], want.shape[2]).reshape(-1, 108)[:77]
    w108 = stem_lab.w_108(w)
    got = stem_lab.dot108(odd.clone(), w108, scale, bias).float()
    ref = stem_lab.dot108_plain(odd, w108, scale, bias).float()
    assert ((got - ref).abs() <= 1e-3 + 2 ** -7 * ref.abs()).all()


def test_kernels_raise_on_what_they_do_not_take(cuda):
    with pytest.raises(ValueError):
        pallas_mask_head.fused_mask_probs(MaskHead(2, 32).cuda(),
                                          torch.zeros((1, 14, 14, 32), device="cuda"),
                                          torch.zeros(1, dtype=torch.long, device="cuda"))
    with pytest.raises(ValueError):
        pallas_roi_align.roi_align_single(torch.zeros((1, 4, 4, 8), dtype=torch.float16,
                                                      device="cuda"),
                                          torch.zeros((1, 2, 4), device="cuda"), 7)
    with pytest.raises(ValueError):
        pallas_roi_align.roi_align_bounded(torch.zeros((1, 4, 4, 3), device="cuda"),
                                           torch.zeros((1, 4), device="cuda"),
                                           torch.zeros((1, 4), device="cuda"),
                                           torch.zeros((1, 4), device="cuda"),
                                           torch.zeros((1, 4), device="cuda"), (4, 4), 2, 2)
    with pytest.raises(ValueError):
        pallas_stem.stem_conv(torch.zeros((1, 8, 8, 3), device="cuda"),
                              torch.zeros((6, 6, 3, 96), device="cuda"), torch.ones(96, device="cuda"),
                              torch.zeros(96, device="cuda"), stride=2, padding=2, form="tc")
    with pytest.raises(ValueError):
        stem_lab.stem_k108(torch.zeros((1, 8, 8, 4), device="cuda"),
                           torch.zeros((6, 6, 3, 64), device="cuda"),
                           torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError):
        stem_lab.dot108(torch.zeros((5, 112), dtype=torch.bfloat16, device="cuda"),
                        torch.zeros((112, 64), dtype=torch.bfloat16, device="cuda"),
                        torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"))
