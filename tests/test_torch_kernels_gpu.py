"""PyTorch port: each CUDA kernel against its plain PyTorch version, on the
card, at small and odd shapes (the flagship shapes are ``chip_smoke.py``'s).

Marked ``gpu``: every test skips when ``torch.cuda.is_available()`` is false.
Run on a machine with a card:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's machine need not have.)
"""

import ctypes
import math

import pytest
import torch

from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.models.detect_head import MaskHead
from hd_yolo_tpu_torch.ops import pallas_mask_head, pallas_nms, pallas_roi_align, pallas_stem
from hd_yolo_tpu_torch.ops.nms import nms_padded
from hd_yolo_tpu_torch.ops.roi_align import (_multiscale_roi_align_canvas,
                                             multiscale_roi_align_canvas,
                                             multiscale_roi_align_packed, roi_align)
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
    """The direct kernel (stem.cu) at f32 compute: its form on the card for
    the other shapes of the family, forced at the 6x6/s2/p2 stem over 3
    channels with N <= 64 (where ``stem_form`` picks ``stem_tf32``)."""
    x = torch.randn((2, H, W, C), generator=cuda, device="cuda")
    w = torch.randn((K, K, C, N), generator=cuda, device="cuda") * 0.1
    scale = torch.rand(N, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(N, generator=cuda, device="cuda") * 0.1
    kw = dict(stride=s, padding=p, out_dtype=torch.float32)
    n0 = kernels.LAUNCHES["stem"]
    got = pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw)
    assert kernels.LAUNCHES["stem"] == n0 + 1
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# (B, H, W, C, k, s, p, N): yolov5x6's stem (N 80) at 640 and 1280 px, f32
# wider than stem_tf32's MAX_W, N above 64 up to 256, C 1 / 2 / 4, the family's
# other (k, s), an odd k·C and s·C (pairs read as two floats)
DIRECT_SHAPES = [(2, 640, 640, 3, 6, 2, 2, 80), (1, 1280, 1280, 3, 6, 2, 2, 80),
                 (1, 64, 1300, 3, 6, 2, 2, 64), (2, 64, 64, 4, 6, 2, 2, 256),
                 (2, 64, 70, 1, 6, 2, 2, 64), (2, 64, 70, 2, 6, 2, 2, 64),
                 (2, 64, 70, 4, 6, 2, 2, 64), (2, 64, 66, 3, 2, 2, 0, 32),
                 (2, 64, 66, 3, 4, 2, 1, 48), (2, 40, 48, 3, 4, 4, 0, 96),
                 (2, 64, 72, 4, 8, 4, 2, 24), (2, 33, 47, 3, 3, 3, 1, 16),
                 (2, 33, 47, 1, 3, 3, 1, 40)]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,C,K,s,p,N", DIRECT_SHAPES)
def test_stem_direct_kernel_matches_plain(cuda, B, H, W, C, K, s, p, N, out_dtype):
    """The redesigned direct kernel (stem.cu, tensor-core products) at the
    shapes ``stem_form`` sends it and the family's others: one launch,
    within one bf16 ulp (bf16) or 1e-5 (split TF32) of plain, two launches
    bit-identical."""
    x = torch.rand((B, H, W, C), generator=cuda, device="cuda")
    w = torch.randn((K, K, C, N), generator=cuda, device="cuda") * (0.9 / (K * C ** 0.5))
    scale = torch.rand(N, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(N, generator=cuda, device="cuda") * 0.1
    kw = dict(stride=s, padding=p, out_dtype=out_dtype)
    n0 = kernels.LAUNCHES["stem"]
    got = pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw)
    assert kernels.LAUNCHES["stem"] == n0 + 1
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    if out_dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=1e-2)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, pallas_stem.stem_conv(x, w, scale, bias, form="direct", **kw))


def test_stem_direct_kernel_with_unsplit_weights(cuda):
    """A 32x32/s2 kernel over 4 channels (K = 4096): its split-TF32 weights do
    not fit beside the ring even at N tile 8, so the kernel stages them
    whole and splits them as it reads them.  Against the exact (f64) stem
    within what its f32 accumulation can lose: the tensor cores truncate
    each accumulate, up to one f32 ulp of the running sum at each of its
    512 k-steps (it reads 3.3e-05 here, where 1e-5 holds the 108-deep 6x6
    stems)."""
    x = torch.rand((1, 64, 400, 4), generator=cuda, device="cuda")
    w = torch.randn((32, 32, 4, 8), generator=cuda, device="cuda") * (0.9 / 64)
    scale = torch.rand(8, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(8, generator=cuda, device="cuda") * 0.1
    info = (ctypes.c_int * 7)()
    assert kernels.fn("stem_conv_plan")(64, 400, 4, 32, 2, 4, 8, 21, 189, 0, info) == 0
    assert info[0] == 2                               # the form with unsplit weights
    got = pallas_stem.stem_conv(x, w, scale, bias, stride=2, padding=4, out_dtype=torch.float32)
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w.double().permute(3, 2, 0, 1), stride=2, padding=4)
    want = torch.nn.functional.silu(y * scale.double()[:, None, None]
                                    + bias.double()[:, None, None]).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 21, 189, 8)
    ksteps = info[5]
    assert ksteps == 512
    torch.testing.assert_close(got.double(), want, rtol=0,
                               atol=ksteps * 2 ** -23 * float(want.abs().max()))


@pytest.mark.parametrize("B,H,W,N", [(1, 64, 64, 8), (2, 128, 128, 16), (4, 128, 128, 32),
                                     (16, 640, 640, 64), (1, 37, 91, 64), (2, 61, 50, 48),
                                     (1, 9, 6, 16), (2, 255, 130, 40), (1, 33, 70, 56),
                                     (2, 600, 720, 64), (1, 40, 48, 24)])
def test_stem_tf32_kernel_matches_plain(cuda, B, H, W, N):
    """The f32 stem form (stem_tf32.cu) at the three f32 paths' shapes (N 8,
    16, 32), the flagship's, odd H, widths with W % 4 != 0 (its 4-byte row
    copies) and up to its ``MAX_W``, every N it takes from 8 to 64: within
    1e-5 of the plain f32 version (TF32 off), two launches bit-identical,
    one launch of ``stem_tf32`` and none of the direct kernel."""
    x = torch.rand((B, H, W, 3), generator=cuda, device="cuda")
    w = torch.randn((6, 6, 3, N), generator=cuda, device="cuda") * 0.15
    scale = torch.rand(N, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(N, generator=cuda, device="cuda") * 0.1
    kw = dict(stride=2, padding=2, out_dtype=torch.float32)
    assert pallas_stem.stem_form(x.shape, w.shape, 2, 2, torch.float32) == "tf32"
    n0, d0 = kernels.LAUNCHES["stem_tf32"], kernels.LAUNCHES["stem"]
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    assert (kernels.LAUNCHES["stem_tf32"], kernels.LAUNCHES["stem"]) == (n0 + 1, d0)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got, pallas_stem.stem_conv(x, w, scale, bias, **kw))


def test_stem_tf32_silu_over_its_range(cuda):
    """The f32 form's SiLU alone, v over [-20, 20]: a one-hot centre tap
    makes each output silu(x + bias); within 1e-5 of the plain version on
    65,536 pre-activations."""
    x = torch.zeros((1, 64, 64, 3), device="cuda")
    x[0, :, :, 0] = torch.linspace(-20.0, 20.0, 64 * 64, device="cuda").view(64, 64)
    w = torch.zeros((6, 6, 3, 64), device="cuda")
    w[2, 2, 0] = 1.0
    scale = torch.ones(64, device="cuda")
    bias = torch.linspace(0.0, 0.04, 64, device="cuda")
    kw = dict(stride=2, padding=2, out_dtype=torch.float32)
    got = pallas_stem.stem_conv(x, w, scale, bias, **kw)
    want = pallas_stem.stem_conv_plain(x, w, scale, bias, **kw)
    assert float(want[0, 0, 0, 0]) < 0 and float(want.max()) > 19.0   # silu(-20), silu(~20)
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


def _clustered(gen, B, K, thr, extent=600.0):
    """Clustered boxes with pairs at IoU exactly ``thr`` (f32) and tied scores."""
    centers = torch.rand((B, -(-K // 8), 2), generator=gen, device="cuda") * extent
    c = centers.repeat_interleave(8, 1)[:, :K] + torch.randn((B, K, 2), generator=gen,
                                                             device="cuda") * 6
    wh = torch.rand((B, K, 2), generator=gen, device="cuda") * 40 + 8
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    for i in range(0, min(K, 64) - 1, 2):
        x, y = extent + 100.0 + 20.0 * (i // 2 % 8), extent + 100.0 + 20.0 * (i // 16)
        boxes[:, i] = torch.tensor([x, y, x + 10.0, y + 10.0], device="cuda")
        boxes[:, i + 1] = torch.tensor([x, y, x + 10.0, y + 10.0 * thr], device="cuda")
    scores = torch.rand((B, K), generator=gen, device="cuda")
    scores[:, K // 10: K // 5] = 0.5
    valid = torch.rand((B, K), generator=gen, device="cuda") > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("B,K,max_det,thr", [(16, 1024, 300, 0.45), (1, 1024, 1024, 0.45),
                                             (1, 4096, 4096, 0.45), (4, 1024, 512, 0.7),
                                             (2, 1000, 300, 0.45), (1, 4097, 4097, 0.45),
                                             (3, 700, 20, 0.45), (2, 64, 64, 0.5)])
def test_nms_kernel_bit_identical_at_path_shapes(cuda, B, K, max_det, thr):
    """The main path's (16, 1024) → 300, the stitch's (1, 1024) and (1, 4096),
    hnet's RPN (4, 1024) → 512, K not a multiple of 64, and max_det below the
    kept count (700 → 20); one launch, int32 positions and bool keep."""
    boxes, scores, valid = _clustered(cuda, B, K, thr)
    n0 = kernels.LAUNCHES["nms"]
    i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, valid, thr, max_det)
    assert kernels.LAUNCHES["nms"] == n0 + 1
    i2, k2 = nms_padded(boxes, scores, valid, thr, max_det)
    assert i1.dtype == torch.int32 and k1.dtype == torch.bool
    assert torch.equal(i1.long(), i2.long()) and torch.equal(k1, k2)
    if max_det == 20:
        assert bool(k1.all())                         # more kept than max_det


def test_nms_kernel_all_invalid_and_class_aware(cuda):
    """No valid box keeps nothing; hnet's class-aware (4, 512) → 100."""
    from hd_yolo_tpu_torch.ops.nms import batched_nms_padded, class_offset_boxes

    boxes, scores, valid = _clustered(cuda, 2, 300, 0.45)
    i1, k1 = pallas_nms.nms_padded_pallas(boxes, scores, torch.zeros_like(valid), 0.45, 50)
    assert not bool(k1.any()) and not bool(i1.any())
    boxes, scores, valid = _clustered(cuda, 4, 512, 0.5, extent=640.0)
    labels = torch.randint(0, 5, (4, 512), generator=cuda, device="cuda")
    labels[:, 1:64:2] = labels[:, 0:64:2]
    i1, k1 = batched_nms_padded(boxes, scores, labels, valid, 0.5, 100)
    i2, k2 = nms_padded(class_offset_boxes(boxes, labels, valid), scores, valid, 0.5, 100)
    assert torch.equal(i1.long(), i2.long()) and torch.equal(k1, k2)


def _flagship_pool_args(gen, K=768):
    """The main path's pooling at full size: 16 images, P3–P6 of a 640 px
    tile at 256 bf16 channels, K ROIs at 14x14, window 16."""
    feats = [torch.randn((16, 640 // s, 640 // s, 256), generator=gen, device="cuda")
             .to(torch.bfloat16) for s in (8, 16, 32, 64)]
    xy = torch.rand((K, 2), generator=gen, device="cuda") * 630
    wh = torch.rand((K, 2), generator=gen, device="cuda") * 60 + 4
    wh[torch.rand(K, generator=gen, device="cuda") < 0.1] *= 6
    levels = torch.randint(0, 4, (K,), generator=gen, device="cuda")
    b_idx = torch.randint(0, 16, (K,), generator=gen, device="cuda")
    return feats, torch.cat([xy, xy + wh], -1), levels, b_idx


@pytest.mark.parametrize("active", [None, 0, 1, 360, 768])
def test_roi_align_kernel_flagship_active_prefix(cuda, active):
    """Bit for bit the plain version on the active rows (the same rounding
    points and merge order), exactly 0 past them, two launches
    bit-identical, one launch each."""
    feats, boxes, levels, b_idx = _flagship_pool_args(cuda)
    act = None if active is None else torch.tensor(active, device="cuda")
    calls = []
    orig = pallas_roi_align.roi_align_bounded

    def spy(*a):
        calls.append(a)
        return orig(*a)

    pallas_roi_align.roi_align_bounded = spy
    try:
        n0 = kernels.LAUNCHES["roi_align"]
        got = multiscale_roi_align_packed(feats, boxes, levels, b_idx, (8.0, 16.0, 32.0, 64.0),
                                          14, window=16, active=act)
    finally:
        pallas_roi_align.roi_align_bounded = orig
    again = pallas_roi_align.roi_align_bounded(*calls[0])
    assert kernels.LAUNCHES["roi_align"] == n0 + 2
    want = pallas_roi_align.roi_align_bounded_plain(*calls[0])
    k = 768 if active is None else active
    assert torch.equal(got, again)
    assert bool((got[k:] == 0).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("K,M,dtype", [(512, 7, torch.bfloat16), (100, 14, torch.bfloat16),
                                       (100, 14, torch.float32)])
def test_roi_align_kernel_hnet_canvas_shapes(cuda, K, M, dtype):
    """hnet's canvas form: 4 images, levels 160/80/40/20 at 256 channels (a
    (4, 300, 160, 256) canvas's worth), 4 x 512 ROIs at 7x7 and 4 x 100 at
    14x14 on torchvision's levels; windows as large as the canvas, so wide
    ROIs run the kernel's bands.  bf16 bit for bit, f32 at 1e-4 (f32 sums
    in another order over up to 56 taps)."""
    feats = [torch.randn((4, s, s, 256), generator=cuda, device="cuda").to(dtype)
             for s in (160, 80, 40, 20)]
    strides = (4.0, 8.0, 16.0, 32.0)
    xy = torch.rand((4, K, 2), generator=cuda, device="cuda") * 660 - 10
    wh = torch.exp(torch.rand((4, K, 2), generator=cuda, device="cuda") * math.log(160.0)) * 4
    rois = torch.cat([xy, xy + wh], -1)
    area = torch.sqrt((wh[..., 0] * wh[..., 1]).clamp(min=1e-6))
    levels = (torch.floor(4.0 + torch.log2(area / 224.0) + 1e-6) - 2).clamp(0, 3).to(torch.int32)
    got = multiscale_roi_align_canvas(feats, rois, levels, strides, M)
    want = _multiscale_roi_align_canvas(feats, rois, levels, strides, M)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        assert ((got.float() - want.float()).abs() <= 1e-4).all()


@pytest.mark.parametrize("B,H,W,N", [(16, 640, 640, 64), (1, 256, 256, 32), (2, 600, 904, 64),
                                     (3, 37, 91, 64), (2, 255, 130, 32), (1, 9, 6, 16),
                                     (2, 61, 50, 48), (4, 640, 640, 32), (1, 1280, 1280, 64)])
def test_stem_tc_kernel_matches_plain(cuda, B, H, W, N):
    """The bf16 stem form: odd H, widths that are not 16-pixel multiples,
    W % 4 != 0 (4-byte row copies), each N the kernel takes, runs whose
    last ring step has one output row (hnet-darknet's 4 x 640), a 1280 px
    image, pre-activations out to |v| ~ 15 (SiLU's negative tail included).
    One bf16 ulp: |d| <= 1e-3 + 2^-7·|plain|; the direct kernel is not
    launched."""
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
                                         (6, torch.bfloat16, 28, 2), (8, torch.bfloat16, 7, 5)])
def test_roi_align_single_kernel_matches_plain(cuda, C, dtype, M, n):
    """Boxes partly off the map and one of zero area; (40, 2) is 80 samples
    per axis; C 5 and 6 take the scalar path.  f32 atol 1e-5; bf16 to bf16
    rounding (the same rounding points; a bin of three or more taps sums in
    f32 in another order than the plain matrix products)."""
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


HNET_PYRAMID = ((160, 4.0), (80, 8.0), (40, 16.0), (20, 32.0))


@pytest.mark.parametrize("C,dtype", [(256, torch.bfloat16), (24, torch.bfloat16),
                                     (6, torch.bfloat16), (12, torch.float32),
                                     (5, torch.float32)])
def test_roi_align_levels_kernel_hnet_pyramid(cuda, C, dtype):
    """hnet's ROI pyramid: the 640 px tile ROI of each of 4 images pooled from
    the four levels at M = the level's size, in ONE launch: bit for bit the
    four plain ``roi_align`` calls at bf16 (every bin has two rows and two
    columns), f32 within 1e-5; C 6 and 5 take the scalar path."""
    feats = [torch.randn((4, s, s, C), generator=cuda, device="cuda").to(dtype)
             for s, _ in HNET_PYRAMID]
    rois = torch.tensor([0.0, 0.0, 640.0, 640.0], device="cuda").expand(4, 1, 4).contiguous()
    sizes, scales = [s for s, _ in HNET_PYRAMID], [1.0 / st for _, st in HNET_PYRAMID]
    n0 = kernels.LAUNCHES["roi_align_single"]
    got = pallas_roi_align.roi_align_levels(feats, rois, sizes, scales, 2)
    assert kernels.LAUNCHES["roi_align_single"] == n0 + 1
    want = pallas_roi_align.roi_align_levels_plain(feats, rois, sizes, scales, 2)
    for g, w, s in zip(got, want, sizes):
        assert g.dtype == dtype and g.shape == (4, 1, s, s, C)
        if dtype == torch.bfloat16:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


# hnet on the darknet backbone at 640 px: the tile ROI's three levels (size,
# stride) and their channels in 'fpn' mode (the fused pyramid) and in
# 'dynamic' mode (darknet's raw levels at width 0.5)
DARKNET_PYRAMID = ((80, 8.0), (40, 16.0), (20, 32.0))
DARKNET_CHANNELS = {"fpn": (256, 256, 256), "dynamic": (128, 256, 512)}


@pytest.mark.parametrize("mode", list(DARKNET_CHANNELS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_levels_kernel_darknet_pyramid(cuda, mode, dtype):
    """The darknet hnet's ROI pyramid: each of 4 images' 640 px tile pooled
    from the three levels at M = the level's size, in ONE launch, forward
    bit for bit the plain version at bf16 and within 1e-5 at f32; the
    backward (one launch) bit for bit the plain version's at bf16 and within
    1e-5·max|g| of the CPU's at f32."""
    chans = DARKNET_CHANNELS[mode]
    feats = [torch.randn((4, s, s, c), generator=cuda, device="cuda").to(dtype)
             for (s, _), c in zip(DARKNET_PYRAMID, chans)]
    rois = torch.tensor([0.0, 0.0, 640.0, 640.0], device="cuda").expand(4, 1, 4).contiguous()
    sizes, scales = [s for s, _ in DARKNET_PYRAMID], [1.0 / st for _, st in DARKNET_PYRAMID]
    n0 = kernels.LAUNCHES["roi_align_single"]
    got = pallas_roi_align.roi_align_levels(feats, rois, sizes, scales, 2)
    assert kernels.LAUNCHES["roi_align_single"] == n0 + 1
    want = pallas_roi_align.roi_align_levels_plain(feats, rois, sizes, scales, 2)
    for g, w, s, c in zip(got, want, sizes, chans):
        assert g.dtype == dtype and g.shape == (4, 1, s, s, c)
        if dtype == torch.bfloat16:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    gs = [torch.randn(g.shape, generator=cuda, device="cuda").to(dtype) for g in got]
    n0 = kernels.LAUNCHES["roi_align_single_bwd"]
    gb = pallas_roi_align.roi_align_levels_bwd(gs, feats, rois, sizes, scales, 2)
    assert kernels.LAUNCHES["roi_align_single_bwd"] == n0 + 1
    if dtype == torch.bfloat16:
        wb = pallas_roi_align.roi_align_levels_bwd_plain(gs, feats, rois, sizes, scales, 2)
        assert all(torch.equal(a, b) for a, b in zip(gb, wb))
    else:
        wb = pallas_roi_align.roi_align_levels_bwd_plain(
            [g.cpu() for g in gs], [f.cpu() for f in feats], rois.cpu(), sizes, scales, 2)
        for a, b in zip(gb, wb):
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_kernel_darknet_keypoint_call(cuda, dtype):
    """The keypoint branch's pooling on the darknet hnet: 4 images x 100
    detections at 14x14 from the FPN's three levels (80/40/20 cells, 256
    channels, strides 8/16/32) on torchvision's level rule clipped to
    three levels: bf16 bit for bit, f32 within 1e-4 (another summation
    order over up to 56 taps)."""
    feats = [torch.randn((4, s, s, 256), generator=cuda, device="cuda").to(dtype)
             for s, _ in DARKNET_PYRAMID]
    strides = tuple(st for _, st in DARKNET_PYRAMID)
    xy = torch.rand((4, 100, 2), generator=cuda, device="cuda") * 600
    wh = torch.exp(torch.rand((4, 100, 2), generator=cuda, device="cuda") * math.log(40.0)) * 4
    rois = torch.cat([xy, xy + wh], -1)
    area = torch.sqrt((wh[..., 0] * wh[..., 1]).clamp(min=1e-6))
    levels = (torch.floor(4.0 + torch.log2(area / 224.0) + 1e-6) - 2).clamp(0, 2).to(torch.int32)
    n0 = kernels.LAUNCHES["roi_align"]
    got = multiscale_roi_align_canvas(feats, rois, levels, strides, 14)
    assert kernels.LAUNCHES["roi_align"] == n0 + 1
    want = _multiscale_roi_align_canvas(feats, rois, levels, strides, 14)
    assert got.dtype == dtype and got.shape == want.shape == (4, 100, 14, 14, 256)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        assert ((got.float() - want.float()).abs() <= 1e-4).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_levels_kernel_ragged_levels(cuda, dtype):
    """Three maps of other sizes and channel counts in one launch, boxes
    partly off the maps, some far larger than M·n samples (coarse bins:
    narrower channel slabs than the level's), one of zero area, at
    sampling 2 and 3, against the plain version on the CPU (the reference
    semantics: on the card torch divides by a Python number as a multiply
    by its reciprocal, which moves f32 sample coordinates of ~600 px by an
    ulp).  bf16 to bf16 rounding, f32 atol 1e-5."""
    shapes = [(3, 64, 600, 16), (3, 37, 23, 40), (3, 9, 150, 8)]
    for n in (2, 3):
        feats = [torch.randn(s, generator=cuda, device="cuda").to(dtype) for s in shapes]
        xy = torch.rand((3, 6, 2), generator=cuda, device="cuda") * 500 - 60
        wh = torch.rand((3, 6, 2), generator=cuda, device="cuda") * 500
        rois = torch.cat([xy, xy + wh], -1)
        rois[:, 0, 2:] = rois[:, 0, :2]
        rois[:, 1] = torch.tensor([0.0, 0.0, 600.0, 64.0], device="cuda")
        sizes, scales = [7, 14, 5], [1.0, 0.25, 0.5]
        got = pallas_roi_align.roi_align_levels(feats, rois, sizes, scales, n)
        want = pallas_roi_align.roi_align_levels_plain([f.cpu() for f in feats], rois.cpu(),
                                                       sizes, scales, n)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            if dtype == torch.bfloat16:
                torch.testing.assert_close(g.float().cpu(), w.float(), rtol=2e-2, atol=3e-2)
            else:
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)


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


@pytest.mark.parametrize("N,nc,active,scale", [(1, 2, None, 1.0), (30, 2, None, 1.0),
                                               (30, 2, 0, 1.0), (37, 3, 20, 1.0),
                                               (400, 5, None, 1.0), (400, 5, 360, 1.0),
                                               (3, 2, None, 1.0), (65, 3, None, 1.0),
                                               (131, 2, None, 1.0), (131, 2, 65, 1.0),
                                               (65, 3, None, 8.0)])
def test_mask_head_f32_kernel_matches_plain(cuda, N, nc, active, scale):
    """The f32 form (an f32 model's features, as the fixtures of
    ``chip_smoke.py`` phase 20 give it): within 1e-4 of the plain version
    in f32 (TF32 off) on the active slots, and within 5e-6·scale, which a
    build without the periodic promotion misses; exactly 0 past them, two
    launches bit-identical, and the bf16 kernel not launched.  N·196 flat
    rows in 128-row tiles: at N 3, 65 and 131 ROI boundaries fall inside a
    tile and the last tile is partial; ``scale`` 8 gives features of large
    magnitude (the split products' error grows with the operands')."""
    head = _mask_head(nc, 4)
    pooled = torch.randn((N, 14, 14, 256), generator=cuda, device="cuda") * scale
    labels = torch.randint(0, nc, (N,), generator=cuda, device="cuda")
    act = None if active is None else torch.tensor(active, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        n0, b0 = kernels.LAUNCHES["mask_head_f32"], kernels.LAUNCHES["mask_head"]
        got = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
        again = pallas_mask_head.fused_mask_probs(head, pooled, labels, act)
        assert kernels.LAUNCHES["mask_head_f32"] == n0 + 2 and kernels.LAUNCHES["mask_head"] == b0
        want = pallas_mask_head.fused_mask_probs_plain(head, pooled, labels, act)
    k = N if active is None else active
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert bool((got[k:] == 0).all())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # the tensor cores' f32 accumulate truncates: the partial promoted every
    # 16 k-steps reads ~1.5e-6 at unit features, one accumulator over a conv's
    # K ~2e-5; the limit scales with the features
    err = (got - want).abs().max().item()
    assert err <= 5e-6 * scale, f"max |d| {err:.3g}: the partial is not promoted often enough"


@pytest.mark.parametrize("B,H,W", [(2, 64, 64), (1, 50, 94), (3, 36, 20), (16, 640, 640),
                                   (2, 61, 50), (1, 9, 6), (2, 255, 130)])
def test_stem_k108_kernels_match_plain(cuda, B, H, W):
    """Kernels 6 and 7 against their shared plain version; the lab's shape,
    widths that are not multiples of the 16-pixel tile, odd heights,
    W % 4 != 0 (kernel 6's 4-byte row copies), and an im2col whose row count
    is odd (kernel 7's 8-byte tail copy).  One bf16 ulp of the output:
    |d| <= 1e-3 + 2^-7·|plain|."""
    x = torch.rand((B, H, W, 3), generator=cuda, device="cuda")
    w = torch.randn((6, 6, 3, 64), generator=cuda, device="cuda") * 0.1
    scale = torch.rand(64, generator=cuda, device="cuda") + 0.5
    bias = torch.randn(64, generator=cuda, device="cuda") * 0.1
    want = stem_lab.stem_k108_plain(x, w, scale, bias).float()
    n6, n7 = kernels.LAUNCHES["stem_k108"], kernels.LAUNCHES["stem_dot108"]
    got6 = stem_lab.stem_k108(x, w, scale, bias)
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
    for levels in ([torch.zeros((1, 4, 4, 3), device="cuda")],             # C % 4 != 0
                   [torch.zeros((1, 4, 4, 12), dtype=torch.bfloat16, device="cuda")],
                   [torch.zeros((1, 4, 4, 8), device="cuda"),                # mixed dtypes
                    torch.zeros((1, 2, 2, 8), dtype=torch.bfloat16, device="cuda")]):
        with pytest.raises(ValueError):
            pallas_roi_align.roi_align_bounded(levels, torch.zeros((1, 4), dtype=torch.int32,
                                                                   device="cuda"),
                                               torch.zeros((1, 4), device="cuda"),
                                               torch.zeros((1, 4), device="cuda"),
                                               torch.zeros((1, 4), device="cuda"), (4, 4), 2, 2)
    with pytest.raises(ValueError):                   # a level on the CPU
        pallas_roi_align.roi_align_bounded(
            [torch.zeros((1, 4, 4, 8), device="cuda"), torch.zeros((1, 2, 2, 8))],
            torch.zeros((1, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((1, 4), device="cuda"), torch.zeros((1, 4), device="cuda"),
            torch.zeros((1, 4), device="cuda"), (4, 4), 2, 2)
    with pytest.raises(ValueError):                   # NMS takes a bool valid mask
        pallas_nms.nms_keep_sorted(torch.zeros((1, 8, 4), device="cuda"),
                                   torch.ones((1, 8), dtype=torch.uint8, device="cuda"), 0.5, 4)
    with pytest.raises(ValueError):
        pallas_nms.nms_keep_sorted(torch.zeros((1, 8, 4), dtype=torch.float64, device="cuda"),
                                   torch.ones((1, 8), dtype=torch.bool, device="cuda"), 0.5, 4)
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


def test_custom_op_fakes_match_real_outputs(cuda):
    """Each kernel's ``torch.library`` op: its fake implementation (what
    ``torch.export`` traces) gives the shape, dtype and device of the
    kernel's real output."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = torch.ops.hd_yolo_tpu_torch
    x = torch.rand((2, 64, 96, 3), generator=cuda, device="cuda")
    w = torch.randn((6, 6, 3, 64), generator=cuda, device="cuda") * 0.1
    sc = torch.rand(64, generator=cuda, device="cuda") + 0.5
    bi = torch.randn(64, generator=cuda, device="cuda") * 0.1
    xy = torch.rand((2, 70, 2), generator=cuda, device="cuda") * 100
    boxes = torch.cat([xy, xy + 12], -1).contiguous()
    valid = torch.rand((2, 70), generator=cuda, device="cuda") > 0.2
    levels = [torch.randn((2, 32 >> i, 32 >> i, 16), generator=cuda, device="cuda")
              .to(torch.bfloat16) for i in range(3)]
    K, M, n = 6, 7, 2
    meta = torch.zeros((K, 4), dtype=torch.int32, device="cuda")
    ys = torch.rand((K, M * n), generator=cuda, device="cuda") * 16
    xs = torch.rand((K, M * n), generator=cuda, device="cuda") * 16
    bounds = torch.tensor([[0.0, 32.0, 0.0, 32.0]], device="cuda").repeat(K, 1)
    head = _mask_head(2, 3)
    pooled = torch.randn((5, 14, 14, 256), generator=cuda, device="cuda").to(torch.bfloat16)
    wf, bf, wd, bd = pallas_mask_head.kernel_weights(head)
    wl = head.maskrcnn_preds.mask_fcn_logits.weight[:, :, 0, 0].to(torch.bfloat16).contiguous()
    bl = head.maskrcnn_preds.mask_fcn_logits.bias.float().contiguous()
    labels = torch.tensor([0, 1, 1, 0, 1], device="cuda")
    calls = {
        "stem_tc": (ops.stem_tc, (x, w, sc, bi)),
        "stem_tf32": (ops.stem_tf32, (x, w, sc, bi)),
        "stem": (ops.stem, (x, w, sc, bi, 2, 2, False)),
        "nms_keep": (ops.nms_keep, (boxes, valid, 0.45, 30)),
        "roi_align_bounded": (ops.roi_align_bounded,
                              (levels, meta, ys, xs, bounds, 32, 32, M, n,
                               torch.tensor(4, device="cuda"))),
        "mask_head": (ops.mask_head, (pooled, pallas_mask_head.mask_head_stream(wf, wd), bf, bd,
                                      wl, bl, labels, None)),
        "mask_head_f32": (ops.mask_head_f32, (pooled.float(),
                                              *pallas_mask_head.kernel_weights_f32(head), labels,
                                              torch.tensor(3, device="cuda"))),
    }
    for name, (op, args) in calls.items():
        with torch.no_grad():
            real = op(*args)
        mode = FakeTensorMode()
        fake_args = [[mode.from_tensor(t) for t in a] if isinstance(a, list)
                     else mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
        with mode:
            fake = op(*fake_args)
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        assert [(r.shape, r.dtype, r.device) for r in real] == \
            [(f.shape, f.dtype, f.device) for f in fake], name


def test_exported_flagship_equals_eager(cuda, tmp_path):
    """``engines/evaluate.export`` of the flagship (``yolov5l6-mask`` at full
    width, bf16, the per-image mask branch) at (2, 320, 320, 3): the graph
    calls each of the four kernels once, the loaded program launches each
    once, and its outputs equal the eager forward's exactly."""
    from hd_yolo_tpu_torch.engines import evaluate

    model, fwd = evaluate.build_model("yolov5l6-mask", "hyp-nuclei", device="cuda", seed=0)
    with torch.no_grad():
        for h in model.headers.values():             # enough detections to fill the masks
            for conv in h.m:
                conv.bias.view(h.na, h.no)[:, 4] += 4.0
    path = evaluate.export(model, (2, 320, 320, 3), str(tmp_path / "flagship.pt2"))
    program = evaluate.load_exported(path)
    want_calls = {"stem_tc": 1, "nms_keep": 1, "roi_align_bounded": 1, "mask_head": 1}
    assert evaluate.kernel_calls(program) == want_calls
    x = torch.randint(0, 256, (2, 320, 320, 3), generator=cuda, device="cuda",
                      dtype=torch.uint8)
    want = fwd(x)
    kernels.reset_launches()
    got = program(x)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] for k in ("stem_tc", "stem", "nms", "roi_align", "mask_head")} \
        == {"stem_tc": 1, "stem": 0, "nms": 1, "roi_align": 1, "mask_head": 1}
    assert int(want["detSC"]["mask_valid"].sum()) > 0
    for k, v in want["detSC"].items():
        assert torch.equal(got["detSC"][k], v), k


def _bwd_case(gen, B, K, sizes, C, dtype, M=14, n=2, dev="cuda"):
    """Whole-canvas bounded ROI-align arguments (the training call's form)
    and an output gradient."""
    from hd_yolo_tpu_torch.ops.roi_align import level_meta, sample_coords

    strides = [8.0 * 2 ** i for i in range(len(sizes))]
    feats = [torch.randn((B, h, w, C), generator=gen, device=dev).to(dtype) for h, w in sizes]
    img = sizes[0][0] * 8
    xy = torch.rand((B * K, 2), generator=gen, device=dev) * img * 0.9 - 8
    boxes = torch.cat([xy, xy + torch.rand((B * K, 2), generator=gen, device=dev) * 60 + 2], -1)
    lv = torch.randint(0, len(sizes), (B * K,), generator=gen, device=dev).to(torch.int32)
    meta = level_meta(feats, strides)
    ys, xs, moff, mh, mw = sample_coords(boxes, lv, meta, M * n, False)
    bounds = torch.stack([moff, moff + mh, torch.zeros_like(mw), mw], -1)
    b = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(K)
    z = torch.zeros_like(b)
    window = (sum(h for h, _ in sizes), sizes[0][1])
    g = torch.randn((B * K, M, M, C), generator=gen, device=dev).to(dtype)
    return g, feats, torch.stack([b, z, z, lv], -1), ys, xs, bounds, window, M, n


@pytest.mark.parametrize("B,K,sizes,C,dtype,rel", [
    (2, 5, ((23, 17), (12, 9), (6, 5)), 8, torch.float32, 1e-5),
    (2, 7, ((40, 40), (20, 20)), 16, torch.bfloat16, 2e-2),
    (16, 64, ((80, 80), (40, 40), (20, 20), (10, 10)), 256, torch.bfloat16, 2e-2),
])
def test_roi_align_bwd_kernel_matches_plain_autograd(cuda, B, K, sizes, C, dtype, rel):
    """The backward kernel against the plain version's autograd on the card,
    per level within ``rel``·max|plain| (f32: atomics sum in another order;
    bf16: the plain autograd rounds its intermediate gradients to bf16 and
    sums the index backward in bf16, the kernel sums in f32)."""
    args = _bwd_case(cuda, B, K, sizes, C, dtype)
    n0 = kernels.LAUNCHES["roi_align_bwd"]
    got = pallas_roi_align.roi_align_bounded_bwd(*args)
    assert kernels.LAUNCHES["roi_align_bwd"] == n0 + 1
    want = pallas_roi_align.roi_align_bounded_bwd_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= rel * float(b.float().abs().max())
    active = torch.tensor(3, device="cuda")
    part = pallas_roi_align.roi_align_bounded_bwd(*args, active)
    first = pallas_roi_align.roi_align_bounded_bwd(args[0][:3], args[1], *[a[:3] for a in args[2:6]],
                                                   *args[6:])
    for a, b in zip(part, first):
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * max(float(b.float().abs().max()), 1)


def test_roi_align_bwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give bit-identical level gradients at
    the training call's form (each cell written once, its sums in ROI
    order: no atomics)."""
    args = _bwd_case(cuda, 16, 64, ((80, 80), (40, 40), (20, 20), (10, 10)), 256, torch.bfloat16)
    first = pallas_roi_align.roi_align_bounded_bwd(*args)
    again = pallas_roi_align.roi_align_bounded_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype,C", [(torch.float32, 12), (torch.bfloat16, 16),
                                     (torch.bfloat16, 6)])
def test_roi_align_bwd_kernel_clustered_rois(cuda, dtype, C):
    """1200 ROIs (more than one list round of a tile), most of them piled on
    one small level of a ragged pyramid, with an active prefix of 1100:
    against the plain version's autograd (f32 within 1e-5·max|g| of the
    CPU's; bf16 within 2e-2·max|g| on the card, as above), the ROIs past the
    prefix adding nothing (bit for bit the call on the prefix alone), two
    launches bit-identical.  C = 6 at bf16 takes
    the single-element path."""
    from hd_yolo_tpu_torch.ops.roi_align import level_meta, sample_coords

    B, K, M, n = 2, 1200, 7, 2
    sizes = ((23, 17), (12, 9), (6, 5))
    strides = [8.0, 16.0, 32.0]
    feats = [torch.randn((B, h, w, C), generator=cuda, device="cuda").to(dtype) for h, w in sizes]
    xy = torch.rand((K, 2), generator=cuda, device="cuda") * 40 + 60
    boxes = torch.cat([xy, xy + torch.rand((K, 2), generator=cuda, device="cuda") * 60 + 1], -1)
    lv = torch.where(torch.rand(K, generator=cuda, device="cuda") < 0.8, 2,
                     torch.randint(0, 2, (K,), generator=cuda, device="cuda")).to(torch.int32)
    meta = level_meta(feats, strides)
    ys, xs, moff, mh, mw = sample_coords(boxes, lv, meta, M * n, False)
    bounds = torch.stack([moff, moff + mh, torch.zeros_like(mw), mw], -1)
    b = torch.randint(0, B, (K,), generator=cuda, device="cuda").to(torch.int32)
    z = torch.zeros_like(b)
    g = torch.randn((K, M, M, C), generator=cuda, device="cuda").to(dtype)
    args = (g, feats, torch.stack([b, z, z, lv], -1), ys, xs, bounds,
            (sum(h for h, _ in sizes), sizes[0][1]), M, n)
    active = torch.tensor(1100, device="cuda")
    got = pallas_roi_align.roi_align_bounded_bwd(*args, active)
    assert all(torch.equal(a, c) for a, c in
               zip(got, pallas_roi_align.roi_align_bounded_bwd(*args, active)))
    if dtype == torch.float32:
        want = pallas_roi_align.roi_align_bounded_bwd_plain(
            *[t.cpu() if torch.is_tensor(t) else [x.cpu() for x in t] if isinstance(t, list)
              else t for t in args], active.cpu())
        rel = 1e-5
    else:
        want = pallas_roi_align.roi_align_bounded_bwd_plain(*args, active)
        rel = 2e-2
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        scale = float(w.float().abs().max())
        assert scale > 0 and float((a.cpu().float() - w.cpu().float()).abs().max()) <= rel * scale
    first = pallas_roi_align.roi_align_bounded_bwd(g[:1100], feats, *[a[:1100] for a in args[2:6]],
                                                   *args[6:])
    assert all(torch.equal(a, c) for a, c in zip(got, first))


@pytest.mark.parametrize("dtype,C", [(torch.float32, 12), (torch.bfloat16, 16),
                                     (torch.bfloat16, 6)])
def test_roi_align_bwd_kernel_passes_over_zero_gradient_rois(cuda, dtype, C):
    """ROIs whose output gradient is all zero (some of them -0.0, as a loss
    that passes over them gives) add nothing: the level gradients are bit
    for bit those of the call on the other ROIs alone, in their order, and
    within tolerance of the plain version's autograd.  C = 6 at bf16 takes
    the single-element path (the zero test by 2-byte halves)."""
    args = _bwd_case(cuda, 2, 40, ((23, 17), (12, 9), (6, 5)), C, dtype, M=7)
    g = args[0].clone()
    zero = torch.arange(g.shape[0], device="cuda") % 3 != 1
    g[zero] = 0.0
    g[::6] = -0.0
    keep = (~zero).nonzero()[:, 0]
    got = pallas_roi_align.roi_align_bounded_bwd(g, *args[1:])
    rest = pallas_roi_align.roi_align_bounded_bwd(g[keep], args[1], *[a[keep] for a in args[2:6]],
                                                  *args[6:])
    assert all(torch.equal(a, b) for a, b in zip(got, rest))
    want = pallas_roi_align.roi_align_bounded_bwd_plain(g, *args[1:])
    rel = 1e-5 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= rel * max(scale, 1e-30)


def test_roi_align_function_gradient_through_model_losses(cuda):
    """``Model.losses`` on the card (yolov5s-test, 128 px, f32): the level
    gradient goes through ``RoiAlignBoundedFn`` to the kernel (one launch
    each way) and the gradients of the seg convs match the CPU's within
    2e-2·max|g| (the mask branch's cancelling sums, as the CPU tests state)."""
    import numpy as np

    from hd_yolo_tpu_torch.config import load_cfg
    from hd_yolo_tpu_torch.models.yolo import Model

    hyp = load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    rng = np.random.default_rng(0)
    B, T = 2, 12
    x = torch.from_numpy(rng.integers(0, 256, (B, 128, 128, 3), dtype=np.uint8))
    xy = rng.uniform(0.05, 0.8, (B, T, 2))
    tg = {"boxes": torch.tensor(np.concatenate([xy, xy + 0.15], -1), dtype=torch.float32),
          "labels": torch.from_numpy(rng.integers(1, 5, (B, T))),
          "masks": torch.from_numpy((rng.uniform(size=(B, T, 28, 28)) > 0.5).astype(np.float32)),
          "valid": torch.ones((B, T), dtype=torch.bool)}
    m0 = Model.from_cfg("yolov5s-test", hyp, mask_rois=4)
    m0.init_weights(torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cuda", "cpu"):
        m = Model.from_cfg("yolov5s-test", hyp, mask_rois=4)
        m.load_state_dict(m0.state_dict())
        m.to(dev).train()
        kernels.reset_launches()
        losses, _ = m.losses(x.to(dev), {"det": {k: v.to(dev) for k, v in tg.items()}})
        m.total_loss(losses).backward()
        if dev == "cuda":
            assert kernels.LAUNCHES["roi_align"] == 1 and kernels.LAUNCHES["roi_align_bwd"] == 1
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters() if "seg." in n}
    for n, g in grads["cpu"].items():
        assert float((grads["cuda"][n] - g).abs().max()) <= 2e-2 * float(g.abs().max()), n


@pytest.mark.parametrize("sizes,C,dtype", [((64, 32, 16, 8), 256, torch.bfloat16),
                                           ((20, 10), 24, torch.bfloat16),
                                           ((33, 17), 12, torch.float32)])
def test_roi_align_levels_bwd_kernel_pyramid(cuda, sizes, C, dtype):
    """hnet's ROI pyramid (one whole-image ROI an image, each level at its
    own size, one launch): bit for bit the plain version's autograd at bf16
    (each level cell sums two exact terms a step); f32 within 1e-5·max|g|
    of the CPU's plain version."""
    B = 3
    feats = [torch.randn((B, s, s, C), generator=cuda, device="cuda").to(dtype) for s in sizes]
    rois = torch.tensor([0.0, 0.0, 4.0 * sizes[0], 4.0 * sizes[0]], device="cuda").expand(B, 1, 4)
    scales = [1.0 / (4.0 * 2 ** i) for i in range(len(sizes))]
    gs = [torch.randn((B, 1, s, s, C), generator=cuda, device="cuda").to(dtype) for s in sizes]
    n0 = kernels.LAUNCHES["roi_align_single_bwd"]
    got = pallas_roi_align.roi_align_levels_bwd(gs, feats, rois, sizes, scales, 2)
    assert kernels.LAUNCHES["roi_align_single_bwd"] == n0 + 1
    if dtype == torch.bfloat16:
        want = pallas_roi_align.roi_align_levels_bwd_plain(gs, feats, rois, sizes, scales, 2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        want = pallas_roi_align.roi_align_levels_bwd_plain(
            [g.cpu() for g in gs], [f.cpu() for f in feats], rois.cpu(), sizes, scales, 2)
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("C,dtype,K,M,span", [(5, torch.float32, 100, 28, 40),
                                              (16, torch.float32, 9, 7, 40),
                                              (8, torch.bfloat16, 13, 14, 40),
                                              (8, torch.bfloat16, 20, 14, 40),
                                              (16, torch.float32, 32, 28, 600)])
def test_roi_align_levels_bwd_kernel_many_boxes(cuda, C, dtype, K, M, span):
    """Many overlapping boxes an image (the confliction loss: 5 channels,
    output 28, scale 1/16; from 16 boxes an image the per-ROI path, with
    boxes up to ``span`` px: at 600 its R runs in chunks of bins), boxes
    partly off the map or of zero area, against the CPU's plain version
    (f32 1e-5·max|g|; bf16 2^-7·max|g|, the row gradient's bf16 rounding in
    another summation order); deterministic (two launches bit-identical)
    and the boxes get no gradient through the autograd function."""
    B, H, W = 2, 40, 37
    f = torch.rand((B, H, W, C), generator=cuda, device="cuda").to(dtype)
    xy = torch.rand((B, K, 2), generator=cuda, device="cuda") * 700 - 40
    boxes = torch.cat([xy, xy + torch.rand((B, K, 2), generator=cuda, device="cuda") * span], -1)
    boxes[:, 0, 2:] = boxes[:, 0, :2]
    g = torch.randn((B, K, M, M, C), generator=cuda, device="cuda").to(dtype)
    got = pallas_roi_align.roi_align_levels_bwd([g], [f], boxes, [M], [1 / 16.0], 2)[0]
    again = pallas_roi_align.roi_align_levels_bwd([g], [f], boxes, [M], [1 / 16.0], 2)[0]
    assert torch.equal(got, again)
    want = pallas_roi_align.roi_align_levels_bwd_plain([g.cpu()], [f.cpu()], boxes.cpu(), [M],
                                                       [1 / 16.0], 2)[0]
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((got.cpu().float() - want.float()).abs().max()) <= rel * float(
        want.float().abs().max())
    fr, br = f.detach().requires_grad_(), boxes.detach().requires_grad_()
    out = pallas_roi_align.roi_align_single(fr, br, M, 1 / 16.0, 2)
    gf, gb = torch.autograd.grad(out, [fr, br], g, allow_unused=True)
    assert gb is None and torch.equal(gf, got)


def test_distributed_step_at_world_1_on_nccl_matches_plain_step(cuda, tmp_path):
    """A one-rank NCCL group (a ``FileStore`` under ``tmp_path``): the
    micro-step through the distributed path (BatchNorm statistics through the
    differentiable all-reduce, the gradients summed in buckets) against the
    plain step from the same state, ``yolov5s-test`` at 128 px in f32 with
    masks: loss items rtol 1e-5, running statistics atol 1e-5, the update
    at ``tests/test_torch_train_step.py``'s tolerance: within 1e-3 of its
    size (2e-2 in the mask branch, whose gradients are cancelling sums) plus
    1e-6 of the weights' (the two paths compute the statistics in other
    orders)."""
    import copy
    import datetime

    import numpy as np
    import torch.distributed as dist

    from hd_yolo_tpu_torch import load_cfg
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.yolo import Model

    hyp = load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    model = Model.from_cfg("yolov5s-test", hyp, mask_rois=4)
    model.init_weights(torch.Generator().manual_seed(0))
    model.cuda()
    state = TrainState.create(model, build_optimizer(model, hyp, 2, 4))
    rng = np.random.default_rng(0)
    xy = rng.uniform(0.05, 0.7, (4, 16, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.25, (4, 16, 2))], -1)
    batch = to_device({"image": rng.integers(0, 256, (4, 128, 128, 3)).astype(np.uint8),
                       "targets": {"det": {"boxes": boxes.astype(np.float32),
                                           "labels": rng.integers(1, 4, (4, 16)),
                                           "masks": (rng.uniform(0, 1, (4, 16, 28, 28)) > 0.5)
                                           .astype(np.float32),
                                           "valid": np.ones((4, 16), bool)}}}, "cuda")
    sd0, opt0 = copy.deepcopy(model.state_dict()), copy.deepcopy(state.opt.state_dict())

    def run(step):
        model.load_state_dict(sd0)
        state.opt.load_state_dict(opt0)
        state.step = torch.zeros((), dtype=torch.int64, device="cuda")
        _, m = step(state, batch)
        return {k: float(v) for k, v in m.items()}, copy.deepcopy(model.state_dict())

    m_p, sd_p = run(make_train_step())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        m_d, sd_d = run(make_train_step(distributed=True))
    finally:
        dist.destroy_process_group()
    assert set(m_d) == set(m_p)
    for k in m_p:
        assert abs(m_d[k] - m_p[k]) <= 1e-5 * abs(m_p[k]) + 1e-7, (k, m_d[k], m_p[k])
    for k, v in sd_p.items():
        if "running_" in k:
            torch.testing.assert_close(sd_d[k], v, rtol=0, atol=1e-5, msg=k)
        elif v.is_floating_point():
            share = 2e-2 if k.startswith(("headers.det.seg.", "headers.det.seg_h.")) else 1e-3
            tol = share * float((v - sd0[k]).abs().max()) + 1e-6 * float(sd0[k].abs().max())
            assert float((sd_d[k] - v).abs().max()) <= tol, k


def test_distributed_step_at_world_2_on_the_card_matches_the_whole_batch(cuda, tmp_path):
    """Two processes sharing the card on a gloo group (NCCL takes one rank a
    card; gloo carries CUDA tensors), each on half of a global batch of 4,
    through ``_GlobalBatchNorm`` (the card's BatchNorm across ranks) and the
    bucketed gradient sum, against the plain step on the whole batch on the
    card, ``yolov5s-test`` at 128 px in f32: ``tests/test_torch_train_step.py``'s
    tolerances (loss items rtol 1e-4, running statistics atol 1e-5, the
    parameters and EMA within 1e-3 of the update's size, 2e-2 in the mask
    branch, plus 1e-6 of the weights'); both ranks bit-identical."""
    import os
    import subprocess
    import sys

    import numpy as np

    from hd_yolo_tpu_torch import load_cfg
    from hd_yolo_tpu_torch.engines.optim import build_optimizer
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.yolo import Model

    hyp = load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    model = Model.from_cfg("yolov5s-test", hyp, mask_rois=4)
    model.init_weights(torch.Generator().manual_seed(1))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    xy = rng.uniform(0.05, 0.7, (4, 16, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.25, (4, 16, 2))], -1)
    valid = np.zeros((4, 16), bool)
    for b, k in enumerate((11, 7, 16, 3)):
        valid[b, :k] = True
    batch = to_device({"image": rng.integers(0, 256, (4, 128, 128, 3)).astype(np.uint8),
                       "targets": {"det": {"boxes": boxes.astype(np.float32),
                                           "labels": rng.integers(1, 4, (4, 16)),
                                           "masks": (rng.uniform(0, 1, (4, 16, 28, 28)) > 0.5)
                                           .astype(np.float32), "valid": valid}}}, "cpu")
    torch.save({"hyp": hyp, "mask_rois": 4, "state_dict": sd0, "batch": batch},
               tmp_path / "step_in.pt")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.dirname(here)}
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_parallel_workers.py"),
                               "--cases", "step", "--rank", str(r), "--world", "2",
                               "--store", str(tmp_path / "store"), "--io", str(tmp_path),
                               "--device", "cuda"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    got = [torch.load(tmp_path / f"step_out_{r}.pt", weights_only=False) for r in range(2)]

    model.cuda()
    opt = build_optimizer(model, hyp, 2, 8, accumulate=1)
    state = TrainState.create(model, opt)
    _, m = make_train_step()(state, to_device(batch, "cuda"))
    for k, v in m.items():
        assert abs(got[0]["metrics"][k] - float(v)) <= 1e-4 * abs(float(v)), k
    for n, b in model.named_buffers():
        if "running_" in n:
            torch.testing.assert_close(got[0]["buffers"][n], b.cpu(), rtol=0, atol=1e-5, msg=n)
    mask = ("headers.det.seg.", "headers.det.seg_h.")
    for n, p, e in zip(opt.names, opt.params, state.ema.params):
        p0 = sd0[n]
        share = 2e-2 if n.startswith(mask) else 1e-3
        tol = share * float((p.detach().cpu() - p0).abs().max()) + 1e-6 * float(p0.abs().max())
        assert float((got[0]["params"][n] - p.detach().cpu()).abs().max()) <= tol, n
        assert float((got[0]["ema"][n] - e.cpu()).abs().max()) <= tol, n
    for key in ("params", "ema", "buffers"):
        for n in got[0][key]:
            assert torch.equal(got[0][key][n], got[1][key][n]), (key, n)


def _two_ranks_on_the_card(tmp_path, case: str) -> list:
    """Two worker processes sharing the card on a gloo group, ``case`` of
    ``tests/torch_parallel_workers.py``; their outputs."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.dirname(here)}
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_parallel_workers.py"),
                               "--cases", case, "--rank", str(r), "--world", "2",
                               "--store", str(tmp_path / "store"), "--io", str(tmp_path),
                               "--device", "cuda"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp_path / f"{case}_out_{r}.pt", weights_only=False) for r in range(2)]


SMALL_HNET = {
    "backbone": {"type": "swin", "embed_dim": 32, "depths": [1, 1, 1, 1],
                 "num_heads": [1, 2, 4, 8], "window_size": 4, "drop_path_rate": 0.2,
                 "drop_rate": 0.1, "attn_drop_rate": 0.1},
    "fpn": {"out_channels": 32},
    "headers": {
        "det40x": {"type": "maskrcnn", "num_classes": 3, "pre_nms_topk": 128,
                   "num_proposals": 32, "num_detections": 16,
                   "anchor_sizes": [16.0, 32.0, 64.0, 128.0]},
        "seg10x": {"type": "panoptic", "num_classes": 4, "channels": 32},
        "cl5x": {"type": "cl", "num_classes": 3, "hidden": 32, "amplification": 0.5},
    },
    "constrains": {"c0": {"seg_task": "seg10x", "det_task": "det40x", "weighting": "mask",
                          "edges": [[1, 1], [2, 2], [3, 3]]}},
}


def test_hnet_distributed_step_at_world_2_on_the_card_matches_the_whole_batch(cuda, tmp_path):
    """Two processes sharing the card on gloo, each on 2 images of a global
    batch of 4, one ``make_train_step(distributed=True)`` micro-step of a
    small hnet (Swin, drop path 0.2, dropouts 0.1, f32) through the kernels,
    against the one-process step on the whole batch on the card: every drop
    mask the two ranks draw, in rank order, bit for bit the whole batch's;
    the loss items rtol 1e-4 (+ 1e-6) and the summed gradients within 1e-3
    of the larger of each tensor's max|g| and 1e-3 of the largest (2e-2 in
    the mask head: ``tests/test_torch_hnet_parallel.py``'s tolerances
    against JAX); both ranks' parameters bit-identical."""
    import numpy as np

    from hd_yolo_tpu_torch.hnet import HNet

    import torch_parallel_workers as workers

    rng = np.random.default_rng(3)
    B, T = 4, 5
    xy = rng.uniform(0.1, 0.5, (B, T, 2)).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, -1] = valid[2, -2:] = False
    targets = {"det40x": {"boxes": np.concatenate([xy, xy + 0.3], -1).astype(np.float32),
                          "labels": rng.integers(1, 4, (B, T)),
                          "masks": (rng.uniform(0, 1, (B, T, 28, 28)) > 0.5).astype(np.float32),
                          "valid": valid},
               "seg10x": {"seg_map": rng.integers(0, 4, (B, 16, 16))},
               "cl5x": {"label": np.asarray([1, -1, 2, 0])}}
    case = {"cfg": SMALL_HNET, "hyp": {"lr0": 0.005, "warmup_epochs": 3.0,
                                       "clip_grad_norm": 10.0}, "seed": 7, "steps": 1,
            "state_dict": HNet.from_cfg(SMALL_HNET, device="cpu", seed=2).state_dict(),
            "batch": {"image": torch.from_numpy(rng.uniform(0, 1, (B, 64, 64, 3))
                                                .astype(np.float32)),
                      "targets": {t: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                                  for t, d in targets.items()}}}
    torch.save({"drop": case}, tmp_path / "hnet_in.pt")
    ranks = [r["drop"] for r in _two_ranks_on_the_card(tmp_path, "hnet")]
    whole = workers.hnet_step(case, 0, 1, "cuda")
    assert len(whole["draws"]) == len(ranks[0]["draws"]) > 8
    for w, a, b in zip(whole["draws"], ranks[0]["draws"], ranks[1]["draws"]):
        assert torch.equal(torch.cat([a, b]), w)
    for k, w in whole["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - w) <= 1e-4 * abs(w) + 1e-6, k
    top = max(float(g.abs().max()) for g in whole["grads"].values())
    for n, w in whole["grads"].items():
        share = 2e-2 if ".mask_head." in n else 1e-3
        tol = share * max(float(w.abs().max()), 1e-3 * top)
        assert float((ranks[0]["grads"][n] - w).abs().max()) <= tol, n
    for n in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]), n


def test_packed_slide_at_world_2_on_the_card_ranks_the_global_batch(cuda, tmp_path):
    """``slide_inference_sharded`` at world 2 on one card (gloo), 4 tiles a
    rank a call, ``yolov5s-test`` in f32 with the packed mask branch at a
    budget of 12 ROIs a call, against ``slide_inference`` of one process
    with the 8-tile calls of the global batch: the packed branch ranks its
    budget over both ranks' tiles, so rows, labels and kept masks agree
    (boxes and scores atol 1e-3, masks atol 1e-4), and the budget binds."""
    import numpy as np

    from hd_yolo_tpu_torch.models.yolo import Model
    from hd_yolo_tpu_torch.wsi import slide_inference

    kw = dict(max_masks=8, pre_nms_topk=256, mask_budget=12, mask_window=16)
    m = Model.from_cfg("yolov5s-test", "hyp-nuclei", **kw)
    m.init_weights(torch.Generator().manual_seed(3))
    for det in m.headers.values():                  # objectness up: the random model detects
        for conv in det.m:
            conv.bias.data.view(det.na, det.no)[:, 4] += 4.0
    slide = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (200, 330, 3))
                             .astype(np.uint8))
    skw = dict(tile=128, overlap=64)
    torch.save({"model_kw": kw, "state_dict": m.state_dict(), "slide": slide,
                "batch_per_device": 4, "kw": skw}, tmp_path / "packed_in.pt")
    a, b = _two_ranks_on_the_card(tmp_path, "packed")
    m.eval().cuda()
    want = slide_inference(lambda t: m(t)["det"], slide.cuda(), batch=8, **skw)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    for k in ("valid", "labels", "mask_valid"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(want[k]), err_msg=k)
    v = np.asarray(want["valid"])
    assert v.sum() > 8
    for k, tol in (("boxes", 1e-3), ("scores", 1e-3), ("masks", 1e-4)):
        np.testing.assert_allclose(np.asarray(a[k])[v], np.asarray(want[k])[v], rtol=0, atol=tol,
                                   err_msg=k)
    mv = np.asarray(want["mask_valid"])
    assert 0 < mv.sum() < v.sum()                   # the budget binds
