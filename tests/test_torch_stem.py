"""PyTorch port, stem kernel's plain version against the JAX stem.

Copies ``tests/test_pallas.py::test_pallas_stem_matches_xla_conv`` (the
(K, s, p, C_in) stem shapes, the Pallas kernel in interpret mode) and
``::test_convbnact_stem_fastpath_matches_standard`` (the layer with trained-ish
BN stats against flax's own ConvBnAct).  Tolerance: atol 1e-5, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models.layers import ConvBnAct as JaxConvBnAct
from hd_yolo_tpu.ops.pallas_stem import stem_conv_pallas
from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.models.layers import ConvBnAct
from hd_yolo_tpu_torch.ops.pallas_mask_head import split_tf32
from hd_yolo_tpu_torch.ops.pallas_stem import stem_conv, stem_conv_plain, stem_form

CASES = [(64, 64, 6, 2, 2, 3, 64), (40, 48, 4, 4, 0, 3, 96), (64, 64, 2, 2, 0, 4, 32),
         (37, 91, 6, 2, 2, 3, 64)]          # odd sizes: the TPU kernel pads past H+2p


@pytest.mark.parametrize("H,W,K,s,p,C,N", CASES)
def test_stem_plain_matches_pallas_interpret(rng, H, W, K, s, p, C, N):
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, N)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    want = stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                            stride=s, padding=p, act="silu", out_dtype=jnp.float32,
                            interpret=True)
    got = stem_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                    torch.from_numpy(bias), stride=s, padding=p, out_dtype=torch.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_stem_plain_bf16_rounds_inputs_like_pallas(rng):
    """bf16 compute: inputs and weights rounded to bf16, f32 accumulation and
    epilogue, bf16 out — the same rounding points as the TPU kernel."""
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    w = (rng.standard_normal((6, 6, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                            stride=2, padding=2, act="silu", out_dtype=jnp.bfloat16,
                            interpret=True)
    got = stem_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                    torch.from_numpy(bias), stride=2, padding=2, out_dtype=torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 ulp where the f32 sums (in other orders) round differently
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


def test_convbnact_stem_matches_flax_layer(rng):
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jm = JaxConvBnAct(64, 6, 2, 2, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    k = (rng.standard_normal(shapes["params"]["conv"]["kernel"].shape) * 0.2).astype(np.float32)
    v = {"params": {"conv": {"kernel": k},
                    "bn": {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
                           "bias": (rng.standard_normal(64) * 0.1).astype(np.float32)}},
         "batch_stats": {"bn": {"mean": (rng.standard_normal(64) * 0.1).astype(np.float32),
                                "var": rng.uniform(0.5, 2.0, 64).astype(np.float32)}}}
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))

    m = ConvBnAct(3, 64, 6, 2, 2).eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        m.bn.weight.copy_(torch.from_numpy(v["params"]["bn"]["scale"]))
        m.bn.bias.copy_(torch.from_numpy(v["params"]["bn"]["bias"]))
        m.bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["bn"]["mean"]))
        m.bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["bn"]["var"]))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        assert m.is_stem(xt)
        got = m(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("x_shape,w_shape,s,p,dtype,form", [
    ((16, 640, 640, 3), (6, 6, 3, 64), 2, 2, torch.bfloat16, "tc"),     # yolov5l6-mask
    ((2, 256, 256, 3), (6, 6, 3, 32), 2, 2, torch.bfloat16, "tc"),      # yolov5s-test
    ((1, 37, 91, 3), (6, 6, 3, 16), 2, 2, torch.bfloat16, "tc"),
    ((16, 640, 640, 3), (6, 6, 3, 64), 2, 2, torch.float32, "tf32"),    # f32 compute
    ((2, 64, 64, 3), (6, 6, 3, 96), 2, 2, torch.bfloat16, "direct"),    # N above 64
    ((2, 64, 64, 3), (6, 6, 3, 40), 2, 2, torch.bfloat16, "direct"),    # N not a multiple of 16
    ((2, 40, 48, 3), (4, 4, 3, 96), 4, 0, torch.bfloat16, "direct"),
    ((2, 64, 64, 4), (2, 2, 4, 32), 2, 0, torch.bfloat16, "direct"),
    ((2, 64, 64, 3), (6, 6, 3, 64), 2, 0, torch.bfloat16, "direct"),
    ((1, 64, 64, 3), (6, 6, 3, 8), 2, 2, torch.float32, "tf32"),       # the fixtures
    ((2, 128, 128, 3), (6, 6, 3, 16), 2, 2, torch.float32, "tf32"),    # hnet-darknet
    ((4, 128, 128, 3), (6, 6, 3, 32), 2, 2, torch.float32, "tf32"),    # yolov5s-test
    ((1, 37, 91, 3), (6, 6, 3, 24), 2, 2, torch.float32, "tf32"),
    ((2, 64, 64, 3), (6, 6, 3, 96), 2, 2, torch.float32, "direct"),    # N above 64
    ((2, 40, 48, 3), (4, 4, 3, 96), 4, 0, torch.float32, "direct"),
    ((2, 40, 48, 3), (4, 4, 3, 32), 4, 0, torch.float32, "direct"),
    ((1, 64, 1024, 3), (6, 6, 3, 64), 2, 2, torch.float32, "direct"),  # wider than its ring
])
def test_stem_form(x_shape, w_shape, s, p, dtype, form):
    assert stem_form(x_shape, w_shape, s, p, dtype) == form


def _tc_im2col(x, Ho, Wo):
    """(B, H, W, 3) → (B, Ho, Wo, 108): ``stem_tc``'s A rows, K in (ky, kx, c)
    order — for ky in 0..5 the 18 floats of input row 2oy-2+ky from column
    2ox-2 on (zero outside the image)."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2 * Wo + 2 - W, 2, 2 * Ho + 2 - H))
    rows = [xp[:, ky:ky + 2 * Ho:2] for ky in range(6)]
    return torch.cat([torch.cat([r[:, :, kx:kx + 2 * Wo:2] for kx in range(6)], -1)
                      for r in rows], -1)


@pytest.mark.parametrize("B,H,W,N", [(2, 64, 64, 64), (1, 37, 91, 32), (2, 30, 17, 16),
                                     (1, 33, 48, 48)])
def test_stem_tc_operands_reproduce_plain(rng, B, H, W, N):
    """``stem_tc``'s operands — its im2col in (ky, kx, c) K order and the
    (6, 6, 3, N) weight seen as (108, N), both rounded to bf16 — give the
    plain bf16 stem, and the JAX kernel's (interpret mode), within one bf16
    ulp."""
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    w = (rng.standard_normal((6, 6, 3, N)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    xt, wt, st, bt = map(torch.from_numpy, (x, w, scale, bias))
    plain = stem_conv_plain(xt, wt, st, bt, stride=2, padding=2, out_dtype=torch.bfloat16).float()
    Ho, Wo = plain.shape[1:3]
    cols = _tc_im2col(xt, Ho, Wo)
    assert cols.shape == (B, Ho, Wo, 108)
    w108 = wt.to(torch.bfloat16).reshape(108, N)
    acc = cols.to(torch.bfloat16).double() @ w108.double()
    got = torch.nn.functional.silu((acc * st.double() + bt.double()).float()).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), plain.numpy(), rtol=2 ** -7, atol=1e-6)
    want = stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                            stride=2, padding=2, act="silu", out_dtype=jnp.bfloat16,
                            interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def _tf32_k_rows():
    """``stem_tf32``'s K permutation, (14, 8): the weight row (in (ky, kx,
    c) order) of K slot kl of k-step ks — slots kl and kl + 4 are the pair
    2p, 2p + 1 with p = 4·ks + kl, two contiguous floats of one image row;
    108 stands for the zero padding rows."""
    ks, kl = torch.arange(14)[:, None], torch.arange(8)[None]
    k = 2 * (4 * ks + kl % 4) + kl // 4
    return torch.where(k < 108, k, torch.full_like(k, 108))


def _tf32_emulate(x, w, scale, bias, passes=3):
    """The f32 stem as ``stem_tf32`` forms it: A (the (ky, kx, c) im2col)
    and B (the (108, N) weight) in its K permutation, split into tf32 hi and
    lo; k-step by k-step, lo·hi then hi·lo added into one f32 accumulator
    and hi·hi into another (``passes`` 1: hi·hi only), the two summed; then
    the affine as a rounded multiply and add, and SiLU."""
    B, H, W, _ = x.shape
    N = w.shape[-1]
    Ho, Wo = (H - 2) // 2 + 1, (W - 2) // 2 + 1
    cols = _tc_im2col(x, Ho, Wo).reshape(-1, 108)
    cols = torch.cat([cols, torch.zeros((cols.shape[0], 1))], 1)
    wk = torch.cat([w.reshape(108, N), torch.zeros((1, N))])
    ah, al = split_tf32(cols)
    bh, bl = split_tf32(wk)
    small = torch.zeros((cols.shape[0], N))
    big = torch.zeros((cols.shape[0], N))
    for r in _tf32_k_rows():
        if passes == 3:
            small = small + al[:, r] @ bh[r]
            small = small + ah[:, r] @ bl[r]
        big = big + ah[:, r] @ bh[r]
    return torch.nn.functional.silu((small + big) * scale + bias).reshape(B, Ho, Wo, N)


@pytest.mark.parametrize("B,H,W,N", [(2, 64, 64, 64), (1, 37, 91, 32), (2, 30, 17, 16),
                                     (1, 33, 48, 8)])
def test_stem_tf32_operands_reproduce_pallas(rng, B, H, W, N):
    """``stem_tf32``'s operands — the im2col and the weight in its K
    permutation, split by ``split_tf32`` — accumulated as it does (the small
    products and hi·hi in two f32 accumulators, k-step by k-step) give JAX's
    f32 stem kernel (interpret mode) within 1e-5; every K row is used once
    and the padding is zero."""
    rows = _tf32_k_rows().flatten()
    assert sorted(rows[rows < 108].tolist()) == list(range(108)) and (rows == 108).sum() == 4
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    w = (rng.standard_normal((6, 6, 3, N)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    got = _tf32_emulate(*map(torch.from_numpy, (x, w, scale, bias)))
    want = stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                            stride=2, padding=2, act="silu", out_dtype=jnp.float32,
                            interpret=True)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_stem_single_pass_tf32_misses_the_limit(rng):
    """hi·hi alone (one TF32 pass, ~3 decimal digits) is far more than 1e-5
    off JAX's f32 stem: why the kernel forms three products."""
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    w = (rng.standard_normal((6, 6, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    got = _tf32_emulate(*map(torch.from_numpy, (x, w, scale, bias)), passes=1)
    want = stem_conv_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                            stride=2, padding=2, act="silu", out_dtype=jnp.float32,
                            interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() > 1e-4


def test_stem_tf32_constants_and_width_limit():
    """The kernel's plan, read from its source: 14 k-steps of 4 K pairs hold
    the 54 pairs of K = 108; the ring holds a step's rows and the next
    step's; ``stem_form`` takes images up to its ``MAX_W`` and no wider."""
    c = kernels.constants("stem_tf32")
    assert 4 * c["KSTEPS"] >= c["KPAIRS"] == c["KDIM"] // 2 == 54 and 4 * (c["KSTEPS"] - 1) < 54
    assert c["NSLOT"] == (2 * c["ROWS"] + 4) + 2 * c["ROWS"]
    wide = c["MAX_W"]
    assert stem_form((1, 64, wide, 3), (6, 6, 3, 64), 2, 2, torch.float32) == "tf32"
    assert stem_form((1, 64, wide + 1, 3), (6, 6, 3, 64), 2, 2, torch.float32) == "direct"


def test_stem_tf32_off_the_cpu_launches_or_raises():
    """Off the CPU the f32 form launches its kernel or raises: inputs not on
    one CUDA device raise (meta tensors here: there is no card), and its
    ``torch.library`` op's fake gives the plain version's shape and dtype."""
    x, w = torch.empty((2, 20, 24, 3), device="meta"), torch.empty((6, 6, 3, 16), device="meta")
    s, b = torch.empty(16, device="meta"), torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        stem_conv(x, w, s, b, stride=2, padding=2, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="cannot take"):
        stem_conv(x, w, s, b, stride=2, padding=2, out_dtype=torch.float32, form="tc")
    got = torch.ops.hd_yolo_tpu_torch.stem_tf32(x, w, s, b)
    want = stem_conv_plain(torch.zeros((2, 20, 24, 3)), torch.zeros((6, 6, 3, 16)),
                           torch.ones(16), torch.zeros(16), stride=2, padding=2,
                           out_dtype=torch.float32)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
