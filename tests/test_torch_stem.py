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
from hd_yolo_tpu_torch.models.layers import ConvBnAct
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
    ((16, 640, 640, 3), (6, 6, 3, 64), 2, 2, torch.float32, "direct"),  # f32 compute
    ((2, 64, 64, 3), (6, 6, 3, 96), 2, 2, torch.bfloat16, "direct"),    # N above 64
    ((2, 64, 64, 3), (6, 6, 3, 40), 2, 2, torch.bfloat16, "direct"),    # N not a multiple of 16
    ((2, 40, 48, 3), (4, 4, 3, 96), 4, 0, torch.bfloat16, "direct"),
    ((2, 64, 64, 4), (2, 2, 4, 32), 2, 0, torch.bfloat16, "direct"),
    ((2, 64, 64, 3), (6, 6, 3, 64), 2, 0, torch.bfloat16, "direct"),
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
