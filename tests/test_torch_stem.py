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
from hd_yolo_tpu_torch.ops.pallas_stem import stem_conv

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
