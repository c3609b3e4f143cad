"""PyTorch port, fused mask head: the plain ``fused_mask_probs`` against the
JAX ``fused_mask_probs(interpret=True)`` and against ``sigmoid(MaskHead)`` +
per-ROI channel select (copies
``tests/test_pallas.py::test_pallas_mask_head_matches_flax``).
Tolerance: atol 1e-5, f32.  Also the ``active`` prefix (slots at or past
it exactly 0) and the kernel's packed weight stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models.detect_head import MaskHead as JaxMaskHead
from hd_yolo_tpu.ops.pallas_mask_head import fused_mask_probs as jax_fused_mask_probs
from hd_yolo_tpu_torch.models.detect_head import MaskHead
from hd_yolo_tpu_torch.ops.pallas_mask_head import (_deinterleave, fused_mask_probs, kernel_weights,
                                                     kernel_weights_f32, mask_head_stream)

N, M, C, NC = 11, 14, 32, 5


def _params(rng):
    """Random flax MaskHead params (numpy) and the port's head loaded with them."""
    head = JaxMaskHead(nc_masks=NC, dim_reduced=C, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), jnp.zeros((1, M, M, C))))
    p = {}
    for name, node in shapes["params"].items():
        k = node["kernel"].shape
        p[name] = {"kernel": (rng.standard_normal(k) * np.sqrt(2.0 / np.prod(k[:-1])))
                   .astype(np.float32),
                   "bias": (rng.standard_normal(node["bias"].shape) * 0.05).astype(np.float32)}
    th = MaskHead(NC, C)
    with torch.no_grad():
        for j, conv in enumerate(th.fcn):
            conv.weight.copy_(torch.from_numpy(p[f"fcn{j}"]["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.from_numpy(p[f"fcn{j}"]["bias"]))
        # flax ConvTranspose applies its kernel flipped: the reference layout flips it back
        dk = p["deconv"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy()
        th.maskrcnn_preds.conv5_mask.weight.copy_(torch.from_numpy(dk))
        th.maskrcnn_preds.conv5_mask.bias.copy_(torch.from_numpy(p["deconv"]["bias"]))
        lk = p["logits"]["kernel"].transpose(3, 2, 0, 1).copy()
        th.maskrcnn_preds.mask_fcn_logits.weight.copy_(torch.from_numpy(lk))
        th.maskrcnn_preds.mask_fcn_logits.bias.copy_(torch.from_numpy(p["logits"]["bias"]))
    return head, {"params": p}, th


@pytest.fixture
def inputs(rng):
    head, v, th = _params(rng)
    x = rng.standard_normal((N, M, M, C)).astype(np.float32)
    labels = rng.integers(0, NC, (N,)).astype(np.int32)
    return head, v, th, x, labels


def test_plain_matches_jax_fused_interpret(inputs):
    """Copies ``tests/test_pallas.py::test_pallas_mask_head_matches_flax`` (N=11,
    not a multiple of the TPU kernel's chunk)."""
    head, v, th, x, labels = inputs
    want = jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                interpret=True)
    with torch.no_grad():
        got = fused_mask_probs(th, torch.from_numpy(x), torch.from_numpy(labels))
    assert tuple(got.shape) == (N, 2 * M, 2 * M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_plain_matches_flax_mask_head_chain(inputs):
    head, v, th, x, labels = inputs
    logits = head.apply(v, jnp.asarray(x))
    want = jnp.take_along_axis(jax.nn.sigmoid(logits), jnp.asarray(labels)[:, None, None, None],
                               axis=-1)[..., 0]
    with torch.no_grad():
        got = fused_mask_probs(th, torch.from_numpy(x), torch.from_numpy(labels))
        chain = torch.sigmoid(th(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(chain.numpy(), np.asarray(jax.nn.sigmoid(logits)), rtol=0, atol=1e-5)


def test_kernel_weight_layouts(inputs):
    """The kernel's (tap, co, ci) operands reproduce the convs and the deconv."""
    _, _, th, x, _ = inputs
    wf, bf, wd, bd = kernel_weights(th, torch.float32)
    xt = torch.from_numpy(x)
    conv = th.fcn[0]
    with torch.no_grad():
        want = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), conv.weight, padding=1)
        xp = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
        got = sum(torch.einsum("nhwi,oi->nohw", xp[:, ky:ky + M, kx:kx + M], wf[0, ky * 3 + kx])
                  for ky in range(3) for kx in range(3))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        dec = th.maskrcnn_preds.conv5_mask
        full = torch.nn.functional.conv_transpose2d(xt.permute(0, 3, 1, 2), dec.weight, stride=2)
        taps = torch.stack([torch.einsum("nhwi,oi->nohw", xt, wd[d]) for d in range(4)], 1)
        for o in range(3):
            torch.testing.assert_close(_deinterleave(taps[:, :, o]), full[:, o], rtol=1e-5, atol=1e-5)


def test_f32_kernel_weight_layouts(inputs):
    """The f32 kernel's operands, used as it uses them (each conv an implicit
    GEMM over (tap, ci) rows of (9, ci, co), the deconv one product with its
    4 taps as columns (dy*2+dx)·C + co, the selected logits column and bias
    by label, the sigmoid), reproduce the JAX kernel (interpret mode)."""
    head, v, th, x, labels = inputs
    wf, bf, wd, bd, wl, bl = kernel_weights_f32(th)
    assert wf.shape == (4, 9, C, C) and wd.shape == (C, 4 * C) and wl.shape == (NC, C)
    h = torch.from_numpy(x).reshape(N, M * M, C)
    with torch.no_grad():
        for layer in range(4):
            xp = torch.nn.functional.pad(h.reshape(N, M, M, C), (0, 0, 1, 1, 1, 1))
            rows = torch.cat([xp[:, ky:ky + M, kx:kx + M].reshape(N, M * M, C)
                              for ky in range(3) for kx in range(3)], -1)
            h = torch.relu(rows @ wf[layer].reshape(9 * C, C) + bf[layer])
        lab = torch.from_numpy(labels).long()
        z = torch.relu((h @ wd).reshape(N, M * M, 4, C) + bd)
        o = (z * wl[lab][:, None, None]).sum(-1) + bl[lab][:, None, None]
        got = _deinterleave(torch.sigmoid(o).permute(0, 2, 1).reshape(N, 4, M, M))
    want = jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [0, 4, N])
def test_plain_active_prefix_matches_jax_then_zero(inputs, k):
    """``active = k``: the first k slots equal the JAX kernel's (interpret
    mode), the rest are exactly 0; ``None`` is the same as N."""
    head, v, th, x, labels = inputs
    want = np.asarray(jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                           interpret=True))
    with torch.no_grad():
        got = fused_mask_probs(th, torch.from_numpy(x), torch.from_numpy(labels),
                               active=torch.tensor(k, dtype=torch.int32)).numpy()
        full = fused_mask_probs(th, torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    assert got.shape == (N, 2 * M, 2 * M)
    np.testing.assert_allclose(got[:k], want[:k], rtol=0, atol=1e-5)
    assert (got[k:] == 0).all()
    if k == N:
        np.testing.assert_array_equal(got, full)


def _unpack_stream(stream):
    """(1280, 2048) stream → (wf (4, 9, 256, 256), wd (4, 256, 256))."""
    def unslice(t, lead):
        t = t.reshape(*lead, 2, 16, 16, 2, 8, 8)        # pass, ks, co group, k half, co row, ci
        n = len(lead)
        perm = list(range(n)) + [n + i for i in (0, 2, 4, 1, 3, 5)]
        return t.permute(*perm).reshape(*lead, 256, 256)

    conv = stream[:1152].reshape(4, 2, 9, 16, 2048).permute(0, 2, 1, 3, 4)
    return unslice(conv, (4, 9)), unslice(stream[1152:], (4,))


def test_weight_stream_layout(rng):
    """The kernel's stream: 1280 slices of 16 ci x 128 co in consumption
    order, element (k, n) of a slice at ((n//8)*2 + k//8)*64 + (n%8)*8 + k%8
    (wgmma's no-swizzle K-major core matrices, LBO 128 B, SBO 256 B)."""
    wf = torch.from_numpy(rng.standard_normal((4, 9, 256, 256)).astype(np.float32))
    wd = torch.from_numpy(rng.standard_normal((4, 256, 256)).astype(np.float32))
    stream = mask_head_stream(wf, wd)
    assert stream.shape == (1280, 2048) and stream.is_contiguous()
    back_f, back_d = _unpack_stream(stream)
    assert torch.equal(back_f, wf) and torch.equal(back_d, wd)
    n, k = np.meshgrid(np.arange(128), np.arange(16), indexing="ij")
    off = torch.from_numpy((((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8).ravel())
    for layer, p, tap, ks in [(0, 0, 0, 0), (1, 1, 4, 7), (3, 1, 8, 15)]:
        s = ((layer * 2 + p) * 9 + tap) * 16 + ks
        want = wf[layer, tap, 128 * p:128 * p + 128, 16 * ks:16 * ks + 16].reshape(-1)
        assert torch.equal(stream[s][off], want)
    for d, p, ks in [(0, 0, 0), (2, 1, 9), (3, 1, 15)]:
        s = 1152 + (d * 2 + p) * 16 + ks
        want = wd[d, 128 * p:128 * p + 128, 16 * ks:16 * ks + 16].reshape(-1)
        assert torch.equal(stream[s][off], want)
