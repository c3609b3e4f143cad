"""PyTorch port, fused mask head: the plain ``fused_mask_probs`` against the
JAX ``fused_mask_probs(interpret=True)`` and against ``sigmoid(MaskHead)`` +
per-ROI channel select (copies
``tests/test_pallas.py::test_pallas_mask_head_matches_flax``).
Tolerance: atol 1e-5, f32.  Also the ``active`` prefix (slots at or past
it exactly 0), the bf16 kernel's packed weight stream, and the f32
kernel's split-TF32 stream and arithmetic, emulated on the CPU at the
kernel's width (C = 256) against the JAX kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models.detect_head import MaskHead as JaxMaskHead
from hd_yolo_tpu.ops.pallas_mask_head import fused_mask_probs as jax_fused_mask_probs
from hd_yolo_tpu.ops.pallas_mask_head import mask_head_pallas
from hd_yolo_tpu_torch import kernels
from hd_yolo_tpu_torch.models.detect_head import MaskHead
from hd_yolo_tpu_torch.ops.pallas_mask_head import (_deinterleave, fused_mask_probs, kernel_weights,
                                                     kernel_weights_f32, mask_head_stream,
                                                     split_tf32, tf32_round)

N, M, C, NC = 11, 14, 32, 5
# the f32 kernel's width, and a few ROIs: 4 x 196 = 784 flat rows, so the
# kernel's 128-row tiles span ROI boundaries
NW, CW = 4, 256


def _params(rng, C=C):
    """Random flax MaskHead params (numpy) and the port's head loaded with them."""
    head = JaxMaskHead(nc_masks=NC, dim_reduced=C, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), jnp.zeros((1, M, M, C))))
    p = {}
    for name, node in shapes["params"].items():
        k = node["kernel"].shape
        p[name] = {"kernel": (rng.standard_normal(k) * np.sqrt(2.0 / np.prod(k[:-1])))
                   .astype(np.float32),
                   "bias": (rng.standard_normal(node["bias"].shape) * 0.05).astype(np.float32)}
    th = MaskHead(NC, C, C)
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


@pytest.fixture
def wide(rng):
    """The f32 kernel's width: params, head and inputs at C = 256, NW ROIs."""
    head, v, th = _params(rng, CW)
    x = rng.standard_normal((NW, M, M, CW)).astype(np.float32)
    labels = rng.integers(0, NC, (NW,)).astype(np.int32)
    return head, v, th, x, labels


# element (co, k) of a 128 co x 8 ci half-slice: wgmma's no-swizzle K-major
# core matrices for 32-bit operands (8 co x 4 ci, 16-byte rows), LBO 128 B, SBO 256 B
_CO, _K = np.meshgrid(np.arange(128), np.arange(8), indexing="ij")
_OFF = torch.from_numpy(((_CO // 8) * 2 + _K // 4) * 32 + (_CO % 8) * 4 + _K % 4)


def _unpack_stream_f32(stream):
    """(2560, 2, 1024) stream, read as the kernel reads it → per half (hi,
    lo): wf (2, 4, 9, ci, co) and wd (2, 4, ci, co)."""
    t = stream[:, :, _OFF]                                   # (slice, half, co, k)
    conv = t[:2304].reshape(4, 2, 9, 32, 2, 128, 8).permute(4, 0, 2, 3, 6, 1, 5)
    dec = t[2304:].reshape(4, 2, 32, 2, 128, 8).permute(3, 0, 2, 5, 1, 4)
    return conv.reshape(2, 4, 9, 256, 256), dec.reshape(2, 4, 256, 256)


def _product(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor, passes: int):
    """The card's product of f32 rows ``a`` with split weights: passes 3 is
    the kernel's lo·hi + hi·lo + hi·hi (each TF32 product exact, summed in
    f64 here), passes 1 a single TF32 pass; rounded to the f32 accumulator."""
    a_hi, a_lo = split_tf32(a)
    acc = a_hi.double() @ b_hi.double()
    if passes == 3:
        acc = a_lo.double() @ b_hi.double() + a_hi.double() @ b_lo.double() + acc
    return acc.float()


def emulate_mask_head_f32(stream, bf, bd, wl, bl, x, labels, passes=3):
    """The f32 kernel's arithmetic on the CPU: each layer one product over
    the flat pixel rows (N·196, K) with the stream's split weights, f32
    epilogues (bias, ReLU; the deconv's selected-logit dot, bias, sigmoid).
    Returns (pre-bias selected logits (N, 4, 196), probabilities (N, 28, 28))."""
    wf, wd = _unpack_stream_f32(stream)
    n, C = x.shape[0], x.shape[-1]
    h = x.reshape(n * M * M, C)
    for layer in range(4):
        xp = torch.nn.functional.pad(h.reshape(n, M, M, C), (0, 0, 1, 1, 1, 1))
        rows = torch.cat([xp[:, ky:ky + M, kx:kx + M].reshape(n * M * M, C)
                          for ky in range(3) for kx in range(3)], -1)
        h = torch.relu(_product(rows, wf[0, layer].reshape(9 * C, C),
                                wf[1, layer].reshape(9 * C, C), passes) + bf[layer])
    wl_rows = wl[labels.long()].repeat_interleave(M * M, 0)              # (rows, C)
    taps = [(torch.relu(_product(h, wd[0, d], wd[1, d], passes) + bd).double() * wl_rows)
            .sum(-1).float() for d in range(4)]
    o = torch.stack(taps, 1).reshape(n, M * M, 4).permute(0, 2, 1)
    probs = torch.sigmoid(o + bl[labels.long()][:, None, None])
    return o, _deinterleave(probs.reshape(n, 4, M, M))


def _jax_logits(v, x, labels):
    """JAX's kernel in interpret mode, f32: (N, 4, 196) pre-bias selected logits."""
    p = v["params"]
    wf = jnp.stack([p[f"fcn{i}"]["kernel"].reshape(9, CW, CW) for i in range(4)])
    bf = jnp.stack([p[f"fcn{i}"]["bias"] for i in range(4)])
    wd = jnp.asarray(p["deconv"]["kernel"][::-1, ::-1].reshape(4, CW, CW))
    wl_sel = jnp.asarray(p["logits"]["kernel"][0, 0].T[labels])
    return np.asarray(mask_head_pallas(jnp.asarray(x), wf, bf, wd, jnp.asarray(p["deconv"]["bias"]),
                                       wl_sel, g=4, interpret=True))


def test_tf32_split_rounds_to_nearest_and_keeps_the_remainder(rng):
    """hi = tf32(a): the nearest value with the low 13 mantissa bits zero,
    ties away from zero (``cvt.rna``); lo = tf32(a - hi), a - hi exact; hi +
    lo within 2^-22·|a| of a."""
    a = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
                        [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11, 0.0,
                         2.0 ** -11 - 2.0 ** -24]]).astype(np.float32)
    hi, lo = split_tf32(torch.from_numpy(a))
    bits = np.asarray(hi.numpy()).view(np.uint32)
    assert (bits & 0x1FFF == 0).all() and (lo.numpy().view(np.uint32) & 0x1FFF == 0).all()
    # the nearest of the two TF32 neighbours, by exact f64 distance; ties go outwards
    down = (a.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    up = down + np.sign(a) * np.ldexp(1.0, np.frexp(np.abs(down) + (down == 0))[1] - 11)
    d_down, d_up = np.abs(a - down), np.abs(up - a)
    want = np.where(d_up <= d_down, up, down)
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), want)
    assert hi[-5] == np.float32(1.0 + 2.0 ** -10) and hi[-4] == -hi[-5]
    assert torch.equal(tf32_round(torch.from_numpy(a)), hi)
    rem = a.astype(np.float64) - hi.numpy().astype(np.float64)
    assert (np.abs(rem - lo.numpy()) <= 2.0 ** -11 * np.abs(rem)).all()
    assert (np.abs(a - hi.numpy().astype(np.float64) - lo.numpy()) <= 2.0 ** -22 * np.abs(a)).all()


def test_f32_kernel_weight_layouts(wide):
    """The f32 kernel's weight stream: 2560 k8-slices of 128 output columns
    (convs (layer, pass, tap, ks), then the deconv's (d, pass, ks)), each a
    hi and a lo half in wgmma's no-swizzle K-major layout.  Every hi and lo is TF32 (low 13 bits zero),
    hi + lo is the weight to 2^-22, and the stream used as the kernel uses
    it (split products over flat rows) rebuilds the first conv and the
    deconv taps, and the chain reproduces the JAX kernel (interpret mode)."""
    head, v, th, x, labels = wide
    stream, bf, bd, wl, bl = kernel_weights_f32(th)
    assert stream.shape == (2560, 2, 1024) and stream.dtype == torch.float32
    assert stream.is_contiguous() and bf.shape == (4, CW) and wl.shape == (NC, CW)
    assert (stream.view(torch.int32) & 0x1FFF == 0).all()
    wf, wd = _unpack_stream_f32(stream)
    wf_ref, _, wd_ref, _ = kernel_weights(th, torch.float32)      # (4, 9, co, ci), (4, co, ci)
    for got, ref in ((wf[0] + wf[1], wf_ref.transpose(-1, -2)), (wd[0] + wd[1], wd_ref.transpose(-1, -2))):
        assert ((got.double() - ref.double()).abs() <= 2.0 ** -22 * ref.double().abs()).all()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        conv = th.fcn[0]
        want = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2).double(), conv.weight.double(),
                                          padding=1).permute(0, 2, 3, 1).reshape(-1, CW)
        xp = torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1))
        rows = torch.cat([xp[:, ky:ky + M, kx:kx + M].reshape(-1, CW)
                          for ky in range(3) for kx in range(3)], -1)
        got = _product(rows, wf[0, 0].reshape(9 * CW, CW), wf[1, 0].reshape(9 * CW, CW), 3)
        torch.testing.assert_close(got.double(), want, rtol=0, atol=2e-5)
        dec = th.maskrcnn_preds.conv5_mask
        full = torch.nn.functional.conv_transpose2d(xt.permute(0, 3, 1, 2).double(),
                                                    dec.weight.double(), stride=2)
        taps = torch.stack([_product(xt.reshape(-1, CW), wd[0, d], wd[1, d], 3)
                            .reshape(NW, M, M, CW).permute(0, 3, 1, 2) for d in range(4)], 2)
        for o in range(0, CW, 37):
            torch.testing.assert_close(_deinterleave(taps[:, o]).double(), full[:, o], rtol=0,
                                       atol=2e-5)
        _, probs = emulate_mask_head_f32(stream, bf, bd, wl, bl, xt, torch.from_numpy(labels))
    want = jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                interpret=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_f32_split_emulation_matches_jax_kernel(wide):
    """The kernel's split-TF32 arithmetic through the whole chain, emulated
    on the CPU, is within 1e-5 of JAX's ``mask_head_pallas(interpret=True)``
    in f32, on the pre-bias logits and on the probabilities."""
    head, v, th, x, labels = wide
    with torch.no_grad():
        logits, probs = emulate_mask_head_f32(*kernel_weights_f32(th), torch.from_numpy(x),
                                              torch.from_numpy(labels))
    np.testing.assert_allclose(logits.numpy(), _jax_logits(v, x, labels), rtol=0, atol=1e-5)
    want = jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                interpret=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_single_pass_tf32_misses_the_limit(wide):
    """One TF32 pass (hi·hi only) keeps ~3 decimal digits: the same chain is
    more than 1e-5 off JAX's f32 kernel, on the logits and on the
    probabilities, so a kernel that drops the lo terms fails the 1e-5 limit."""
    head, v, th, x, labels = wide
    with torch.no_grad():
        logits, probs = emulate_mask_head_f32(*kernel_weights_f32(th), torch.from_numpy(x),
                                              torch.from_numpy(labels), passes=1)
    want = jax_fused_mask_probs(v["params"], jnp.asarray(x), jnp.asarray(labels), g=4,
                                interpret=True)
    assert np.abs(logits.numpy() - _jax_logits(v, x, labels)).max() > 1e-4
    assert np.abs(probs.numpy() - np.asarray(want)).max() > 1e-5


def test_f32_kernel_constants_match_the_stream(wide):
    """The f32 kernel's plan, read from its source, agrees with the wrapper's
    stream (4 convs of (pass, tap, ks) slices, then the deconv's (d, pass,
    ks), each a hi and a lo half of 128 co x 8 ci); its k-steps go in pairs
    within one tap; the partial is promoted at least once a tap (a conv's
    K in one tensor-core accumulator is ~14x less accurate on the card); the
    staged rows and the ring fit the 227 KB of shared memory a block."""
    c = kernels.constants("mask_head_f32")
    stream = kernel_weights_f32(wide[2])[0]
    assert c["C"] == CW == 8 * c["KSTEPS"] == 2 * c["NH"]
    assert c["CONV_SLICES"] == 2 * 9 * c["KSTEPS"] and c["DECONV_SLICES"] == 4 * 2 * c["KSTEPS"]
    assert stream.shape == (4 * c["CONV_SLICES"] + c["DECONV_SLICES"], 2, c["NH"] * 8)
    assert stream[0].numel() * 4 == c["SLICE"] == 2 * c["HALF"]
    assert c["KSTEPS"] % 2 == 0 and c["PROMOTE"] % 2 == 0 and c["PROMOTE"] <= c["KSTEPS"]
    assert c["WIN"] == c["BM"] + 2 * (M + 1) and c["SMEM_BYTES"] <= 227 * 1024


def test_f32_kernel_inputs_are_checked_off_the_cpu(wide):
    """Off the CPU the f32 form launches its kernel or raises: features not
    (N, 14, 14, 256) raise before anything is built, and inputs that are not
    all on one CUDA device raise (meta tensors here: there is no card)."""
    th = wide[2]
    labels = torch.zeros(3, dtype=torch.int64, device="meta")
    with torch.no_grad():
        with pytest.raises(ValueError, match=r"\(N, 14, 14, 256\)"):
            fused_mask_probs(th, torch.empty((3, 14, 14, 128), device="meta"), labels)
        with pytest.raises(ValueError, match="one CUDA device"):
            fused_mask_probs(th, torch.empty((3, 14, 14, CW), device="meta"), labels)
        with pytest.raises(ValueError, match="one CUDA device"):
            fused_mask_probs(th, torch.empty((3, 14, 14, CW), device="meta"), labels,
                             torch.tensor(2, device="meta"))


def test_f32_stream_is_packed_once_per_weight_state(wide):
    """The split stream is built once per weight state: a second call reuses
    it, an in-place weight update packs it anew, equal to a fresh
    ``kernel_weights_f32``."""
    th = wide[2]
    pooled = torch.empty((3, 14, 14, CW), device="meta")
    labels = torch.zeros(3, dtype=torch.int64, device="meta")

    def packed():
        with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):
            fused_mask_probs(th, pooled, labels)
        return th.__dict__["_cached_kernel_weights_f32"][1]

    first = packed()
    assert packed() is first
    with torch.no_grad():
        th.fcn[2].weight.mul_(0.5)
    again = packed()
    assert again is not first and not torch.equal(again[0], first[0])
    for got, want in zip(again, kernel_weights_f32(th)):
        assert torch.equal(got, want)


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
