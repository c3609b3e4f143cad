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
         (37, 91, 6, 2, 2, 3, 64),          # odd sizes: the TPU kernel pads past H+2p
         (36, 150, 6, 2, 2, 3, 80)]         # yolov5x6's stem, N 80; its output crosses a window


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
    ((16, 640, 640, 3), (6, 6, 3, 80), 2, 2, torch.bfloat16, "direct"),  # yolov5x6, bf16
    ((2, 640, 640, 3), (6, 6, 3, 80), 2, 2, torch.float32, "direct"),    # yolov5x6, f32
    ((4, 1280, 1280, 3), (6, 6, 3, 64), 2, 2, torch.float32, "direct"),  # f32 at 1280 px
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


def _direct_plan(H, W, C, k, s, p, N, bf16, rows):
    """The direct kernel's (stem.cu) geometry, from its own constants: K
    pairs of k row segments of k·C floats, k-steps of 8 pairs (bf16) or 4
    (split TF32), windows of TW output columns, ring slots of a window's
    input columns, a ring step of ``rows`` output rows and its shared bytes
    at N tile ``nb``."""
    c = kernels.constants("stem")
    L = k * C
    lp = (L + 1) // 2
    pstep = 8 if bf16 else 4
    ksteps = -(-k * lp // pstep)
    slot_floats = (((c["TW"] - 1) * s + k) * C + 4 + 3) & ~3
    nslot = (2 * rows - 1) * s + k

    def smem(nb, bwords):
        stage = 8 * 16 * (nb // 2 + 4) if bf16 else 0
        fixed = ksteps * (nb // 8) * 32 * bwords * 4 + stage * 4 + 2 * nb * 4 + ksteps * pstep * 4
        return ((fixed + 15) & ~15) + nslot * slot_floats * 4

    return dict(L=L, lp=lp, npairs=k * lp, pstep=pstep, ksteps=ksteps, TW=c["TW"], MT=c["MT"],
                slot_floats=slot_floats, nslot=nslot, rows=rows, smem=smem)


def _direct_emulate(x, w, scale, bias, k, s, p, bf16, rows=4, runs=1):
    """The direct kernel's arithmetic on the CPU, block by block as it runs:
    per (image, run of output rows, 64-column window) a ring of raw input
    rows, each slot the window's floats from the 16-byte boundary at or
    before its first one (zero outside the image); the pair table (an odd
    k·C's last pair padded); each warp's 16 pixels' A rows read from the
    ring at the pair offsets; then bf16 operands with an exact product, or
    split TF32 k-step by k-step into the two accumulators, and the
    epilogue."""
    B, H, W, C = x.shape
    N = w.shape[-1]
    Ho, Wo = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1
    P = _direct_plan(H, W, C, k, s, p, N, bf16, rows)
    L, lp, sf, nslot, TW = P["L"], P["lp"], P["slot_floats"], P["nslot"], P["TW"]
    npp = P["ksteps"] * P["pstep"]
    q = torch.arange(npp)
    live = q < P["npairs"]
    ky, j = q // lp, 2 * (q % lp)
    off = torch.where(live, ky * sf + j, torch.zeros_like(q))
    pad_hi = live & (j + 1 == L)
    # the weight in pair order: row (q, e) is weight row ky·L + j + e, or zero
    wrow = ky[:, None] * L + j[:, None] + torch.arange(2)[None]
    wok = live[:, None] & (j[:, None] + torch.arange(2)[None] < L)
    wk = torch.cat([w.reshape(k * k * C, N), torch.zeros((1, N))])
    Bm = wk[torch.where(wok, wrow, torch.full_like(wrow, k * k * C))].reshape(2 * npp, N)
    A_rows, dst = [], []
    rows_per_run = -(-Ho // runs)
    ring_len = nslot * sf
    for b in range(B):
        xb = x[b].reshape(H, W * C)
        for oy0 in range(0, Ho, rows_per_run):
            oy1 = min(Ho, oy0 + rows_per_run)
            iy_base = oy0 * s - p
            for ox_base in range(0, Wo, TW):
                f0 = (ox_base * s - p) * C
                fbase = f0 - f0 % 4
                lead = f0 - fbase
                lo = min(max(0, -fbase), sf)
                hi = max(lo, min(W * C - fbase, sf))
                ring = torch.zeros(ring_len)

                def load(r0, n):
                    for r in range(r0, r0 + n):
                        iy, sl = iy_base + r, (r % nslot) * sf
                        ring[sl + lo:sl + hi] = (xb[iy, fbase + lo:fbase + hi]
                                                 if 0 <= iy < H else 0.0)

                step_in = (rows - 1) * s + k
                load(0, step_in)
                slot0 = 0
                for oy in range(oy0, oy1, rows):
                    if oy + rows < oy1:
                        load((oy - oy0) * s + step_in, rows * s)
                    for ri in range(min(rows, oy1 - oy)):
                        rs = slot0 + ri * s
                        rs -= nslot if rs >= nslot else 0
                        o = off + rs * sf
                        o = torch.where(o >= ring_len, o - ring_len, o)
                        for ox0 in range(ox_base, min(ox_base + TW, Wo), 16):
                            ox = torch.arange(ox0, ox0 + 16)
                            px = lead + (ox.clamp(max=Wo - 1) - ox_base) * s * C
                            a = torch.stack([ring[o[None] + px[:, None]],
                                             ring[o[None] + px[:, None] + 1]], -1)
                            a[:, :, 1][:, pad_hi] = 0.0
                            a[:, ~live] = 0.0
                            keep = ox < Wo
                            A_rows.append(a.reshape(16, 2 * npp)[keep])
                            dst.append(((b * Ho + oy + ri) * Wo + ox[keep]))
                    slot0 += rows * s
                    slot0 -= nslot if slot0 >= nslot else 0
    A = torch.cat(A_rows)
    order = torch.cat(dst)
    assert sorted(order.tolist()) == list(range(B * Ho * Wo))   # every pixel once
    if bf16:
        acc = (A.to(torch.bfloat16).double() @ Bm.to(torch.bfloat16).double()).float()
    else:
        ah, al = split_tf32(A)
        bh, bl = split_tf32(Bm)
        small = torch.zeros((A.shape[0], N))
        big = torch.zeros((A.shape[0], N))
        for ks in range(P["ksteps"]):
            cols = slice(2 * P["pstep"] * ks, 2 * P["pstep"] * (ks + 1))
            small = small + al[:, cols] @ bh[cols]
            small = small + ah[:, cols] @ bl[cols]
            big = big + ah[:, cols] @ bh[cols]
        acc = small + big
    y = torch.nn.functional.silu(acc * scale + bias)
    out = torch.empty((B * Ho * Wo, N))
    out[order] = y
    out = out.reshape(B, Ho, Wo, N)
    return out.to(torch.bfloat16) if bf16 else out


DIRECT_SHAPES = [(2,) + c for c in CASES] + [
    (2, 30, 150, 6, 2, 2, 1, 64), (2, 30, 150, 6, 2, 2, 2, 64), (2, 30, 150, 6, 2, 2, 4, 64),
    (1, 16, 1300, 6, 2, 2, 3, 64)]              # C 1 / 2 / 4 across a window edge; wider than 720


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,K,s,p,C,N", DIRECT_SHAPES)
def test_stem_direct_operands_reproduce_plain(rng, B, H, W, K, s, p, C, N, bf16):
    """The direct kernel's operands and data flow — its K-pair table, its
    64-column windows with their halo and the zero padding at a window's and
    the image's edges, its ring of raw rows, and bf16 operands or split-TF32
    products — give the plain stem within one bf16 ulp (bf16) or 1e-5
    (f32).  Two runs of output rows: the second starts mid-image."""
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((K, K, C, N)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    xt, wt, st, bt = map(torch.from_numpy, (x, w, scale, bias))
    od = torch.bfloat16 if bf16 else torch.float32
    plain = stem_conv_plain(xt, wt, st, bt, stride=s, padding=p, out_dtype=od).float()
    got = _direct_emulate(xt, wt, st, bt, K, s, p, bf16, runs=2).float()
    if bf16:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 2])
def test_stem_direct_shallow_ring_and_odd_segments(rng, rows):
    """The ring at 1 and 2 output rows a step (plans where shared memory is
    short), with k·C odd (3x3/s3 over 3 channels: each segment's last pair
    padded) and an odd s·C, where the kernel reads each pair as two floats."""
    x = torch.from_numpy(rng.standard_normal((1, 33, 200, 3)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(np.float32))
    for bf16, od in ((True, torch.bfloat16), (False, torch.float32)):
        plain = stem_conv_plain(x, w, scale, bias, stride=3, padding=1, out_dtype=od).float()
        got = _direct_emulate(x, w, scale, bias, 3, 3, 1, bf16, rows=rows, runs=3).float()
        tol = dict(rtol=2 ** -7, atol=1e-6) if bf16 else dict(rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol)


def _old_direct_smem(W, C, k, s, N):
    """The shared bytes the earlier direct kernel (f32 FMAs) needed: the whole f32
    weight and a 4 x 64 tile's input window."""
    return 4 * (k * k * C * N + (3 * s + k) * (63 * s + k) * C)


def test_stem_direct_plan_fits_every_shape_the_old_kernel_took():
    """Over the family (C 1–4, s 2–16, k a multiple of s up to 64, N 8–256)
    every shape the old direct kernel could launch has a plan here: the
    smallest, N tile 8 at one output row a step, fits in 227 KB, with
    split-TF32 weights staged whole where their split does not (k >= 54 at
    C 1: the kernel's last form)."""
    limit = kernels.constants("stem")["SMEM_LIMIT"]
    fits = whole = 0
    for C in range(1, 5):
        for s in range(2, 17):
            for k in range(s, 65, s):
                for N in (8, 16, 64, 80, 256):
                    if _old_direct_smem(640, C, k, s, N) > limit:
                        continue
                    for bf16 in (True, False):
                        P = _direct_plan(64, 640, C, k, s, 0, N, bf16, 1)
                        smallest = P["smem"](8, 2)     # bf16, or split TF32 from whole weights
                        assert smallest <= limit, (C, s, k, N, bf16, smallest)
                        fits += 1
                        whole += not bf16 and P["smem"](8, 4) > limit
    assert fits > 200 and whole > 0
