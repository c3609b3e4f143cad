"""PyTorch port, the stem lab (``hd_yolo_tpu_torch/tools/stem_lab.py``)
against the JAX lab (``tools/stem_lab.py``) at B=2, IMG=64.

The JAX lab reads its shapes from the environment at import, so it is
loaded by path with ``B`` and ``IMG`` set; its two Pallas kernels run in
interpret mode (its module-level ``pl`` is swapped for a namespace whose
``pallas_call`` passes ``interpret=True``).  Inputs are the JAX lab's own
numpy draws (seed 0), handed to both sides.

Tolerances: ``s2d`` and ``w_108`` are bf16 casts of the same f32 values and
must be equal; the shared plain version of kernels 6 and 7 accumulates in
f32 in another order than the JAX kernels, so it is held to one bf16 ulp of
the output, |d| <= 1e-3 + 2^-7·|jax|.
"""

import functools
import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from hd_yolo_tpu_torch.tools import stem_lab

LAB_PATH = Path(__file__).resolve().parent.parent / "tools" / "stem_lab.py"


@pytest.fixture(scope="module")
def jax_lab():
    mp = pytest.MonkeyPatch()
    mp.setenv("B", "2")
    mp.setenv("IMG", "64")
    try:
        spec = importlib.util.spec_from_file_location("jax_stem_lab_b2_img64", LAB_PATH)
        lab = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(lab)
    finally:
        mp.undo()
    pl = lab.pl
    lab.pl = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                   BlockSpec=pl.BlockSpec)
    return lab


def _inputs(lab):
    return [torch.from_numpy(np.asarray(a)) for a in (lab.x_host, lab.w_host, lab.scale_host,
                                                      lab.bias_host)]


def _bf16_np(t):
    return t.float().numpy()


def test_s2d_and_w108_match_jax(jax_lab):
    import jax.numpy as jnp

    x, w, _, _ = _inputs(jax_lab)
    want = np.asarray(jax_lab.s2d(jnp.asarray(jax_lab.x_host)).astype(jnp.float32))
    got = stem_lab.s2d(x)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 34, 34, 12)
    np.testing.assert_array_equal(_bf16_np(got), want)
    np.testing.assert_array_equal(_bf16_np(stem_lab.w_108(w)),
                                  np.asarray(jax_lab.w_108().astype(jnp.float32)))
    np.testing.assert_array_equal(_bf16_np(stem_lab.w_dense(w)),
                                  np.asarray(jax_lab.w_dense().astype(jnp.float32)))


@pytest.mark.parametrize("kernel", ["pallas_k108", "pallas_dot108"])
def test_plain_matches_jax_kernels(jax_lab, kernel):
    import jax.numpy as jnp

    x, w, sc, bi = _inputs(jax_lab)
    want = getattr(jax_lab, kernel)(jnp.asarray(jax_lab.x_host), jnp.asarray(jax_lab.w_host),
                                    jnp.asarray(jax_lab.scale_host),
                                    jnp.asarray(jax_lab.bias_host), bh=8)
    want = np.asarray(want.astype(jnp.float32))
    got = stem_lab.stem_k108_plain(x, w, sc, bi)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 32, 32, 64)
    d = np.abs(_bf16_np(got) - want)
    assert (d <= 1e-3 + 2 ** -7 * np.abs(want)).all(), d.max()
    # the CPU wrappers of both kernels are that plain version
    for fn in (stem_lab.stem_k108, stem_lab.stem_dot108):
        torch.testing.assert_close(fn(x, w, sc, bi), got, rtol=0, atol=0)


def test_plain_matches_direct_conv(jax_lab):
    """The K=108 recast computes the stem: the plain version against the
    f32 conv of the same bf16-rounded operands."""
    x, w, sc, bi = _inputs(jax_lab)
    got = stem_lab.stem_k108_plain(x, w, sc, bi).float()
    want = stem_lab.reference(x, w, sc, bi).float()
    assert ((got - want).abs() <= 1e-3 + 2 ** -7 * want.abs()).all()


@pytest.mark.parametrize("img", [32, 30])
def test_main_on_cpu_prints_every_candidate(capsys, img):
    recs = stem_lab.main(["--device", "cpu", "--batch", "1", "--img", str(img), "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["name"] for r in lines] == list(stem_lab.CANDIDATES) == [r["name"] for r in recs]
    for r in lines:
        assert r["device"] == "cpu" and r["ms_per_batch"] > 0
        assert 0 <= r["max_abs_err"] < 0.05, r


def test_main_rejects_unknown_candidate():
    with pytest.raises(SystemExit):
        stem_lab.main(["--device", "cpu", "--img", "16", "--only", "pallas_v2"])


def test_wrappers_reject_other_shapes_on_cuda_tensors():
    """On a CPU tensor a wrapper is the plain version; the shape checks guard
    the kernel path (reached only with a CUDA tensor)."""
    with pytest.raises(ValueError):
        stem_lab._check(torch.zeros(1, 8, 8, 4), torch.zeros(6, 6, 3, 64))
    with pytest.raises(ValueError):
        stem_lab._check(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 3, 64))


def _k108_row(k):
    """``stem_k108.cu``'s input row of K index k (S2dOrder::row), relative to
    2oy - 2: k = 12·(3ky' + kx') + 6·dy + 3·dx + c reads row 2ky' + dy."""
    g = k // 6
    return 2 * ((g >> 1) // 3) + (g & 1)


def _k108_col(k):
    """``stem_k108.cu``'s float offset of K index k in a raw image row
    (S2dOrder::col), relative to 6ox - 6: 6kx' + (k mod 6)."""
    return 6 * ((k // 12) % 3) + k % 6


def _k108_wrow(k):
    """``stem_k108.cu``'s row of the (6, 6, 3, 64) weight seen as (108, 64)
    in (ky, kx, c) order that K index k multiplies (S2dOrder::wrow)."""
    kx = 2 * ((k // 12) % 3) + (k % 6) // 3
    return (_k108_row(k) * 6 + kx) * 3 + k % 3


@pytest.mark.parametrize("H,W", [(16, 16), (13, 22), (9, 6)])
def test_stem_k108_raw_row_reads_match_s2d_operands(H, W):
    """A numpy model of ``stem_k108``'s raw-row A operand: for every output
    pixel and every k < 108, the element it reads from the raw f32 rows
    (row 2oy-2 + row(k), float 6ox-6 + col(k) of the row's 3W floats, zero
    outside the image) is, rounded to bf16, the s2d/im2col value that
    ``w_108``'s row k multiplies, and the weight row it stages for k
    (``wrow``, rounded to bf16) is ``w_108``'s row k; each bf16 pair (k,
    k+1), k even, is two adjacent floats of one row (one 8-byte shared
    load)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    Ho, Wo = stem_lab.out_size(H), stem_lab.out_size(W)
    cols = stem_lab.im2col108(stem_lab.s2d(torch.from_numpy(x)), Ho, Wo)[0].float().numpy()
    flat = x[0].reshape(H, 3 * W)
    for k in range(0, 108, 2):
        assert _k108_row(k + 1) == _k108_row(k) and _k108_col(k + 1) == _k108_col(k) + 1
    for oy in range(Ho):
        for ox in range(Wo):
            for k in range(108):
                r, f = 2 * oy - 2 + _k108_row(k), 6 * ox - 6 + _k108_col(k)
                v = flat[r, f] if 0 <= r < H and 0 <= f < 3 * W else 0.0
                v = torch.tensor(v).to(torch.bfloat16).float().item()
                assert v == cols[oy, ox, k], (oy, ox, k)
    w = (rng.standard_normal((6, 6, 3, 64)) * 0.1).astype(np.float32)
    w108 = stem_lab.w_108(torch.from_numpy(w))
    staged = torch.from_numpy(w.reshape(108, 64)[[_k108_wrow(k) for k in range(108)]])
    assert torch.equal(staged.to(torch.bfloat16), w108)
    # and the product of those operands with w_108 is the plain stem
    sc, bi = np.ones(64, np.float32), np.zeros(64, np.float32)
    acc = torch.from_numpy(cols).double() @ stem_lab.w_108(torch.from_numpy(w)).double()
    got = torch.nn.functional.silu(acc.float()).to(torch.bfloat16).float()
    want = stem_lab.stem_k108_plain(*map(torch.from_numpy, (x, w, sc, bi)))[0].float()
    assert ((got - want).abs() <= 1e-3 + 2 ** -7 * want.abs()).all()
