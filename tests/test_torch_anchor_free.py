"""PyTorch port: the anchor-free header (``hd_yolo_tpu_torch/models/anchor_free_head.py``)
against the JAX package on the same numpy inputs and weights, on the CPU.

* ``make_cell_centers``: exact;
* ``simota_assign``: ``matched_gt`` and ``fg`` exact, the assigned IoU
  within 1e-6 — on random boxes, on a batch against ``jax.vmap``, with
  tied costs (identical predictions, so ``top_k``'s lowest-index-first
  order decides) and with no valid target;
* the ``yolov6s-af`` model at 128 px in f32 with JAX's weights carried by
  ``state_dict_from_flax``: inference outputs (each box corner within
  1e-4 of the box's width or height, ``BOX_RTOL``; scores 1e-5, labels /
  levels / valid equal), the training losses
  (rtol 1e-4) and every parameter's gradient within 1e-3·max|g|, with
  the assignment of each image equal to JAX's.

The header's entry points and its quality tool: ``tests/test_torch_af_quality.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.models import anchor_free_head as jaf
from hd_yolo_tpu_torch.models import anchor_free_head as taf
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables

SIZE, B, T = 128, 2, 8
X_SHAPE = (B, SIZE, SIZE, 3)
# Against the JAX package run in f64 on the same weights and input, JAX's own
# f32 corners are up to 2.4e-5 of the box's width or height off (1.2e-3 px)
# and the port's up to 1.7e-5: summation order, not a fault.  The two f32
# results may then differ by their sum; BOX_RTOL leaves that a factor ~2.4.
BOX_RTOL = 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_cell_centers_exact():
    shapes, strides = [(16, 16), (8, 8), (4, 4)], [8.0, 16.0, 32.0]
    jc, js = jaf.make_cell_centers(shapes, strides)
    tc, ts = taf.make_cell_centers(shapes, strides)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def random_case(rng, N_shapes=((8, 8), (4, 4)), strides=(8.0, 16.0), nc=3, T=6, lead=()):
    centers, strs = jaf.make_cell_centers(N_shapes, strides)
    N = centers.shape[0]
    xy = rng.uniform(0, 48, lead + (N, 2))
    wh = rng.uniform(4, 30, lead + (N, 2))
    pred = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gxy = rng.uniform(0, 40, lead + (T, 2))
    gwh = rng.uniform(6, 24, lead + (T, 2))
    gt = np.concatenate([gxy, gxy + gwh], -1).astype(np.float32)
    return (pred, rng.standard_normal(lead + (N, nc)).astype(np.float32),
            rng.standard_normal(lead + (N,)).astype(np.float32), np.asarray(centers),
            np.asarray(strs), gt, rng.integers(1, nc + 1, lead + (T,)).astype(np.int32),
            rng.uniform(0, 1, lead + (T,)) > 0.25)


def check_assign(args, batched=False):
    fn = jax.vmap(jaf.simota_assign, in_axes=(0, 0, 0, None, None, 0, 0, 0)) if batched \
        else jaf.simota_assign
    jb, jf, ji = (np.asarray(a) for a in fn(*(jnp.asarray(a) for a in args)))
    tb, tf, ti = taf.simota_assign(*(t(a) for a in args))
    assert np.array_equal(tf.numpy(), jf)
    assert np.array_equal(tb.numpy(), jb)
    np.testing.assert_allclose(ti.numpy(), ji, rtol=0, atol=1e-6)
    return jf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_random(seed):
    fg = check_assign(random_case(np.random.default_rng(seed)))
    assert fg.any()


def test_simota_batched_as_vmap():
    fg = check_assign(random_case(np.random.default_rng(5), lead=(3,)), batched=True)
    assert fg.sum() > 3


def test_simota_tied_costs():
    """Every cell predicts the same box with the same logits, so the costs of
    the candidates tie and the order of ``top_k`` decides which cells win."""
    centers, strides = jaf.make_cell_centers([(8, 8)], [8.0])
    N = centers.shape[0]
    pred = np.tile(np.asarray([[14.0, 14.0, 42.0, 42.0]], np.float32), (N, 1))
    gt = np.asarray([[16.0, 16.0, 40.0, 40.0], [8.0, 20.0, 30.0, 50.0]], np.float32)
    args = (pred, np.zeros((N, 3), np.float32), np.zeros((N,), np.float32), np.asarray(centers),
            np.asarray(strides), gt, np.asarray([1, 2], np.int32), np.ones(2, bool))
    fg = check_assign(args)
    assert 0 < fg.sum() < N


def test_simota_no_valid_target():
    centers, strides = jaf.make_cell_centers([(4, 4)], [8.0])
    N = centers.shape[0]
    args = (np.zeros((N, 4), np.float32), np.zeros((N, 2), np.float32),
            np.zeros((N,), np.float32), np.asarray(centers), np.asarray(strides),
            np.zeros((3, 4), np.float32), np.ones((3,), np.int32), np.zeros(3, bool))
    fg = check_assign(args)
    assert not fg.any()


def af_targets(seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.7, (B, T, 2))
    wh = rng.uniform(0.08, 0.25, (B, T, 2))
    valid = np.zeros((B, T), bool)
    valid[0, :6], valid[1, :3] = True, True
    return {"boxes": np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32),
            "labels": rng.integers(1, 5, (B, T)).astype(np.int64), "valid": valid}


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel.from_cfg("yolov6s-af", "hyp-nuclei")
    variables = random_variables(jm, X_SHAPE, seed=3)
    tm = Model.from_cfg("yolov6s-af", "hyp-nuclei")
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    x = np.random.default_rng(4).uniform(0, 1, X_SHAPE).astype(np.float32)
    return jm, variables, tm, x


def test_model_builds_the_anchor_free_header(pair):
    _, _, tm, _ = pair
    assert isinstance(tm.headers["det"], taf.AnchorFreeDetect)
    keys = set(tm.state_dict())
    assert "headers.det.stems.2.bn.running_var" in keys and "headers.det.obj_preds.0.bias" in keys


def test_outputs_match_jax(pair):
    jm, variables, tm, x = pair
    _, want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, jnp.asarray(x))
    want = jax.tree.map(np.asarray, want["det"])
    got = tm.eval()(torch.from_numpy(x))["det"]
    assert set(got) == set(want) == {"boxes", "scores", "labels", "levels", "valid"}
    assert want["valid"].sum() > 50
    assert np.array_equal(got["valid"].numpy(), want["valid"])
    assert np.array_equal(got["labels"].numpy(), want["labels"])
    assert np.array_equal(got["levels"].numpy(), want["levels"])
    # the decode is exp(reg) · stride, so the f32 rounding of the deep random
    # trunk reaches the corners in proportion to the box: each coordinate is
    # held within BOX_RTOL of its box's width (x) or height (y)
    v = want["valid"]
    wh = np.concatenate([want["boxes"][..., 2:] - want["boxes"][..., :2]] * 2, -1)[v]
    err = np.abs(got["boxes"].numpy() - want["boxes"])[v]
    assert (err <= BOX_RTOL * wh).all(), float((err / wh).max())
    assert np.array_equal(got["boxes"].numpy()[~v], want["boxes"][~v])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=0, atol=1e-5)


def test_losses_gradients_and_assignment_match_jax(pair):
    jm, variables, tm, x = pair
    tg = af_targets(7)

    def loss_fn(params):
        (losses, _), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), {"det": {k: jnp.asarray(v) for k, v in tg.items()}},
                                  train=True, mutable=["batch_stats"])
        return jm.total_loss(losses), losses["det"]["loss_items"]

    (jl, jitems), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tm.train()
    tm.zero_grad()
    assigned = []
    orig = taf.simota_assign

    def spy(*a, **k):
        out = orig(*a, **k)
        assigned.append(([v.detach() for v in a], out))
        return out

    taf.simota_assign = spy
    try:
        losses, outputs = tm.losses(torch.from_numpy(x), {"det": {k: t(v) for k, v in tg.items()}})
    finally:
        taf.simota_assign = orig
    total = tm.total_loss(losses)
    total.backward()
    tm.eval()
    assert outputs == {"det": {}}
    assert float(losses["det"]["mask_loss"]) == 0.0
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    for k in ("obj", "cls", "box"):
        np.testing.assert_allclose(float(losses["det"]["loss_items"][k]), float(jitems[k]),
                                   rtol=1e-4, err_msg=k)
    # the batched assignment on the port's own inputs equals JAX's per image
    (args, (tb, tf, ti)), = assigned
    for i in range(B):
        jb, jf, ji = jaf.simota_assign(*(jnp.asarray((a if j in (3, 4) else a[i]).numpy())
                                         for j, a in enumerate(args)))   # centers, strides shared
        assert np.array_equal(tf[i].numpy(), np.asarray(jf))
        assert np.array_equal(tb[i].numpy(), np.asarray(jb))
        np.testing.assert_allclose(ti[i].numpy(), np.asarray(ji), rtol=0, atol=1e-6)
    assert tf.sum() > 10
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jg),
                                 "batch_stats": variables["batch_stats"]}, tm.spec)
    n_head = 0
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-9, (name, err, np.abs(w).max())
        n_head += name.startswith("headers.det.")
    assert n_head == 3 * (3 * 3 + 2 * 3)     # 3 levels x (3 conv + BN pairs, 3 pred convs)


def test_init_weights_gives_flax_defaults_and_no_prior():
    tm = Model.from_cfg("yolov6s-af", "hyp-nuclei")
    tm.init_weights(torch.Generator().manual_seed(0))
    h = tm.headers["det"]
    for m in list(h.cls_preds) + list(h.reg_preds) + list(h.obj_preds):
        assert float(m.bias.abs().max()) == 0.0
    w = h.cls_convs[0].conv.weight
    fan_in = w[0].numel()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05

