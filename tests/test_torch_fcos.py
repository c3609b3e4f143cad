"""PyTorch port, the FCOS header (``hd_yolo_tpu_torch/hnet/fcos.py``) against
the JAX package's ``hnet/fcos.py`` on the same numpy weights (carried by
``fcos_state_dict_from_flax``) and inputs, f32 on the CPU, at the shapes of
``tests/test_fcos.py`` (3 levels of 16/8/4 cells at 128 px, 32 channels).

Tolerances: ``_size_ranges`` exact; towers and head outputs atol 1e-4;
losses rtol 1e-5 + atol 1e-6 (an empty image's too, and per-image
``image_weight``); their gradients within 1e-3 of each tensor's max|g|;
inference: valid and labels exact, boxes atol 1e-3 px, scores atol 1e-5 —
on random features and on features with every location's score tied, where
``lax.top_k``'s order (the lowest index first) picks the candidates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet.fcos import FCOS as JaxFCOS
from hd_yolo_tpu.hnet.fcos import _size_ranges as jax_size_ranges
from hd_yolo_tpu_torch.hnet.fcos import FCOS, _size_ranges
from hd_yolo_tpu_torch.utils.convert import fcos_state_dict_from_flax
from torch_port_common import random_tree

C, SIZE = 32, (128, 128)
KW = dict(num_classes=3, strides=(8.0, 16.0, 32.0), num_detections=10, pre_nms_topk=64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def feats_of(rng, B=1):
    return [rng.uniform(0, 1, (B, 16 >> i, 16 >> i, C)).astype(np.float32) for i in range(3)]


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    feats = feats_of(rng, B=2)
    jm = JaxFCOS(**KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
                                            SIZE))
    v = random_tree(shapes, seed=1)
    m = FCOS(C, **KW)
    m.load_state_dict({k: _t(x) for k, x in fcos_state_dict_from_flax(v["params"]).items()},
                      strict=True)
    return jm, v, m.eval(), feats


def targets(B=2):
    boxes = np.asarray([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9], [0.05, 0.6, 0.95, 0.98]],
                        [[0.2, 0.1, 0.6, 0.3], [0, 0, 0, 0], [0.3, 0.3, 0.36, 0.37]]],
                       np.float32)[:B]
    return {"boxes": boxes, "labels": np.asarray([[1, 3, 2], [2, 0, 1]], np.int32)[:B],
            "valid": np.asarray([[True, True, True], [True, False, True]])[:B]}


def test_size_ranges_exact():
    for n, base in ((3, 64.0), (4, 16.0), (1, 64.0)):
        assert _size_ranges(n, base) == jax_size_ranges(n, base)


def test_towers_and_head_match_jax(pair):
    jm, v, m, feats = pair
    want = jm.apply(v, [jnp.asarray(f) for f in feats], method=JaxFCOS._head)
    with torch.no_grad():
        got = m._head([_t(f) for f in feats])
        tower = m.cls_tower(_t(feats[0]))
    jt = jm.apply(v, jnp.asarray(feats[0]), method=lambda mod, x: mod.cls_tower(x))
    np.testing.assert_allclose(tower.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    for gl, wl in zip(got, want):
        for g, w in zip(gl, wl):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def _losses(jm, v, m, feats, t, weight=None):
    jw = None if weight is None else jnp.asarray(weight)
    want = jm.apply(v, [jnp.asarray(f) for f in feats], SIZE,
                    {k: jnp.asarray(x) for k, x in t.items()}, jw, method=JaxFCOS.compute_losses)
    got = m.compute_losses([_t(f) for f in feats], SIZE, {k: _t(x) for k, x in t.items()},
                           None if weight is None else _t(weight))
    assert set(got) == set(want) == {"fcos_cls_loss", "fcos_reg_loss", "fcos_ctr_loss"}
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        assert np.isfinite(g) and abs(g - w) <= 1e-5 * abs(w) + 1e-6, (k, g, w)
    return got, want


@pytest.mark.parametrize("case", ["targets", "weighted", "empty"])
def test_losses_match_jax(pair, case):
    jm, v, m, feats = pair
    t = targets()
    weight = None
    if case == "weighted":
        weight = np.asarray([1.0, 0.0], np.float32)
    elif case == "empty":
        t = {"boxes": np.zeros((2, 3, 4), np.float32), "labels": np.zeros((2, 3), np.int32),
             "valid": np.zeros((2, 3), bool)}
    with torch.no_grad():
        got, _ = _losses(jm, v, m, feats, t, weight)
        if case == "weighted":            # the second image weighs nothing
            one, _ = _losses(jm, v, m, [f[:1] for f in feats], targets(1))
    if case == "weighted":
        for k in got:
            assert abs(float(got[k]) - float(one[k])) <= 1e-5 * abs(float(one[k]))


def test_loss_gradients_match_jax(pair):
    jm, v, m, feats = pair
    t = targets()

    def loss_fn(params):
        l = jm.apply({"params": params}, [jnp.asarray(f) for f in feats], SIZE,
                     {k: jnp.asarray(x) for k, x in t.items()}, method=JaxFCOS.compute_losses)
        return l["fcos_cls_loss"] + l["fcos_reg_loss"] + l["fcos_ctr_loss"]

    jg = fcos_state_dict_from_flax(jax.tree.map(np.asarray, jax.grad(loss_fn)(v["params"])))
    m.zero_grad()
    l = m.compute_losses([_t(f) for f in feats], SIZE, {k: _t(x) for k, x in t.items()})
    (l["fcos_cls_loss"] + l["fcos_reg_loss"] + l["fcos_ctr_loss"]).backward()
    got = dict(m.named_parameters())
    assert set(got) == set(jg)
    for name, w in jg.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[name].grad.numpy(), w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-6), err_msg=name)
    m.zero_grad()


def _infer(jm, v, m, feats):
    want = jax.tree.map(np.asarray, jm.apply(v, [jnp.asarray(f) for f in feats], SIZE,
                                             method=JaxFCOS.infer))
    with torch.no_grad():
        got = {k: x.numpy() for k, x in m.infer([_t(f) for f in feats], SIZE).items()}
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid"}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    assert (got["labels"][~got["valid"]] == -100).all()
    return got


def test_infer_matches_jax(pair):
    got = _infer(*pair)
    assert got["valid"].sum() >= 10


def test_infer_with_tied_scores_matches_jax(pair):
    """Constant features: every location of a level has the same logits and
    regression, so the scores tie and ``top_k``'s order picks the cells."""
    jm, v, m, _ = pair
    feats = [np.full((2, 16 >> i, 16 >> i, C), 0.5, np.float32) for i in range(3)]
    got = _infer(jm, v, m, feats)
    assert got["valid"].any()


def test_forward_returns_losses_and_detections(pair):
    _, _, m, feats = pair
    with torch.no_grad():
        losses, out = m([_t(f) for f in feats], SIZE, {k: _t(x) for k, x in targets().items()})
    assert set(losses) == {"fcos_cls_loss", "fcos_reg_loss", "fcos_ctr_loss"}
    assert out["boxes"].shape == (2, 10, 4) and out["valid"].dtype == torch.bool
