"""PyTorch port: the device augmentation recipe (``hd_yolo_tpu_torch/data/
device_augment.py`` and the HSV jitter of ``data/preproc.py``) against the
JAX package's ``hd_yolo_tpu/data/device_augment.py`` on the same numpy
inputs, on the CPU, at S 96, B 4, T 16: each ported function within atol
1e-5, and the whole recipe at ``k_mosaic`` 1 and 2, with and without mixup
and the photometric extras, on JAX's own draws (``jax_draws`` replays the
key splits of ``make_device_augment``) — images, boxes and masks within
1e-5, labels, valid and active flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.data import device_augment as jda
from hd_yolo_tpu.data import preproc as jpre
from hd_yolo_tpu_torch.data import device_augment as tda
from hd_yolo_tpu_torch.data import preproc as tpre

B, S, T, M = 4, 96, 16, 28
HYP = {"scale": 0.5, "translate": 0.1, "fliplr": 0.5, "flipud": 0.5, "transpose": 0.5,
       "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}
HYP_EXTRAS = {**HYP, "mixup": 0.5, "photometric": 1.0}
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0)


def raw_batch(seed=0, n=B, size=S, tasks=("det",)):
    """A raw-mode batch: uint8 tiles and padded normalized targets (some
    boxes hanging off the tile edge, some slots invalid)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    targets = {}
    for task in tasks:
        xy = rng.uniform(-0.1, 0.85, (n, T, 2))
        wh = rng.uniform(0.08, 0.4, (n, T, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        targets[task] = {"boxes": boxes, "labels": rng.integers(1, 5, (n, T)),
                         "masks": (rng.uniform(0, 1, (n, T, M, M)) > 0.4).astype(np.float32),
                         "valid": rng.uniform(0, 1, (n, T)) < 0.8,
                         "active": np.ones(n, bool)}
    return {"image": img, "targets": targets}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return t(tree)


def jax_draws(key, n, size, hyp, k_mosaic):
    """JAX's own random numbers of ``make_device_augment(hyp, k_mosaic)``'s
    ``augment(key, batch)``, replayed split by split as the port's draws."""
    u = jax.random.uniform
    sc, tr = float(hyp.get("scale", 0.5)), float(hyp.get("translate", 0.1))
    p_ph, p_mix = float(hyp.get("photometric", 0.0)), float(hyp.get("mixup", 0.0))

    def tiles(k):
        ks, kt, kf1, kf2, ktr, kh, kp = jax.random.split(k, 7)
        tt = u(kt, (n, 2), minval=(0.5 - tr) * size, maxval=(0.5 + tr) * size)
        d = {"scale": u(ks, (n,), minval=1.0 - sc, maxval=1.0 + sc),
             "tx": tt[:, 0], "ty": tt[:, 1],
             "fliplr": u(kf1, (n,)) < float(hyp.get("fliplr", 0.5)),
             "flipud": u(kf2, (n,)) < float(hyp.get("flipud", 0.5)),
             "transpose": u(ktr, (n,)) < float(hyp.get("transpose", 0.0))}
        if p_ph > 0:
            kb, kg = jax.random.split(kp)
            d["blur"], d["gray"] = u(kb, (n,)) < p_ph, u(kg, (n,)) < p_ph
        khh, kss, kvv = jax.random.split(kh, 3)
        g = [float(hyp.get(k, v)) for k, v in (("hsv_h", 0.015), ("hsv_s", 0.7), ("hsv_v", 0.4))]
        d["hsv"] = jnp.stack([u(khh, (n, 1, 1), minval=-g[0], maxval=g[0])[:, 0, 0],
                              u(kss, (n, 1, 1), minval=-g[1], maxval=g[1])[:, 0, 0] + 1.0,
                              u(kvv, (n, 1, 1), minval=-g[2], maxval=g[2])[:, 0, 0] + 1.0], -1)
        return d

    out = {}
    if k_mosaic == 1:
        key, kt = jax.random.split(key)
        quads = [tiles(kt)]
    else:
        keys = jax.random.split(key, 10)
        key = keys[0]
        out["partners"] = np.stack([np.asarray(jax.random.permutation(keys[q], n))
                                    for q in (1, 2, 3)]).astype(np.int64)
        quads = [tiles(keys[4 + q]) for q in range(4)]
        kc, key = jax.random.split(keys[9])
        out["crop"] = np.asarray(jax.random.randint(kc, (n, 2), 0, size + 1)).astype(np.int64)
    for k in quads[0]:
        out[k] = np.stack([np.asarray(q[k]) for q in quads])
    if p_mix > 0:
        km1, km2, km3 = jax.random.split(key, 3)
        out["mix_perm"] = np.asarray(jax.random.permutation(km1, n)).astype(np.int64)
        out["mix_lam"] = np.asarray(jax.random.beta(km2, 32.0, 32.0, (n,)))
        out["mix_do"] = np.asarray(u(km3, (n,)) < p_mix)
    return out


# ---------------------------------------------------------------- functions
def test_warp_images_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    scale = np.array([0.5, 1.0, 1.37, 0.81], np.float32)
    tx = np.array([20.0, 48.0, 57.3, 38.9], np.float32)
    ty = np.array([30.5, 48.0, 41.0, 60.2], np.float32)
    want = jda._warp_images(*map(jnp.asarray, (img, scale, tx, ty)))
    close(tda._warp_images(*map(t, (img, scale, tx, ty))), want)


def test_window_resample_and_recrop_match_jax():
    rng = np.random.default_rng(2)
    m = rng.uniform(0, 1, (B, T, M, M)).astype(np.float32)
    lo = rng.uniform(-0.2, 0.5, (B, T, 2)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 0.9, (B, T, 2))).astype(np.float32)
    close(tda._window_resample(t(m), t(lo), t(hi)),
          jda._window_resample(jnp.asarray(m), jnp.asarray(lo), jnp.asarray(hi)))
    xy = rng.uniform(-30, 90, (B, T, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 50, (B, T, 2))], -1).astype(np.float32)
    c_t, m_t = tda._clip_boxes_recrop_masks(t(boxes), t(m), float(S))
    c_j, m_j = jda._clip_boxes_recrop_masks(jnp.asarray(boxes), jnp.asarray(m), float(S))
    close(c_t, c_j)
    close(m_t, m_j)


def test_box_candidates_blur_and_compact_match_jax():
    rng = np.random.default_rng(3)
    b1 = np.concatenate([rng.uniform(0, 60, (B, T, 2)), rng.uniform(61, 96, (B, T, 2))], -1)
    b2 = b1 * rng.uniform(0.02, 1.2, (B, T, 4))
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    np.testing.assert_array_equal(tda._box_candidates(t(b1), t(b2)).numpy(),
                                  np.asarray(jda._box_candidates(jnp.asarray(b1),
                                                                 jnp.asarray(b2))))
    img = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    close(tda._box_blur3(t(img)), jda._box_blur3(jnp.asarray(img)))

    # 3T slots to T: ties (equal areas, every invalid slot) keep their order
    n = 3 * T
    boxes = np.tile(np.array([[0, 0, 20, 20]], np.float32), (B, n, 1))
    boxes[:, ::3, 2:] = rng.uniform(21, 90, (B, len(range(0, n, 3)), 2))
    tg = {"boxes": boxes, "labels": rng.integers(1, 5, (B, n)),
          "masks": rng.uniform(0, 1, (B, n, M, M)).astype(np.float32),
          "valid": rng.uniform(0, 1, (B, n)) < 0.5, "active": np.ones(B, bool)}
    got = tda._compact(to_torch(tg), T, float(S))
    want = jda._compact(to_jax(tg), T, float(S))
    for k in ("labels", "valid", "active"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    close(got["boxes"], want["boxes"])
    close(got["masks"], want["masks"])


def test_hsv_jitter_matches_jax_with_its_gains():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    img[0, :8] = img[0, :8, :, :1]                   # gray pixels: zero saturation
    img[1, :8] = 0.0                                 # black
    key = jax.random.PRNGKey(5)
    g = (0.3, 0.7, 0.4)
    want = jpre.hsv_jitter(jnp.asarray(img), key, *g)
    kh, ks, kv = jax.random.split(key, 3)
    u = jax.random.uniform
    rh = np.asarray(u(kh, (B, 1, 1), minval=-g[0], maxval=g[0]))[:, 0, 0]
    rs = np.asarray(u(ks, (B, 1, 1), minval=-g[1], maxval=g[1]) + 1.0)[:, 0, 0]
    rv = np.asarray(u(kv, (B, 1, 1), minval=-g[2], maxval=g[2]) + 1.0)[:, 0, 0]
    assert (rh < 0).any()                            # a negative hue shift wraps
    close(tpre.hsv_jitter(t(img), t(rh), t(rs), t(rv)), want)


# ------------------------------------------------------------ whole recipe
@pytest.mark.parametrize("k_mosaic,hyp", [(1, HYP), (2, HYP), (1, HYP_EXTRAS), (2, HYP_EXTRAS)],
                         ids=["k1", "k2", "k1-mixup-photometric", "k2-mixup-photometric"])
def test_recipe_matches_jax_on_its_draws(k_mosaic, hyp):
    batch = raw_batch(seed=k_mosaic)
    key = jax.random.PRNGKey(10 + k_mosaic)
    want = jda.make_device_augment(hyp, k_mosaic=k_mosaic)(key, to_jax(batch))
    draws = jax_draws(key, B, S, hyp, k_mosaic)
    got = tda.make_device_augment(hyp, k_mosaic)(to_torch(batch), draws)
    assert got["image"].dtype == torch.float32 and got["image"].shape == (B, S, S, 3)
    close(got["image"], want["image"])
    for task, tw in want["targets"].items():
        tg = got["targets"][task]
        assert tg["boxes"].shape == (B, T, 4) and tg["masks"].shape == (B, T, M, M)
        for k in ("labels", "valid", "active"):
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(tw[k]), err_msg=k)
        assert 0 < int(tg["valid"].sum()) < B * T
        close(tg["boxes"], tw["boxes"])
        close(tg["masks"], tw["masks"])


def test_identity_recipe_returns_the_tile():
    hyp = {"scale": 0.0, "translate": 0.0, "fliplr": 0.0, "flipud": 0.0, "transpose": 0.0,
           "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0}
    batch = raw_batch(seed=6)
    tg = batch["targets"]["det"]
    # whole boxes larger than 10 px, areas falling slot by slot: compaction keeps the order
    side = np.linspace(0.6, 0.15, T, dtype=np.float32)[None, :].repeat(B, 0)
    tg["boxes"] = np.stack([np.full_like(side, 0.02), np.full_like(side, 0.03),
                            0.02 + side, 0.03 + side], -1)
    tg["valid"][:] = True
    aug = tda.make_device_augment(hyp, k_mosaic=1)
    out = aug(to_torch(batch), aug.draw(np.random.default_rng(0), B, S))
    close(out["image"], batch["image"] / np.float32(255.0))
    got = out["targets"]["det"]
    close(got["boxes"], tg["boxes"])
    close(got["masks"], tg["masks"])
    np.testing.assert_array_equal(got["labels"].numpy(), tg["labels"])
    assert bool(got["valid"].all())


def test_rotational_hyp_and_k_mosaic_3_raise():
    for k in ("degrees", "shear", "perspective"):
        with pytest.raises(ValueError, match=k):
            tda.make_device_augment({**HYP, k: 1.0})
        with pytest.raises(ValueError, match=k):
            tda.draw_augment(np.random.default_rng(0), B, S, {**HYP, k: 1.0})
    with pytest.raises(ValueError, match="k_mosaic"):
        tda.make_device_augment(HYP, k_mosaic=3)
    with pytest.raises(ValueError, match="k_mosaic"):
        tda.draw_augment(np.random.default_rng(0), B, S, HYP, k_mosaic=3)


def test_draws_lie_in_their_ranges():
    n, size = 64, 640
    hyp = {**HYP_EXTRAS, "scale": 0.3, "translate": 0.2}
    d = tda.draw_augment(np.random.default_rng(7), n, size, hyp, k_mosaic=2)
    assert set(d) == {*tda.QUAD_KEYS, "partners", "crop", "mix_perm", "mix_lam", "mix_do"}
    assert d["scale"].shape == (4, n) and d["hsv"].shape == (4, n, 3)
    assert d["scale"].min() >= 0.7 and d["scale"].max() < 1.3
    for k in ("tx", "ty"):
        assert d[k].min() >= 0.3 * size and d[k].max() < 0.7 * size
    h, s, v = d["hsv"][..., 0], d["hsv"][..., 1], d["hsv"][..., 2]
    assert np.abs(h).max() <= 0.015 and (h < 0).any() and (h > 0).any()
    assert 0.3 <= s.min() and s.max() <= 1.7 and 0.6 <= v.min() and v.max() <= 1.4
    assert d["blur"].all() and d["gray"].all()            # photometric 1.0
    assert 0.2 < d["fliplr"].mean() < 0.8 and 0.2 < d["transpose"].mean() < 0.8
    for p in (*d["partners"], d["mix_perm"]):
        assert sorted(p) == list(range(n))
    assert d["crop"].min() >= 0 and d["crop"].max() <= size and d["crop"].shape == (n, 2)
    assert 0.3 < d["mix_lam"].min() and d["mix_lam"].max() < 0.7
    assert 0.2 < d["mix_do"].mean() < 0.8
    one = tda.draw_augment(np.random.default_rng(7), n, size, HYP, k_mosaic=1)
    assert set(one) == set(tda.QUAD_KEYS) - {"blur", "gray"} and one["scale"].shape == (1, n)
