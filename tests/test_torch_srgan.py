"""PyTorch port, the SRGAN aux (``hd_yolo_tpu_torch/hnet/srgan.py``) against
the JAX package's ``hnet/srgan.py`` on the same numpy weights (carried by
``srgan_state_dict_from_flax``) and inputs, f32 on the CPU.

Tolerances: ``pixel_shuffle`` exact (against JAX's and torch's own); the
generator's output and the critic's scores atol 1e-5 in eval and in
training mode, the running statistics after one training forward atol
1e-5; ``gradient_penalty`` with JAX's α (drawn from its key, passed in)
rtol 1e-4, its gradient in the critic's parameters within 1e-3 of each
tensor's max|g|.  Odd input sizes check flax's SAME padding of the stride-2
convs on both parities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.hnet import srgan as jsr
from hd_yolo_tpu_torch.hnet import srgan
from hd_yolo_tpu_torch.utils.convert import srgan_state_dict_from_flax
from torch_port_common import random_tree


def _t(a):
    return torch.from_numpy(np.array(a))


def pair(jmod, tmod, x, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = random_tree(shapes, seed=seed)
    tmod.load_state_dict(srgan_state_dict_from_flax(v), strict=True)
    return v, tmod


def test_pixel_shuffle_exact():
    x = np.arange(2 * 3 * 5 * 12, dtype=np.float32).reshape(2, 3, 5, 12)
    got = srgan.pixel_shuffle(_t(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsr.pixel_shuffle(jnp.asarray(x), 2)))
    want = torch.pixel_shuffle(_t(x.transpose(0, 3, 1, 2)), 2).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)


def _run(jmod, v, tmod, x, train):
    if train:
        want, upd = jmod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        tmod.train()
    else:
        want, upd = jmod.apply(v, jnp.asarray(x)), None
        tmod.eval()
    with torch.no_grad():
        got = tmod(_t(x))
    return got, np.asarray(want), upd


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_generator_matches_jax(train):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    jg = jsr.SRGenerator(scale_factor=2, channels=16, num_blocks=2)
    v, tg = pair(jg, srgan.SRGenerator(2, 16, 2, device="cpu"), x, seed=1)
    got, want, upd = _run(jg, v, tg, x, train)
    assert tuple(got.shape) == want.shape == (2, 24, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    if train:
        sd = tg.state_dict()
        for k, w in srgan_state_dict_from_flax({"params": v["params"], **upd}).items():
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=0, atol=1e-5,
                                           err_msg=k)


@pytest.mark.parametrize("wgan", [False, True], ids=["gan", "wgan"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_discriminator_matches_jax(wgan, train):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (3, 33, 30, 3)).astype(np.float32)
    jd = jsr.SRDiscriminator(wgan=wgan)
    v, td = pair(jd, srgan.SRDiscriminator(wgan=wgan, device="cpu"), x, seed=2)
    got, want, upd = _run(jd, v, td, x, train)
    assert tuple(got.shape) == want.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if not wgan:
        assert ((got >= 0) & (got <= 1)).all()
    if train and not wgan:
        sd = td.state_dict()
        new = srgan_state_dict_from_flax({"params": v["params"], **upd})
        for k in ("bn3.running_mean", "bn7.running_var"):
            np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(), rtol=0, atol=1e-5)


def test_gradient_penalty_matches_jax():
    rng = np.random.default_rng(2)
    real = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    fake = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    jd = jsr.SRDiscriminator(wgan=True)
    v, td = pair(jd, srgan.SRDiscriminator(wgan=True, device="cpu"), real, seed=3)
    key = jax.random.PRNGKey(1)
    alpha = np.asarray(jax.random.normal(key, (2, 1, 1, 1), jnp.float32))

    def gp(params):
        return jsr.gradient_penalty(lambda z: jd.apply({"params": params}, z),
                                    jnp.asarray(real), jnp.asarray(fake), key)

    want, jgrad = jax.value_and_grad(gp)(v["params"])
    td.eval()
    got = srgan.gradient_penalty(td, _t(real), _t(fake), alpha=_t(alpha))
    assert abs(float(got.detach()) - float(want)) <= 1e-4 * abs(float(want))
    got.backward()
    jg = srgan_state_dict_from_flax({"params": jax.tree.map(np.asarray, jgrad)})
    params = dict(td.named_parameters())
    assert set(params) == set(jg)
    for name, w in jg.items():
        w, g = w.numpy(), params[name].grad
        # a bias the input gradient does not depend on gets no gradient (JAX: 0)
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-3 * max(np.abs(w).max(), 1e-8), err_msg=name)
    # drawn from a generator: a reproducible α, a finite non-negative penalty
    a = srgan.gradient_penalty(td, _t(real), _t(fake), torch.Generator().manual_seed(5))
    b = srgan.gradient_penalty(td, _t(real), _t(fake), torch.Generator().manual_seed(5))
    assert float(a) == float(b) and np.isfinite(float(a)) and float(a) >= 0


def test_modules_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (srgan.SRGenerator, srgan.SRDiscriminator):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        assert next(make(device="cpu").parameters()).device.type == "cpu"
