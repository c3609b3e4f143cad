"""PyTorch port: training through the hub zoo layers against the JAX
package, on small ultralytics legacy-layout models of the ghost and the
v3.1 CSP families (``test_torch_zoo_layers.FAMILIES``), masks off.

From one flax init carried by ``state_dict_from_flax``: the first step's
loss items (rtol 1e-4) and every parameter's gradient (within
1e-3·max|g| of JAX's ``jax.value_and_grad``, max|g| floored at 1e-3 of
the model's largest), then the loss of each of 8
micro-steps through the port's ``make_train_step`` and JAX's optax chain
(``engines/optim.build_optimizer``) within rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.engines import optim as joptim
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.engines.optim import build_optimizer
from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_zoo_layers import FAMILIES

SIZE, B, T = 128, 2, 12


def make_batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)
    xy = rng.uniform(0.05, 0.75, (B, T, 2))
    wh = rng.uniform(0.08, 0.25, (B, T, 2))
    t = {"boxes": np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32),
         "labels": rng.integers(1, 5, (B, T)).astype(np.int64),
         "valid": rng.uniform(0, 1, (B, T)) < 0.8}
    return x, t


@pytest.mark.parametrize("family", ["ghost", "v3.1-csp"])
def test_hub_family_training_matches_jax(family):
    cfg = FAMILIES[family]
    hyp = jax_load_cfg("hyp-nuclei")
    x, t = make_batch(7)
    jt = {k: jnp.asarray(v) for k, v in t.items()}
    jm = JaxModel.from_cfg(cfg, hyp)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, jnp.asarray(x), {"det": jt}, train=True, compute_masks=False))(jax.random.PRNGKey(0)))

    def loss_fn(params, stats):
        (losses, _), mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                    {"det": jt}, train=True, compute_masks=False,
                                    mutable=["batch_stats"])
        return jm.total_loss(losses, 0.0), (losses["det"]["loss_items"], mut["batch_stats"])

    tx = joptim.build_optimizer(variables["params"], hyp, 2, 4)

    @jax.jit
    def jax_step(params, stats, opt_state):
        """One micro-step of JAX's chain: (params, stats, opt_state, loss,
        loss items, gradient)."""
        (loss, (items, stats)), g = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
        upd, opt_state = tx.update(g, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        return params, stats, opt_state, loss, items, g

    tm = Model.from_cfg(cfg, hyp)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    batch = {"image": torch.from_numpy(x),
             "targets": {"det": {k: torch.from_numpy(v) for k, v in t.items()}}}
    params0 = variables["params"]
    jstate = (params0, variables["batch_stats"], jax.jit(tx.init)(params0))
    *jstate, jl, jitems, jg = jax_step(*jstate)

    # the first step: loss items and gradients
    probe = Model.from_cfg(cfg, hyp)
    probe.load_state_dict(tm.state_dict())
    probe.train()
    losses, _ = probe.losses(batch["image"], batch["targets"], compute_masks=False)
    total = probe.total_loss(losses, 0.0)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(losses["det"]["loss_items"][k]), float(jitems[k]),
                                   rtol=1e-4, err_msg=k)
    want = state_dict_from_flax({"params": jax.tree.map(np.asarray, jg),
                                 "batch_stats": variables["batch_stats"]}, tm.spec)
    # a BatchNorm shift feeding another BatchNorm on batch statistics has a
    # gradient of 0 up to rounding: each tensor's scale floored at 1e-3 of
    # the model's largest gradient
    gmax = max(float(np.abs(want[n].numpy()).max()) for n, _ in probe.named_parameters())
    for name, p in probe.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * max(np.abs(w).max(), 1e-3 * gmax), (name, err, np.abs(w).max())

    # 8 micro-steps, an update each
    state = TrainState.create(tm, build_optimizer(tm, hyp, 2, 4))
    step = make_train_step(mask_weight=0.0)
    got, ref = [], [float(jl)]
    for i in range(8):
        if i:
            *jstate, jl, _, _ = jax_step(*jstate)
            ref.append(float(jl))
        state, metrics = step(state, batch)
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, ref, rtol=1e-3)
