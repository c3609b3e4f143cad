"""PyTorch port: training the published ``yolov5s-ghost`` preset (ultralytics
v6.0 ``models/hub/yolov5s-ghost.yaml`` at depth 0.33, width 0.50, the
config ``chip_smoke.py`` phase 22 trains) against the JAX package, masks
off, f32, on the 2 x 256 batch of phase 22's ``hub_train_reference``.

From one flax init carried by ``state_dict_from_flax``: the loss of each
of 8 micro-steps and the loss after them, through the port's
``make_train_step`` and JAX's optax chain (``engines/optim.build_optimizer``).
The first 4 agree within rtol 1e-4.  Past them the trajectory is chaotic
at this width (a 1e-6 relative change of the port's own weights, or
another CPU thread count, moves the later losses apart by more than that),
so the rest are held within rtol 1e-2.  JAX's own total loss rises over
these updates (the objectness term climbs while box and class fall), so
phase 22 holds box and class to fall rather than the total.  With ``-s``
the test prints both packages' losses and JAX's first and last items.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.engines import optim as joptim
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.engines.optim import build_optimizer
from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax

UPDATES = 8


def test_ghost_preset_training_matches_jax_and_its_loss_rises():
    cfg = chip_smoke.HUB_PRESETS["yolov5s-ghost"]
    hyp = jax_load_cfg("hyp-nuclei")
    x, t = chip_smoke.af_batch(5, B=2, max_t=32, size=256)
    t = t["det"]
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
        (loss, (items, stats)), g = jax.value_and_grad(loss_fn, has_aux=True)(params, stats)
        upd, opt_state = tx.update(g, opt_state, params)
        return jax.tree.map(lambda p, u: p + u, params, upd), stats, opt_state, loss, items

    jstate = (variables["params"], variables["batch_stats"], jax.jit(tx.init)(variables["params"]))
    ref, ref_items = [], []
    for _ in range(UPDATES + 1):   # the last one reads the loss after the 8 updates
        *jstate, jl, items = jax_step(*jstate)
        ref.append(float(jl))
        ref_items.append({k: float(items[k]) for k in ("box", "obj", "cls")})

    tm = Model.from_cfg(cfg, hyp)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    state = TrainState.create(tm, build_optimizer(tm, hyp, 2, 4))
    step = make_train_step(mask_weight=0.0)
    batch = {"image": torch.from_numpy(x),
             "targets": {"det": {k: torch.from_numpy(v) for k, v in t.items()}}}
    got = [float(step(state, batch)[1]["loss"]) for _ in range(UPDATES + 1)]
    print(json.dumps({"jax": ref, "port": got, "jax_items": [ref_items[0], ref_items[-1]]}))
    np.testing.assert_allclose(got[:4], ref[:4], rtol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-2)

    first, last = ref_items[0], ref_items[-1]
    assert ref[-1] > ref[0] and last["obj"] > first["obj"], (ref, first, last)
    assert last["box"] < first["box"] and last["cls"] < first["cls"], (first, last)
