"""PyTorch port: the training step (``hd_yolo_tpu_torch/engines/train_step.py``,
``engines/optim.py``, the models' training forward) against the JAX package
on the same seeded numpy weights and batches, ``yolov5s-test`` at 128 px in
f32 (batch 2, ``max_targets`` 16, ``mask_rois`` 4).

* loss items (rtol 1e-4);
* gradients per tensor within 1e-3·max|g| — except the mask branch (the
  seg convs and the mask head), held within 2e-2·max|g|: with random
  weights their gradients are sums of many cancelling terms behind five
  ReLU layers, so rounding of either package moves them that far (a 1e-6
  relative perturbation of the pooled ROIs moves the port's own mask-head
  gradients by ~4e-3 of their max), while the loss itself agrees to 1e-6;
* BatchNorm running statistics after a step (atol 1e-5);
* parameters and EMA after one update with ``accumulate`` 1 and 2 (the JAX
  side: its jitted gradient, ``build_optimizer``'s optax chain and
  ``ema_update``), and after a further step from a JAX state carried across
  mid-run by ``utils/convert.train_state_from_flax`` (momentum non-zero);
* a non-finite batch skipped by both;
* param groups against JAX ``label_params``;
* the optimizer alone on a small module: lr and momentum of every update,
  the parameters over 12 micro-steps, for SGD / Adam / AdamW, with and
  without accumulation and clipping — and the schedules count applied
  updates, as the JAX package's ``inject_hyperparams`` inside ``MultiSteps``
  does.

The mask IoU threshold is lowered to 0.05 so that random weights give the
mask loss winners to pool; the 28x28 mask targets are discs, as nuclei are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hd_yolo_tpu.config import load_cfg as jax_load_cfg
from hd_yolo_tpu.engines import optim as joptim
from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.engines import optim as toptim
from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax, train_state_from_flax
from torch_port_common import random_variables

SIZE, B, T, R = 128, 2, 16, 4
X_SHAPE = (B, SIZE, SIZE, 3)
MASK_TENSORS = ("headers.det.seg.", "headers.det.seg_h.")


def train_hyp():
    hyp = jax_load_cfg("hyp-nuclei")
    hyp["det"]["mask_iou_t"] = 0.05
    return hyp


def make_batch(seed: int, n_valid=(11, 7)):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, X_SHAPE).astype(np.uint8)
    xy = rng.uniform(0.05, 0.8, (B, T, 2))
    wh = rng.uniform(0.05, 0.2, (B, T, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, 1.0)], -1).astype(np.float32)
    valid = np.zeros((B, T), bool)
    for b, n in enumerate(n_valid):
        valid[b, :n] = True
    labels = rng.integers(0, 5, (B, T)).astype(np.int64)
    yy, xx = np.mgrid[0:28, 0:28] + 0.5
    rad = rng.uniform(6, 13, (B, T, 1, 1))
    masks = (((yy - 14) ** 2 + (xx - 14) ** 2) < rad ** 2).astype(np.float32)
    return x, {"boxes": boxes, "labels": labels, "masks": masks, "valid": valid}


def torch_batch(x, t):
    return {"image": torch.from_numpy(x), "targets": {"det": {k: torch.from_numpy(v) for k, v in t.items()}}}


@pytest.fixture(scope="module")
def setup():
    """JAX model, weights, its jitted loss gradient and its results on two
    batches at the initial weights."""
    hyp = train_hyp()
    jm = JaxModel.from_cfg("yolov5s-test", hyp, mask_rois=R)
    variables = random_variables(jm, X_SHAPE, seed=1)

    def loss_fn(params, stats, x, t):
        (losses, _), mut = jm.apply({"params": params, "batch_stats": stats}, x, {"det": t},
                                    train=True, compute_masks=True, mutable=["batch_stats"])
        items = {k: v for k, v in losses["det"]["loss_items"].items()}
        return jm.total_loss(losses, 1.0), (items, mut["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batches = [make_batch(10), make_batch(11, (16, 3))]
    res = [jax.tree.map(np.asarray, grad_fn(variables["params"], variables["batch_stats"],
                                            jnp.asarray(x), {k: jnp.asarray(v) for k, v in t.items()}))
           for x, t in batches]
    return hyp, jm, variables, grad_fn, batches, res


def port_model(hyp, variables):
    tm = Model.from_cfg("yolov5s-test", hyp, mask_rois=R)
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec))
    return tm


def flax_to_torch(tree, variables, tm):
    return state_dict_from_flax({"params": tree, "batch_stats": variables["batch_stats"]}, tm.spec)


def test_loss_items_and_gradients(setup):
    hyp, _, variables, _, batches, res = setup
    tm = port_model(hyp, variables).train()
    x, t = batches[0]
    b = torch_batch(x, t)
    losses, outputs = tm.losses(b["image"], b["targets"])
    assert outputs == {"det": {}}
    total = tm.total_loss(losses)
    total.backward()
    (jl, (jitems, _)), jg = res[0]
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-4)
    for k, v in jitems.items():
        np.testing.assert_allclose(float(losses["det"]["loss_items"][k]), float(v), rtol=1e-4,
                                   err_msg=k)
    assert float(jitems["mask"]) > 0
    want = flax_to_torch(jg, variables, tm)
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * np.abs(w).max()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= tol, (name, err, tol)


def test_batchnorm_running_stats_after_a_step(setup):
    hyp, _, variables, _, batches, res = setup
    tm = port_model(hyp, variables).train()
    x, t = batches[0]
    b = torch_batch(x, t)
    with torch.no_grad():
        tm.losses(b["image"], b["targets"])
    (_, (_, jstats)), _ = res[0]
    want = state_dict_from_flax({"params": variables["params"], "batch_stats": jstats}, tm.spec)
    moved = 0
    for name, buf in tm.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
            before = state_dict_from_flax(variables, tm.spec)[name].numpy()
            moved += int(np.abs(buf.numpy() - before).max() > 1e-6)
    assert moved > 10


def jax_update(hyp, variables, grads, k, steps_per_epoch=8, epochs=2):
    """The JAX optimizer and EMA over the micro-step gradients ``grads``."""
    tx = joptim.build_optimizer(variables["params"], hyp, epochs, steps_per_epoch, accumulate=k)
    params = variables["params"]
    opt_state = tx.init(params)
    ema = joptim.ema_init(params)
    for g in grads:
        upd, opt_state = tx.update(g, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
        ema = joptim.ema_update(ema, params)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, ema), opt_state, tx


@pytest.mark.parametrize("k", [1, 2])
def test_params_and_ema_after_one_update(setup, k):
    hyp, _, variables, _, batches, res = setup
    tm = port_model(hyp, variables)
    opt = toptim.build_optimizer(tm, hyp, 2, 8, accumulate=k)
    state = TrainState.create(tm, opt)
    step = make_train_step()
    for x, t in batches[:k]:
        state, metrics = step(state, torch_batch(x, t))
    assert int(state.step) == k and int(opt.state["count"]) == 1
    jparams, jema, _, _ = jax_update(hyp, variables, [r[1] for r in res[:k]], k)
    want_p = flax_to_torch(jparams, variables, tm)
    want_e = flax_to_torch(jema.params, variables, tm)
    init = state_dict_from_flax(variables, tm.spec)
    changed = 0
    for i, name in enumerate(opt.names):
        p0 = init[name].numpy()
        scale = max(np.abs(want_p[name].numpy() - p0).max(), 1e-12)
        # the update (not the weights) within 1e-3 of its largest entry,
        # from gradients that agree to 1e-3 (2e-2 in the mask branch), plus
        # a few f32 ulps of the weights
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * scale + 1e-6 * np.abs(p0).max()
        np.testing.assert_allclose(opt.params[i].detach().numpy(), want_p[name].numpy(),
                                   rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(state.ema.params[i].numpy(), want_e[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)
        changed += int(scale > 1e-6)
    assert changed > 10          # the bias group moves at the first update
    assert int(state.ema.updates) == int(jema.updates) == k


def test_carried_state_mid_run(setup):
    """A JAX state after one update (momentum non-zero) carried into the port
    by ``train_state_from_flax``; one more step on both sides agrees."""
    hyp, _, variables, grad_fn, batches, res = setup
    jparams, jema, opt_state, tx = jax_update(hyp, variables, [res[0][1]], 1)
    x, t = batches[1]
    (_, (_, jstats)), g2 = jax.tree.map(np.asarray, grad_fn(
        jparams, variables["batch_stats"], jnp.asarray(x), {k: jnp.asarray(v) for k, v in t.items()}))
    upd, opt_state2 = tx.update(g2, opt_state, jparams)
    jparams2 = jax.tree.map(lambda p, u: np.asarray(p + u), jparams, upd)
    jema2 = joptim.ema_update(jema, jparams2)

    class JState:                        # the attributes of the JAX TrainState
        step, params, batch_stats, ema = np.int32(1), jparams, variables["batch_stats"], jema
    JState.opt_state = jax.tree.map(np.asarray, opt_state)

    tm = port_model(hyp, variables)
    opt = toptim.build_optimizer(tm, hyp, 2, 8)
    state = TrainState.create(tm, opt)
    state.step = torch.tensor(train_state_from_flax(JState, tm, opt, state.ema))
    assert int(opt.state["count"]) == 1
    assert max(float(t_.abs().max()) for t_ in opt.state["trace"]) > 0
    state, _ = make_train_step()(state, torch_batch(x, t))
    want_p = flax_to_torch(jparams2, variables, tm)
    want_e = flax_to_torch(jax.tree.map(np.asarray, jema2.params), variables, tm)
    prev = flax_to_torch(jparams, variables, tm)
    for i, name in enumerate(opt.names):
        scale = max(np.abs(want_p[name].numpy() - prev[name].numpy()).max(), 1e-12)
        tol = (2e-2 if name.startswith(MASK_TENSORS) else 1e-3) * scale \
            + 1e-6 * np.abs(prev[name].numpy()).max()
        np.testing.assert_allclose(opt.params[i].detach().numpy(), want_p[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)
        np.testing.assert_allclose(state.ema.params[i].numpy(), want_e[name].numpy(), rtol=0,
                                   atol=tol, err_msg=name)


def test_nonfinite_batch_is_skipped(setup):
    hyp, _, variables, _, batches, res = setup
    jg = res[0][1]
    bad = jax.tree.map(lambda a: a.copy(), jg)
    bad["blocks_0"]["conv"]["kernel"][0, 0, 0, 0] = np.nan
    tx = joptim.build_optimizer(variables["params"], hyp, 2, 8)
    s0 = tx.init(variables["params"])
    upd, s1 = tx.update(bad, s0, variables["params"])
    assert all(float(np.abs(np.asarray(u)).max()) == 0 for u in jax.tree.leaves(upd))

    tm = port_model(hyp, variables)
    opt = toptim.build_optimizer(tm, hyp, 2, 8, accumulate=2)
    x, t = batches[0]
    b = torch_batch(x, t)
    b["image"] = b["image"].float().clone()
    b["image"][0, 0, 0, 0] = float("nan")
    state = TrainState.create(tm, opt)
    before = [p.detach().clone() for p in opt.params]
    state, metrics = make_train_step()(state, b)
    assert not torch.isfinite(metrics["loss"])
    for p, q in zip(opt.params, before):
        assert torch.equal(p.detach(), q)
    assert int(opt.state["count"]) == 0 and int(opt.state["mini_step"]) == 0
    assert all(float(a.abs().max()) == 0 for a in opt.state["acc"] + opt.state["trace"])
    assert int(opt.state["notfinite"]) == 1


def test_param_groups_match_jax_labels(setup):
    hyp, _, variables, _, _, _ = setup
    tm = port_model(hyp, variables)
    for freeze in (None, ["backbone.1.", "neck.2."]):
        labels = toptim.label_params(tm, freeze)
        assert set(labels) == {n for n, _ in tm.named_parameters()}
        # number every flax leaf, carry the numbers across, read them back
        leaves, treedef = jax.tree.flatten(variables["params"])
        ids = jax.tree.unflatten(treedef, [np.full(l.shape, i, np.float32)
                                           for i, l in enumerate(leaves)])
        jfreeze = None if freeze is None else ["blocks_1'", "blocks_12'"]
        jlab = jax.tree.leaves(joptim.label_params(variables["params"], jfreeze))
        moved = flax_to_torch(ids, variables, tm)
        for name, group in labels.items():
            assert group == jlab[int(moved[name].reshape(-1)[0])], name


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3)
        self.bn = nn.BatchNorm2d(4)


def tiny_flax(m: Tiny):
    return {"conv": {"kernel": m.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                     "bias": m.conv.bias.detach().numpy()},
            "bn": {"scale": m.bn.weight.detach().numpy(), "bias": m.bn.bias.detach().numpy()}}


@pytest.mark.parametrize("kind,k,clip", [("sgd", 1, 0.0), ("sgd", 3, 0.0), ("sgd", 3, 0.5),
                                         ("adam", 1, 0.0), ("adamw", 2, 0.0)])
def test_optimizer_schedules_and_updates_match_optax(kind, k, clip):
    torch.manual_seed(0)
    m = Tiny()
    with torch.no_grad():
        m.bn.weight.uniform_(0.5, 1.5)
        m.bn.bias.normal_()
    hyp = {"lr0": 0.02, "warmup_epochs": 0.5, "clip_grad_norm": clip}
    spe, epochs, n = 4, 3, 12
    params = tiny_flax(m)
    tx = joptim.build_optimizer(params, hyp, epochs, spe, accumulate=k, optimizer=kind)
    st = tx.init(params)
    opt = toptim.build_optimizer(m, hyp, epochs, spe, accumulate=k, optimizer=kind)
    lr_main, lr_bias, mom = joptim.make_lr_schedules({**joptim.DEFAULT_HYP, **hyp}, epochs, spe)
    rng = np.random.default_rng(3)
    for i in range(n):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        upd, st = tx.update(g, st, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, upd)
        tg = tiny_flax(Tiny())  # shapes only
        tg = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
            g["conv"]["kernel"].transpose(3, 2, 0, 1), g["conv"]["bias"], g["bn"]["scale"],
            g["bn"]["bias"])]
        order = {"conv.weight": 0, "conv.bias": 1, "bn.weight": 2, "bn.bias": 3}
        opt.update([tg[order[nm]] for nm in opt.names])
        emitted = (i + 1) % k == 0
        count = (i + 1) // k
        assert int(opt.state["count"]) == count
        if emitted:   # the hyperparameters of this update, at the count before it
            c = count - 1
            np.testing.assert_allclose(float(opt.last["lr_kernel"]), float(lr_main(c)), rtol=1e-6)
            np.testing.assert_allclose(float(opt.last["lr_bias"]), float(lr_bias(c)), rtol=1e-6)
            if kind == "sgd":
                np.testing.assert_allclose(float(opt.last["momentum"]), float(mom(c)), rtol=1e-6)
                hp = [s for s in jax.tree.leaves(st, is_leaf=lambda s: hasattr(s, "hyperparams"))
                      if hasattr(s, "hyperparams")]
                assert int(hp[0].count) == count        # optax counts applied updates too
                np.testing.assert_allclose(float(hp[0].hyperparams["momentum"]), float(mom(c)),
                                           rtol=1e-6)
        got = tiny_flax(m)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


class Noisy(Tiny):
    """``Tiny`` as a stochastic model: its loss scales the output by a draw
    from the step's generator, and it keeps the generator's first draw."""

    stochastic = True

    def losses(self, images, targets, compute_masks=True, generator=None):
        u = torch.rand((), generator=generator)
        self.draws.append(float(u))
        return {"t": {"l": (self.bn(self.conv(images)) * u).square().mean()}}, None

    def total_loss(self, losses, mask_weight=1.0):
        return losses["t"]["l"]


def test_stochastic_step_seeds_from_the_host_count():
    """A stochastic model's generator is seeded from (seed, step) with the
    state's host count: the device count is never read (here it lies on the
    meta device, where reading it raises), and setting ``state.step`` (as a
    resume does) moves the host count with it."""
    from hd_yolo_tpu_torch.engines.train_step import step_generator

    torch.manual_seed(0)
    m = Noisy()
    m.draws = []
    state = TrainState.create(m, toptim.build_optimizer(m, {"lr0": 0.01}, 1, 8))
    state.step = torch.tensor(5)
    assert state.count == 5
    state._step = torch.zeros((), dtype=torch.int64, device="meta")
    step = make_train_step(seed=7)
    batch = {"image": torch.randn((2, 3, 8, 8)), "targets": {}}
    for _ in range(2):
        step(state, batch)
    assert state.count == 7 and state.step.device.type == "meta"
    want = [float(torch.rand((), generator=step_generator(7, s, "cpu"))) for s in (5, 6)]
    assert m.draws == want
