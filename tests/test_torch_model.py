"""PyTorch port: trunk parity with the JAX model on the same converted weights.

flax ``Model`` (yolov5s-test) → numpy weights → ``state_dict_from_flax`` →
``load_state_dict(strict=True)``; the P3–P5 features agree in f32 within
rtol 1e-4 / atol 1e-4, and the parameter counts are equal.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils.convert import load_weights, state_dict_from_flax
from torch_port_common import random_variables

X_SHAPE = (2, 128, 128, 3)


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei")
    variables = random_variables(jm, X_SHAPE, seed=0)
    tm = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    return jm, variables, tm.eval()


def test_flax_init_tree_loads_strictly(rng):
    """The tree ``Model.init`` itself returns (flax's own initializers and
    default BN stats), through numpy, loads with ``strict=True`` and gives
    the same P3–P5 features."""
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei")
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda k: jm.init(k, jnp.asarray(x), train=False))(
            jax.random.PRNGKey(0)))
    tm = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    tm.load_state_dict(state_dict_from_flax(variables, tm.spec), strict=True)
    want = jm.apply(variables, jnp.asarray(x), method=lambda m, v: m.trunk(v))
    with torch.no_grad():
        got = tm.eval().trunk(torch.from_numpy(x))
    for j in jm.spec.headers[0].from_idx:
        np.testing.assert_allclose(got[j].permute(0, 2, 3, 1).numpy(), np.asarray(want[j]),
                                   rtol=1e-4, atol=1e-4)


def test_param_count_equals_flax(pair):
    jm, variables, tm = pair
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_flax


def test_state_dict_keys_cover_the_model(pair):
    """The converted tree names every tensor of the module tree, no more."""
    _, variables, tm = pair
    sd = state_dict_from_flax(variables, tm.spec)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_trunk_features_match_jax(pair, rng):
    jm, variables, tm = pair
    x = rng.uniform(0, 1, X_SHAPE).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), method=lambda m, v: m.trunk(v))
    with torch.no_grad():
        got = tm.trunk(torch.from_numpy(x))
    for j in jm.spec.headers[0].from_idx:              # P3, P4, P5
        g = got[j].permute(0, 2, 3, 1).numpy()
        w = np.asarray(want[j])
        assert g.shape == w.shape
        assert np.abs(w).max() > 0.05                   # real activations, not a vanished trunk
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_uint8_input_divided_by_255(pair, rng):
    _, _, tm = pair
    xu = rng.integers(0, 256, X_SHAPE).astype(np.uint8)
    with torch.no_grad():
        a = tm.trunk(torch.from_numpy(xu))
        b = tm.trunk(torch.from_numpy(xu.astype(np.float32) / 255.0))
    for j in a:
        torch.testing.assert_close(a[j], b[j], rtol=0, atol=0)


def test_load_weights_pickle_and_reference_pt(pair, tmp_path):
    """A pickled flax tree and a reference-layout .pt (header saved under the
    deployed tag ``det`` and without BN counters) both load strictly."""
    _, variables, tm = pair
    pk = tmp_path / "w.pkl"
    pk.write_bytes(pickle.dumps(variables))
    m1 = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    load_weights(m1, str(pk))
    sd = {k: v for k, v in tm.state_dict().items() if not k.endswith("num_batches_tracked")}
    pt = tmp_path / "w.pt"
    torch.save({"model": sd}, str(pt))
    m2 = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    load_weights(m2, str(pt))
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(m1.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(m2.state_dict()[k], v, rtol=0, atol=0)


def test_c3_merged_matches_two_conv_form(pair, rng):
    """The merged cv1+cv2 inference conv equals running cv1 and cv2 apart."""
    _, _, tm = pair
    c3 = tm.backbone[2]
    x = torch.from_numpy(rng.standard_normal((1, c3.cv1.conv.in_channels, 8, 8)).astype(np.float32))
    with torch.no_grad():
        got = c3(x)
        want = c3.cv3(torch.cat([c3.m(c3.cv1(x)), c3.cv2(x)], 1))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
