"""PyTorch port: the utilities (``hd_yolo_tpu_torch/utils/general.py``,
``utils/label_remap.py``, ``utils/profiling.py``) against the JAX package's.

* ``labels_to_class_weights`` / ``labels_to_image_weights`` equal JAX's
  (rtol 1e-6) on seeded labels with unlabeled ids and absent classes;
  ``check_version`` gives JAX's answers, and raises where JAX raises;
* ``manipulate_header_label_order`` on the port's ``state_dict`` equals
  JAX's remapped flax params carried through ``utils/convert.py``
  (exactly: a select), and the remapped ``yolov5s-test`` model's det
  outputs are the original's with the class channels in the new order
  (a fresh class 0 slot copies the objectness);
* ``flops_of`` of a conv and a matmul equals the analytic count (2 per
  multiply-add), and JAX's ``flops_of`` (XLA's cost analysis) counts the
  same for both: ratio 1.0;
* ``Profile``, ``Timeout``, ``model_info``, ``measure_latency`` and
  ``trace`` on the CPU (no card: ``device_memory_stats`` is empty).
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.utils import general as jgeneral
from hd_yolo_tpu.utils import label_remap as jremap
from hd_yolo_tpu.utils import profiling as jprof
from hd_yolo_tpu_torch.config import load_cfg
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils import general, label_remap, profiling
from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
from torch_port_common import random_variables


@pytest.mark.parametrize("nc,seed", [(3, 0), (5, 1), (8, 2)])
def test_class_and_image_weights_match_jax(nc, seed):
    rng = np.random.default_rng(seed)
    labels = [rng.integers(-1, nc - 1, rng.integers(0, 12)) for _ in range(9)]
    cw = general.labels_to_class_weights(labels, nc)
    want = jgeneral.labels_to_class_weights(labels, nc)
    assert cw.dtype == want.dtype == np.float32 and cw.shape == (nc,)
    np.testing.assert_allclose(cw, want, rtol=1e-6)
    assert cw[-1] == 0                                  # class nc-1 is never drawn
    iw = general.labels_to_image_weights(labels, nc, cw)
    np.testing.assert_allclose(iw, jgeneral.labels_to_image_weights(labels, nc, want), rtol=1e-6)
    assert general.labels_to_class_weights([None], nc).size == 0


@pytest.mark.parametrize("cur,minimum", [("1.2.3", "1.0.3"), ("0.9", "1.0"), ("2.11.0+cu128",
                                          "2.1"), ("1.10", "1.9.9"), ("3.12.12", "3.12.12")])
def test_check_version_matches_jax(cur, minimum):
    ok = general.check_version(cur, minimum)
    assert ok == jgeneral.check_version(cur, minimum)
    if not ok:
        with pytest.raises(AssertionError, match="required"):
            general.check_version(cur, minimum, name="torch", hard=True)


LABEL_MAP = [3, 1, 0]          # new class i ← old 1-based class id (0: a fresh slot)
NA, NC_OLD = 3, 4


def _model(nc):
    cfg = load_cfg("yolov5s-test")
    cfg["headers"][0][3][2] = nc
    return Model.from_cfg(cfg, "hyp-nuclei")


def test_label_remap_matches_jax_and_reorders_the_class_scores():
    jm = JaxModel.from_cfg("yolov5s-test", "hyp-nuclei")
    variables = random_variables(jm, (1, 64, 64, 3), seed=2)
    old = _model(NC_OLD)
    new = _model(len(LABEL_MAP))
    sd_old = state_dict_from_flax(variables, old.spec)
    got = label_remap.manipulate_header_label_order(sd_old, "det", NA, NC_OLD, LABEL_MAP)
    jparams = jremap.manipulate_header_label_order(variables["params"], "header_det", NA,
                                                   NC_OLD, LABEL_MAP)
    want = state_dict_from_flax({"params": jparams, "batch_stats": variables["batch_stats"]},
                                new.spec)
    assert set(got) == set(want)
    remapped = 0
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        remapped += int(got[k].shape != sd_old[k].shape)
    assert remapped == 6                                 # 3 levels x (weight, bias)

    old.load_state_dict(sd_old)
    new.load_state_dict(got)
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    outs = []
    with torch.no_grad():
        for m in (old.eval(), new.eval()):
            feats = m.trunk(x)
            h = m.spec.headers[0]
            outs.append(m.headers["det"]._heads([feats[j] for j in h.from_idx], False)[0])
    for d_old, d_new in zip(*outs):
        assert d_new.shape[-1] == 5 + len(LABEL_MAP) and d_old.shape[-1] == 5 + NC_OLD
        torch.testing.assert_close(d_new[..., :5], d_old[..., :5], rtol=0, atol=1e-6)
        for j, m in enumerate(LABEL_MAP):
            torch.testing.assert_close(d_new[..., 5 + j], d_old[..., 4 + m], rtol=0, atol=1e-6)


def test_remap_det_conv_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((NA * (5 + NC_OLD), 7, 1, 1)).astype(np.float32)
    b = rng.standard_normal(NA * (5 + NC_OLD)).astype(np.float32)
    gw, gb = label_remap.remap_det_conv(torch.from_numpy(w), torch.from_numpy(b), NA, NC_OLD,
                                        LABEL_MAP)
    jk, jb = jremap.remap_det_conv(w.transpose(2, 3, 1, 0), b, NA, NC_OLD, LABEL_MAP)
    np.testing.assert_array_equal(gw.numpy(), jk.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(gb.numpy(), jb)


def test_flops_of_counts_conv_and_matmul_as_xla():
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(np.float32)
    conv = torch.nn.Conv2d(3, 8, 3, bias=False)
    analytic_conv = 2 * 2 * 8 * 14 * 14 * 3 * 9
    assert profiling.flops_of(conv, torch.from_numpy(x)) == analytic_conv
    k = conv.weight.detach().numpy().transpose(2, 3, 1, 0)
    jconv = jprof.flops_of(lambda a, w: jax.lax.conv_general_dilated(
        a, w, (1, 1), "VALID", dimension_numbers=("NCHW", "HWIO", "NCHW")), jnp.asarray(x),
        jnp.asarray(k))
    assert jconv / analytic_conv == 1.0

    a, b = np.ones((32, 48), np.float32), np.ones((48, 24), np.float32)
    analytic_mm = 2 * 32 * 48 * 24
    assert profiling.flops_of(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == analytic_mm
    assert jprof.flops_of(jnp.matmul, jnp.asarray(a), jnp.asarray(b)) / analytic_mm == 1.0


def test_profile_timeout_info_latency_trace(tmp_path):
    with profiling.Profile() as p:
        time.sleep(0.01)
    assert 0.01 <= p.dt < 1.0 and p.t == p.dt
    with profiling.Timeout(1):
        time.sleep(1.5)                                   # swallowed: suppress=True
    with pytest.raises(TimeoutError, match="slow"):
        with profiling.Timeout(1, "slow", suppress=False):
            time.sleep(1.5)
    m = _model(NC_OLD).eval()
    info = profiling.model_info(m, (1, 64, 64, 3), compute_masks=False)
    assert info["n_params"] == sum(p.numel() for p in m.parameters())
    assert info["n_tensors"] == len(list(m.parameters())) and info["gflops"] > 0
    lin = torch.nn.Linear(8, 8)
    s = profiling.measure_latency(lin, torch.zeros(4, 8), iters=5, warmup=1)
    assert 0 < s < 1.0
    with profiling.trace(str(tmp_path / "tr")) as prof:
        lin(torch.zeros(4, 8))
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("addmm" in e.key or "linear" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
