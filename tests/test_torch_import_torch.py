"""PyTorch port: reference checkpoints into the port
(``hd_yolo_tpu_torch/utils/import_torch.py``).

The serialized fixtures ``tests/fixtures/{metayolo,ultralytics}_tiny.pt``
(the reference torch model's state_dict in the metayolo and the ultralytics
``model.{i}`` layouts, with that model's own boxes, scores, labels and
28x28 masks on a 64x64 input) go through the port and meet the fixture's
``expected`` with ``chip_smoke.py`` phase 20's tolerances: the detection
count within 10%, matched scores rtol 1e-3 / atol 1e-4, every expected box
within 1 px of one from the port, the matched detections' masks mean |d|
<= 0.01 and max <= 0.1.  The same bytes through JAX's ``import_state_dict``
and the port give the same outputs.  Also the renumbering, the ``ema`` /
``model`` unwrapping, the error for a pickled class that cannot be
imported, and the hub layers JAX's importer cannot carry.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hd_yolo_tpu.models import Model as JaxModel
from hd_yolo_tpu.models.builder import parse_model_cfg as jax_parse
from hd_yolo_tpu.utils.import_torch import import_state_dict as jax_import
from hd_yolo_tpu_torch.models.yolo import Model
from hd_yolo_tpu_torch.utils import import_torch

FIXDIR = Path(__file__).parent / "fixtures"
CFG = str(FIXDIR / "tiny2l.yaml")
FIXTURES = ["metayolo_tiny", "ultralytics_tiny"]


def load_fixture(name):
    return torch.load(FIXDIR / f"{name}.pt", map_location="cpu", weights_only=False)


def port_outputs(sd, x):
    m = Model.from_cfg(CFG, "hyp-nuclei")
    n, left = import_torch.import_state_dict(m, sd)
    assert n == len(m.state_dict())                        # every tensor of the model
    assert all(("anchor" in k or "mask_indices" in k or "det_loss" in k) for k in left), left
    return {k: v.numpy() for k, v in m(torch.as_tensor(x))["det"].items()}


def match_expected(o, exp):
    """Phase 20's checks of one image's outputs ``o`` against the fixture's
    ``expected``; returns the matched port indices."""
    v = o["valid"][0].astype(bool)
    n_exp = len(exp["boxes"])
    assert abs(int(v.sum()) - n_exp) <= max(1, n_exp // 10), (v.sum(), n_exp)
    idx = []
    for j in range(n_exp):
        d = np.abs(o["boxes"][0] - exp["boxes"][j]).max(-1)
        d[~v] = np.inf
        i = int(d.argmin())
        assert d[i] < 1.0, (exp["boxes"][j], d[i])
        idx.append(i)
    np.testing.assert_allclose(o["scores"][0][idx], exp["scores"], rtol=1e-3, atol=1e-4)
    assert all(o["mask_valid"][0][i] for i in idx)
    dm = np.abs(o["masks"][0][idx] - exp["masks"][:, 0])
    assert dm.mean() <= 0.01 and dm.max() <= 0.1, (dm.mean(), dm.max())
    return idx


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_bytes_through_port_meet_expected(name):
    fix = load_fixture(name)
    exp = {k: t.numpy() for k, t in fix["expected"].items()}
    match_expected(port_outputs(fix["state_dict"], fix["input_nhwc"]), exp)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_bytes_through_jax_and_port_agree(name):
    """The same bytes through JAX's importer and model, and through the
    port: the same detections, scores and masks."""
    fix = load_fixture(name)
    x = fix["input_nhwc"].numpy()
    spec = jax_parse(CFG, "hyp-nuclei")
    variables = jax_import(dict(fix["state_dict"]), spec)
    jm = JaxModel.from_cfg(CFG, "hyp-nuclei", dtype=jnp.float32)
    _, out = jax.jit(lambda v, xx: jm.apply(v, xx, train=False, compute_masks=True))(
        variables, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in out["det"].items()}
    got = port_outputs(fix["state_dict"], x)
    v = want["valid"][0].astype(bool)
    np.testing.assert_array_equal(got["valid"][0].astype(bool), v)
    np.testing.assert_array_equal(got["labels"][0][v], want["labels"][0][v])
    np.testing.assert_allclose(got["boxes"][0][v], want["boxes"][0][v], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"][0][v], want["scores"][0][v], rtol=1e-4, atol=1e-5)
    mv = want["mask_valid"][0].astype(bool)
    np.testing.assert_array_equal(got["mask_valid"][0].astype(bool), mv)
    np.testing.assert_allclose(got["masks"][0][mv], want["masks"][0][mv], atol=1e-4)


def test_ultralytics_renumbering():
    sd = {"model.0.conv.weight": torch.zeros(1), "model.6.cv1.bn.bias": torch.zeros(2),
          "model.7.conv.weight": torch.zeros(3), "model.9.m.0.bias": torch.zeros(4),
          "other": torch.zeros(5)}
    out = import_torch.renumber_ultralytics(sd, n_backbone=7, tag="detSC")
    assert set(out) == {"backbone.0.conv.weight", "backbone.6.cv1.bn.bias", "neck.0.conv.weight",
                        "headers.detSC.m.0.bias", "other"}
    assert out["neck.0.conv.weight"].numel() == 3
    assert import_torch.renumber_ultralytics({"backbone.0.w": 1}, 7) == {"backbone.0.w": 1}


@pytest.mark.parametrize("wrap", ["bare", "ema", "model", "module", "train_state"])
def test_checkpoint_wrappers_unwrap(tmp_path, wrap):
    """A state_dict bare, under ``ema`` (taken before ``model``), under
    ``model``, a pickled module, or a train state (its ``ema`` a list of
    tensors, its ``model`` the state_dict): all read as the same
    state_dict, and the ultralytics fixture's header lands under the
    model's own tag."""
    fix = load_fixture("ultralytics_tiny")
    sd = fix["state_dict"]
    m = Model.from_cfg(CFG, "hyp-nuclei")
    import_torch.import_state_dict(m, sd)
    obj = {"bare": sd, "ema": {"ema": sd, "model": {"junk": torch.zeros(1)}, "epoch": 3},
           "model": {"model": sd, "ema": None}, "module": {"model": m},
           "train_state": {"step": torch.tensor(8), "model": sd,
                           "ema": [torch.zeros(2)], "ema_updates": torch.tensor(8)}}[wrap]
    torch.save(obj, str(tmp_path / "w.pt"))
    got = import_torch.read_checkpoint(str(tmp_path / "w.pt"))
    if wrap == "module":
        assert set(got) == set(m.state_dict())
    else:
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    # a detSC model takes the single det header
    cfg = {**__import__("yaml").safe_load(open(CFG))}
    cfg["headers"] = [[[7, 8], 1, "Detect", ["anchors", [8.0, 16.0], 4, 1], "detSC"]]
    m2 = Model.from_cfg(cfg, "hyp-nuclei")
    n, _ = import_torch.load_torch_weights(m2, str(tmp_path / "w.pt"))
    assert n == len(m2.state_dict())
    torch.testing.assert_close(m2.headers["detSC"].m[0].weight, m.headers["det"].m[0].weight)


def test_unimportable_pickled_class_names_file_and_class(tmp_path):
    (tmp_path / "refmodels_gone.py").write_text(
        "import torch\n\nclass DetectionModel(torch.nn.Module):\n    pass\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import refmodels_gone
        torch.save({"model": refmodels_gone.DetectionModel()}, str(tmp_path / "best.pt"))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("refmodels_gone", None)
    with pytest.raises(import_torch.CheckpointClassError,
                       match=r"best\.pt.*refmodels_gone\.DetectionModel"):
        import_torch.read_checkpoint(str(tmp_path / "best.pt"))


GHOST = {"nc": 4, "depth_multiple": 0.33, "width_multiple": 0.25,
         "anchors": [[10, 13, 16, 30, 33, 23]],
         "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "GhostConv", [128, 3, 2]],
                      [-1, 1, "C3Ghost", [128]], [-1, 1, "BottleneckCSP", [128]],
                      [-1, 1, "C3TR", [128]]],
         "head": [[[4], 1, "Detect", ["nc", "anchors"]]]}


def test_hub_layers_jax_importer_cannot_carry_load_in_the_port():
    """Reference checkpoints of hub layers: JAX's importer raises
    ``KeyError`` at the first ``C3Ghost`` (or ``C3TR``) inner block (it reads
    ``m.0.cv1``, where the reference and the port write
    ``m.0.conv.0.cv1``; its flax tree names the block ``GhostBottleneck_0``
    and a ``C3TR``'s ``TransformerBlock_0``), and where there is none it
    carries no ``GhostConv`` or ``BottleneckCSP`` tensor (no importer: they
    stay at their initial values, with a warning).  The port loads every
    key of both."""
    jm = JaxModel.from_cfg(GHOST, "hyp-nuclei")
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    assert "GhostBottleneck_0" in tree["params"]["blocks_2"]
    assert "Bottleneck_0" not in tree["params"]["blocks_2"]
    assert "TransformerBlock_0" in tree["params"]["blocks_4"]
    plain_c3 = {**GHOST, "backbone": [r if r[2] not in ("C3Ghost", "C3TR") else
                                      [-1, 1, "C3", [128]] for r in GHOST["backbone"]]}
    for cfg in (GHOST, plain_c3):
        m = Model.from_cfg(cfg, "hyp-nuclei")
        m.reset_parameters(torch.Generator().manual_seed(0))
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        spec = jax_parse(cfg, "hyp-nuclei")
        if cfg is GHOST:
            with pytest.raises(KeyError, match=r"backbone\.2\.m\.0\.cv1\.conv\.weight"):
                jax_import(sd, spec)
        else:
            imported = jax_import(sd, spec)["params"]
            assert "blocks_1" not in imported and "blocks_3" not in imported
        m2 = Model.from_cfg(cfg, "hyp-nuclei")
        n, left = import_torch.import_state_dict(m2, sd)
        assert n == len(sd) and not left
        for k, v in sd.items():
            assert torch.equal(m2.state_dict()[k], v), k
