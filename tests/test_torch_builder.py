"""PyTorch port: config plane and spec builder agree with the JAX package,
and the port stands alone (imports nothing of JAX or of ``hd_yolo_tpu``)."""

import dataclasses
import filecmp
import glob
import os
import re

import pytest

from hd_yolo_tpu.models.builder import normalize_legacy_cfg as jax_normalize_legacy_cfg
from hd_yolo_tpu.models.builder import parse_model_cfg as jax_parse_model_cfg
from hd_yolo_tpu_torch.config import CONFIG_DIR, load_cfg
from hd_yolo_tpu_torch.models.builder import normalize_legacy_cfg, parse_model_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CONFIGS = ["yolov5l6-mask", "yolov5s-test", "hyp-nuclei", "hnet-nucls",
                "yolov5l6-multihead", "yolov5s-multihead-test", "yolov6s-af"]


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_copied_yaml_is_byte_equal(name):
    assert filecmp.cmp(os.path.join(CONFIG_DIR, name + ".yaml"),
                       os.path.join(REPO, "hd_yolo_tpu", "configs", name + ".yaml"), shallow=False)


@pytest.mark.parametrize("cfg", ["yolov5l6-mask", "yolov5s-test", "yolov5l6-multihead",
                                 "yolov5s-multihead-test", "yolov6s-af"])
def test_network_spec_equals_jax(cfg):
    got = dataclasses.asdict(parse_model_cfg(cfg, "hyp-nuclei"))
    want = dataclasses.asdict(jax_parse_model_cfg(cfg, "hyp-nuclei"))
    assert got == want


def test_load_cfg_reads_the_port_copy():
    cfg = load_cfg("yolov5l6-mask")
    assert cfg["headers"][0][4] == "detSC"
    assert load_cfg(cfg) == cfg and load_cfg(cfg) is not cfg


def test_legacy_cfg_normalization_equals_jax():
    """An upstream-format yaml (single ``head`` section, Detect [nc, anchors])
    normalizes identically, with the same inferred strides."""
    legacy = {
        "nc": 3, "depth_multiple": 0.33, "width_multiple": 0.25,
        "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119]],
        "backbone": [[-1, 1, "Conv", [64, 6, 2, 2]], [-1, 1, "Conv", [128, 3, 2]],
                     [-1, 3, "C3", [128]], [-1, 1, "Conv", [256, 3, 2]],
                     [-1, 1, "SPPF", [256, 5]]],
        "head": [[-1, 1, "Conv", [128, 1, 1]], [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
                 [[-1, 2], 1, "Concat", [1]], [-1, 3, "C3", [128, False]],
                 [[-1, 4], 1, "Detect", ["nc", "anchors"]]],
    }
    assert normalize_legacy_cfg(legacy) == jax_normalize_legacy_cfg(legacy)
    got = dataclasses.asdict(parse_model_cfg(legacy, None))
    assert got == dataclasses.asdict(jax_parse_model_cfg(legacy, None))
    assert got["headers"][0]["strides"] == (4.0, 8.0)


def test_reference_hub_yamls_build_like_jax():
    """Every reference hub yaml builds the same spec in both packages.
    Needs the reference checkout; skips when it is absent."""
    hub = "/root/reference/metayolo/hub"
    paths = sorted(glob.glob(os.path.join(hub, "*.yaml")))
    if not paths:
        pytest.skip(f"reference hub configs not present at {hub}")
    for p in paths:
        try:
            want = dataclasses.asdict(jax_parse_model_cfg(p, None))
        except Exception:          # configs the JAX package cannot build either
            continue
        assert dataclasses.asdict(parse_model_cfg(p, None)) == want, p


def test_port_imports_nothing_of_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|hd_yolo_tpu)\b", re.M)
    files = glob.glob(os.path.join(REPO, "hd_yolo_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_anchor_free_config_raises_until_its_head_is_ported():
    """An ``AFDetect`` header is built as the anchor-free header, not as an
    anchor-based ``Detect`` (it raised ``NotImplementedError`` until the
    head was ported): ``yolov6s-af`` builds an ``AnchorFreeDetect`` and
    the JAX model's weights load into it with ``strict=True``."""
    import numpy as np

    from hd_yolo_tpu.models import Model as JaxModel
    from hd_yolo_tpu_torch.models.anchor_free_head import AnchorFreeDetect
    from hd_yolo_tpu_torch.models.yolo import Model
    from hd_yolo_tpu_torch.utils.convert import state_dict_from_flax
    from torch_port_common import random_variables

    cfg = os.path.join(REPO, "hd_yolo_tpu", "configs", "yolov6s-af.yaml")
    assert [h.kind for h in parse_model_cfg(cfg, "hyp-nuclei").headers] == ["anchor_free"]
    tm = Model.from_cfg(cfg, "hyp-nuclei")
    assert isinstance(tm.headers["det"], AnchorFreeDetect)
    variables = random_variables(JaxModel.from_cfg(cfg, "hyp-nuclei"), (1, 64, 64, 3))
    sd = state_dict_from_flax(variables, tm.spec)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    n_flax = sum(int(np.prod(a.shape)) for a in _leaves(variables["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_flax


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))
