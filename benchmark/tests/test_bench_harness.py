"""The harness's own rules: the judged sample covers distinct inputs,
``setup_s`` leaves the reference's calibration out, and the Detector is
built only while its ``__init__`` sets nothing the harness does not."""

import pytest
import torch

import harness
from entries import common


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 77, 2 ** 33 + 5])
@pytest.mark.parametrize("pool,n,requests", [(4, 2, 800), (4, 2, 3), (4, 4, 40), (2, 2, 1),
                                             (1, 1, 100)])
def test_judged_sample_covers_distinct_inputs(seed, pool, n, requests):
    s = harness.judged_sample(seed, pool, n, requests)
    assert len(s) == n and len({j % pool for j in s}) == n
    assert all(0 <= j < max(requests, pool) for j in s)
    assert s == harness.judged_sample(seed, pool, n, requests)


def test_setup_s_leaves_out_the_reference(tiny_root):
    res = harness.run_cell(tiny_root, "tiny-tiles", 5, 0.3, False, device="cpu")
    m = res["_log"]["setup"]
    assert res["metrics"]["setup_s"]["value"] == m["setup_s"]
    own = m["import_s"] + m["weights_and_inputs_s"] + m["program_and_warmup_s"]
    assert m["reference_calibration_s"] > 0
    assert abs(m["setup_s"] - own) < 0.05, m
    assert len({j % 2 for j in res["_log"]["sample"]}) == len(res["_log"]["sample"]) == 2


def _init_with_a_buffer(self, cfg="yolov5l6-mask", device="cuda"):
    self.device = device
    self.model = None
    self.input_size, self.labels_text = 640, {}
    self.pinned = None


@pytest.mark.parametrize("init", [None, _init_with_a_buffer], ids=["as_is", "new_state"])
def test_detector_is_built_only_while_its_init_sets_nothing_more(monkeypatch, init):
    from hd_yolo_tpu_torch.detector import Detector

    if init is None:
        assert common.init_attrs(Detector) == common.DETECTOR_ATTRS
        return
    monkeypatch.setattr(Detector, "__init__", init)
    assert common.init_attrs(Detector) == common.DETECTOR_ATTRS | {"pinned"}
    with pytest.raises(RuntimeError, match="pinned"):
        common.detector({"model": {}, "hyp": {}, "dtype": "float32", "input_size": 64}, {},
                        {}, torch.device("cpu"))
