"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped) with the timed path broken underneath: each fault such a cell can
have comes out ``correct`` false under the limits of the cell it stands for;
the sound run comes out true.  (A step that keeps its state and the
exchange between cards do not exist in these one-card inference cells.)"""

import json
import os

import pytest
import torch

import harness
from faults import answer_altered, half_left_out

from conftest import BENCH, make_root

STANDS_FOR = {"tiny-tiles": "flagship-tiles-b64", "tiny-slide": "flagship-slide-4096"}


def root_with_limits(tmp_path, workload):
    lim = json.load(open(os.path.join(BENCH, "limits", STANDS_FOR[workload] + ".json")))
    return make_root(tmp_path, limits=lim["limits"])


@pytest.mark.parametrize("workload", sorted(STANDS_FOR))
@pytest.mark.parametrize("fault", [None, half_left_out, answer_altered],
                         ids=["sound", "half_left_out", "answer_altered"])
def test_fault_comes_out_not_correct(tmp_path, workload, fault):
    torch.manual_seed(0)
    root = root_with_limits(tmp_path, workload)
    res = harness.run_cell(root, workload, 2 ** 31 + 77, 0.5, False, device="cpu", plant=fault)
    assert res["correct"] is (fault is None), (res["checks"], res["_log"]["judged"])
    if fault is not None:
        assert res["failed"] >= 1
