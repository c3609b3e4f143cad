"""PyTorch port: the two-header quality tool
(``hd_yolo_tpu_torch/tools/multihead_check.py``) on the CPU at a tiny
size — ``yolov5s-multihead-test`` trained through the CLI with
``--device-augment`` on one set served to both tasks, each task's box
and mask stats under JAX's keys, one exported program whose two tasks
equal the eager forward bit for bit, and the REST server's rows for the
default record set and for each ``?task=``.
"""

import json
import os

from hd_yolo_tpu_torch.tools import multihead_check as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_dataset_serves_both_tasks(tmp_path):
    import csv

    data = tool.build_dataset(tmp_path, 2, 1, 96, 4)
    import yaml

    info = yaml.safe_load(open(data))
    assert info["tasks"] == ["det", "detSC"]
    rows = list(csv.DictReader(open(info["train"])))
    assert [r["task_id"] for r in rows] == ["det", "detSC"] * 2
    assert rows[0]["ann_path"] == rows[1]["ann_path"] and len({r["ann_id"] for r in rows}) == 4


def test_tool_trains_validates_exports_and_serves_both_tasks(tmp_path):
    out = tmp_path / "mh.json"
    res = tool.main(["--device", "cpu", "--cfg", "yolov5s-multihead-test", "--img-size", "128",
                     "--n-train", "2", "--n-val", "2", "--batch-size", "2", "--epochs", "1",
                     "--nuclei", "6", "--workers", "2", "--pre-nms-topk", "32",
                     "--out-dir", str(tmp_path / "work"), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    with open(os.path.join(REPO, "MULTIHEAD_QUALITY.json")) as f:
        ref = json.load(f)
    assert set(ref) <= set(res)
    assert set(res["tasks"]) == {"det", "detSC"}
    for t, s in res["tasks"].items():
        for iou_type in ("boxes", "masks"):
            assert set(ref["tasks"][t][iou_type]) == set(s[iou_type]), (t, iou_type)
            assert 0.0 <= s[iou_type]["fitness"] <= 1.0
    d = res["deploy"]
    assert d["export_tasks"] == ["det", "detSC"] and d["export_equals_eager"] is True
    assert d["rest_n_rows"] == d["rest_rows_det"] + d["rest_rows_detSC"]
    assert d["slide_px"] == 192 and d["slide_n_rows"] >= 0
