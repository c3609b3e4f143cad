"""PyTorch port: the training CLI (``hd_yolo_tpu_torch/engines/train.py``)
end to end on the CPU at a tiny size — a synthetic labelled set written to
``tmp_path``, ``yolov5s-test`` at 128 px, 2 epochs with masks: ``last``,
``best`` and ``final`` written, ``results.json`` a row an epoch, a resume
for a third epoch restoring step, parameters and EMA as saved, ``final.pt``
loading into ``Detector`` — ``--plots`` raising ``ImportError`` before
the first step where matplotlib does not import, reference checkpoints
loading as ``--weights`` where a pickled class that cannot be imported
raises, and the card as the default device (no CUDA here: it raises).  The flags of the device data path: ``test_torch_train_flags.py``.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from hd_yolo_tpu_torch.detector import Detector
from hd_yolo_tpu_torch.engines import checkpoint
from hd_yolo_tpu_torch.engines.train import argument_parser, load_pretrained, main, train
from hd_yolo_tpu_torch.models.yolo import Model


def make_dataset(tmp_path, n_images=4, task="det"):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_images):
        img = rng.integers(0, 255, (96, 96, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"img{i}.png"), img)
        boxes = np.array([[10, 10, 45, 45], [50, 50, 90, 88]], np.float32)
        polys = np.empty(2, object)
        for j, b in enumerate(boxes):
            polys[j] = [np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]], [b[0], b[3]]])]
        np.savez(tmp_path / f"ann{i}.npz", boxes=boxes, labels=np.array([1, 2]),
                 masks=polys, size=np.array([96, 96]))
        rows.append(f"img{i}.png,im{i},a{i},ann{i}.npz,{task},poly")
    csv = tmp_path / "index.csv"
    csv.write_text("image_path,image_id,ann_id,ann_path,task_id,mask_mode\n" + "\n".join(rows) + "\n")
    data_yaml = tmp_path / "data.yaml"
    meta = {task: {"labels_text": {1: "tumor", 2: "stromal", 3: "sTILs", 4: "other"}}}
    data_yaml.write_text(yaml.safe_dump({"train": str(csv), "val": str(csv), "tasks": [task],
                                         "meta_info": meta}))
    return str(data_yaml)


def args(data, save_dir, *extra):
    return ["--data", data, "--cfg", "yolov5s-test", "--hyp", "hyp-nuclei", "--device", "cpu",
            "--epochs", "2", "--batch-size", "2", "--nominal-batch-size", "2", "--img-size",
            "128", "--patch-size", "96", "--masks", "--no-bf16", "--workers", "2",
            "--max-targets", "16", "--mask-rois", "4", "--max-masks", "8",
            "--save-dir", save_dir, *extra]


def test_train_cli_end_to_end_and_resume(tmp_path):
    data = make_dataset(tmp_path)
    save_dir = str(tmp_path / "run")
    result = main(args(data, save_dir))
    assert "best_fitness" in result and result["save_dir"] == save_dir
    for name in ("last.pt", "last.json", "best.pt", "best.json", "final.pt", "hyp.yaml",
                 "results.csv"):
        assert os.path.isfile(os.path.join(save_dir, name)), name
    rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and "det/map50" in r for r in rows)   # validated each epoch
    saved = torch.load(os.path.join(save_dir, "last.pt"), weights_only=False)
    assert int(saved["step"]) == 4 and int(saved["opt"]["count"]) == 4
    assert checkpoint.load_meta(os.path.join(save_dir, "last"))["epoch"] == 1

    # resume: the restored state is the saved one, then a third epoch runs
    opt = argument_parser().parse_args(args(data, save_dir, "--resume", "--epochs", "3"))
    from hd_yolo_tpu_torch.engines import train as train_mod
    seen = {}
    orig = train_mod.restore_train_state

    def spy(path, state):
        state, meta = orig(path, state)
        seen.update(step=int(state.step), params={n: p.detach().clone() for n, p in
                                                  state.model.named_parameters()},
                    ema=[e.clone() for e in state.ema.params], names=state.opt.names)
        return state, meta

    train_mod.restore_train_state = spy
    try:
        train(opt)
    finally:
        train_mod.restore_train_state = orig
    assert seen["step"] == 4
    for n, p in seen["params"].items():
        assert torch.equal(p, saved["model"][n]), n
    for e, s in zip(seen["ema"], saved["ema"]):
        assert torch.equal(e, s)
    rows = [json.loads(l) for l in open(os.path.join(save_dir, "results.json"))]
    assert [r["epoch"] for r in rows] == [0, 1, 2]

    det = Detector("yolov5s-test", "hyp-nuclei", weights=os.path.join(save_dir, "final.pt"),
                   input_size=128, dtype=torch.float32, device="cpu", max_masks=8)
    out = det.tiles(np.random.default_rng(1).integers(0, 255, (2, 128, 128, 3), dtype=np.uint8))
    assert out["det"]["boxes"].shape[0] == 2


@pytest.mark.parametrize("flag,missing", [pytest.param(["--plots"], "matplotlib",
                                                         id="flag0-A.5")])
def test_deferred_flags_raise(tmp_path, monkeypatch, flag, missing):
    """A flag whose library does not import raises naming it, before the
    first step (the card's machine has no matplotlib)."""
    data = make_dataset(tmp_path, 2)
    monkeypatch.setitem(sys.modules, missing, None)        # import raises ImportError
    with pytest.raises(ImportError, match=missing):
        main(args(data, str(tmp_path / "run"), *flag))
    assert not os.path.exists(tmp_path / "run" / "last.pt")


def test_reference_weights_raise_and_port_weights_load(tmp_path):
    """A port ``.pt`` and a reference checkpoint that pickles its model
    (under ``ema``) load every tensor; a pickled class that cannot be
    imported raises naming the file and the class."""
    m = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    m.init_weights(torch.Generator().manual_seed(1))
    pt = checkpoint.save_inference(str(tmp_path / "w.pt"), m)
    m2 = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    assert load_pretrained(m2, pt) == len(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(m2.state_dict()[k], v)
    torch.save({"ema": m, "model": None, "epoch": 3}, str(tmp_path / "ref.pt"))
    m3 = Model.from_cfg("yolov5s-test", "hyp-nuclei")
    assert load_pretrained(m3, str(tmp_path / "ref.pt")) == len(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(m3.state_dict()[k], v)

    (tmp_path / "gone_models.py").write_text(
        "import torch\n\nclass RefModel(torch.nn.Conv2d):\n    pass\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import gone_models
        torch.save({"model": gone_models.RefModel(1, 1, 1)}, str(tmp_path / "gone.pt"))
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("gone_models", None)
    with pytest.raises(ImportError, match=r"gone\.pt.*gone_models\.RefModel"):
        load_pretrained(m3, str(tmp_path / "gone.pt"))


def test_runs_on_the_card_by_default(tmp_path):
    data = make_dataset(tmp_path, 2)
    a = [x for x in args(data, str(tmp_path / "run")) if x not in ("--device", "cpu")]
    assert argument_parser().parse_args(a).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(a)
