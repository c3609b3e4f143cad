"""Offline evaluation / deployment benchmark harness (port of
``hd_yolo_tpu/engines/evaluate.py``).

* ``build_model`` rebuilds the architecture on its device, loads the
  weights (or seeds them), applies ``nms_params`` overrides, and returns the
  model with its forward;
* ``export`` writes the deployable artifact: ``torch.export`` of the
  forward at one static input shape, saved as a ``.pt2`` file.  The
  hand-written kernels are ``torch.library`` custom ops, so they stay calls
  of the exported graph; ``load_exported`` needs this package importable,
  and imports the modules that register them;
* ``inference_on_loader``: resize to ``input_size`` → forward → rescale the
  boxes back → wall-clock ``time_per_image`` (resize and host fetch
  included);
* ``run``: results cached per experiment name (``<name>_results.pkl`` and
  ``<name>_stats.json``, both required for a cache hit).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import LOGGER
# the kernels' custom ops, registered at import: an exported program calls them
from ..ops import pallas_mask_head, pallas_nms, pallas_roi_align, pallas_stem  # noqa: F401
from ..data.preproc import model_input
from ..ops.boxes import scale_coords
from .checkpoint import load_inference
from .val import to_host


def build_model(cfg, hyp, weights: Optional[str] = None,
                nms_params: Optional[Dict[str, float]] = None, dtype=torch.bfloat16,
                device="cuda", seed: int = 0, **model_kwargs):
    """Rebuild the architecture + load weights → (model on ``device``, forward).

    ``forward(x, compute_masks=True)`` runs the model on a batch already on
    the device.  ``nms_params`` overrides the per-task hyp values; without
    ``weights`` the model gets seeded random weights (``seed``)."""
    from ..config import load_cfg
    from ..detector import resolve_device
    from ..models.yolo import Model

    device = resolve_device(device)
    hyp = load_cfg(hyp)
    if nms_params:
        for section in hyp.values():
            if isinstance(section, dict) and "conf_thres" in section:
                section.update(nms_params)
    model = Model.from_cfg(cfg, hyp, dtype=dtype, **model_kwargs)
    if weights:
        load_inference(weights, model)
    else:  # random weights (compile check / random-weight benchmarking)
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.eval().to(device)

    def forward(x, compute_masks: bool = True):
        return model(x, compute_masks=compute_masks)

    return model, forward


class _Forward(torch.nn.Module):
    """``model`` with ``compute_masks`` fixed: the exported program takes the batch alone."""

    def __init__(self, model, compute_masks: bool):
        super().__init__()
        self.model = model
        self.compute_masks = compute_masks

    def forward(self, x):
        return self.model(x, compute_masks=self.compute_masks)


def export(model, input_shape, path: str, compute_masks: bool = True) -> str:
    """Serialize the inference program of ``model`` at the static uint8
    input ``input_shape`` (B, H, W, 3) with ``torch.export`` → ``path``
    (``.pt2``).

    One eager forward on the zero batch runs first: it fills the model's
    folded-weight caches (``models/layers.cached``), which the trace then
    takes as constants of the graph, so the exported step does no weight
    folding or packing a call."""
    device = next(model.parameters()).device
    x = torch.zeros(tuple(input_shape), dtype=torch.uint8, device=device)
    model(x, compute_masks=compute_masks)
    program = torch.export.export(_Forward(model, compute_masks), (x,), strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path: str) -> torch.nn.Module:
    """The exported program at ``path`` as a callable module: ``m(x)`` on a
    uint8 batch of the exported shape → {task: outputs}."""
    return torch.export.load(path).module()


def kernel_calls(program) -> Dict[str, int]:
    """How many times the graph of ``program`` (an ``ExportedProgram`` or
    the module ``load_exported`` returns) calls each of this package's
    custom ops, subgraphs included: {op name: calls}."""
    gm = getattr(program, "graph_module", program)
    calls: Dict[str, int] = {}
    for mod in gm.modules():
        if isinstance(mod, torch.fx.GraphModule):
            for node in mod.graph.nodes:
                name = str(node.target)
                if node.op == "call_function" and name.startswith("hd_yolo_tpu_torch."):
                    op = name.split(".")[1]
                    calls[op] = calls.get(op, 0) + 1
    return calls


def inference_on_loader(fwd: Callable, data_iter, input_size: int = 640,
                        compute_masks: bool = True, task: Optional[str] = None,
                        device="cuda") -> Dict[str, Any]:
    """Run deployment inference over (images, original sizes) batches.

    ``fwd(x, compute_masks)`` is :func:`build_model`'s forward; the batches
    go to ``device``.  Returns {'outputs': per-image host dicts with boxes
    rescaled to the original frames, 'time_per_image': wall-clock seconds
    (resize and host fetch included)}."""
    outputs: List[Dict[str, Any]] = []
    total_time, n_images = 0.0, 0
    for images, orig_sizes in data_iter:
        t0 = time.time()
        x = model_input(images, input_size, device)
        out = to_host(fwd(x, compute_masks))  # host fetch = sync
        total_time += time.time() - t0
        B = x.shape[0]
        n_images += B
        task_ids = [task] if task else list(out.keys())
        for i in range(B):
            rec: Dict[str, Any] = {}
            for t in task_ids:
                o = out[t]
                v = o["valid"][i]
                boxes = scale_coords((input_size, input_size), torch.from_numpy(o["boxes"][i]),
                                     tuple(int(s) for s in orig_sizes[i])).numpy()
                rec[t] = {
                    "boxes": boxes[v],
                    "scores": o["scores"][i][v],
                    "labels": o["labels"][i][v],
                }
                if "masks" in o:
                    # masks exist only for the first R score-ordered slots;
                    # pad to detection capacity so rows align with boxes[v]
                    m = o["masks"][i]
                    R, D = m.shape[0], v.shape[0]
                    mfull = np.zeros((D,) + m.shape[1:], m.dtype)
                    mfull[:R] = m
                    hm = np.zeros((D,), bool)
                    hm[:R] = o["mask_valid"][i]
                    rec[t]["masks"] = mfull[v]
                    rec[t]["has_mask"] = hm[v]
            outputs.append(rec)
    return {"outputs": outputs, "time_per_image": total_time / max(n_images, 1)}


def run(experiments: Dict[str, Dict[str, Any]], data_iter_fn: Callable[[], Any],
        output_dir: str = "./eval_results", input_size: int = 640, compute_masks: bool = True,
        force: bool = False, device="cuda") -> Dict[str, Any]:
    """Benchmark several model configurations with result caching.

    experiments: name → {'cfg', 'hyp', 'weights'?, 'nms_params'?, 'task'?,
    'model_kwargs'?}."""
    from ..detector import resolve_device

    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    summary = {}
    for name, exp in experiments.items():
        cache = os.path.join(output_dir, f"{name}_results.pkl")
        stats_path = os.path.join(output_dir, f"{name}_stats.json")
        if os.path.exists(cache) and os.path.exists(stats_path) and not force:
            # both files: a crash between the two writes recomputes
            LOGGER.info(f"[{name}] cached → {cache}")
            with open(stats_path) as f:
                summary[name] = json.load(f)
            continue
        LOGGER.info(f"[{name}] building model")
        model, fwd = build_model(exp["cfg"], exp["hyp"], exp.get("weights"),
                                 exp.get("nms_params"), device=device,
                                 **exp.get("model_kwargs", {}))
        res = inference_on_loader(fwd, data_iter_fn(), input_size=input_size,
                                  compute_masks=compute_masks, task=exp.get("task"),
                                  device=device)
        with open(cache, "wb") as f:
            pickle.dump(res["outputs"], f)
        stats = {
            "time_per_image": res["time_per_image"],
            "images_per_sec": 1.0 / max(res["time_per_image"], 1e-9),
            "n_images": len(res["outputs"]),
        }
        with open(stats_path, "w") as f:
            json.dump(stats, f)
        summary[name] = stats
        LOGGER.info(f"[{name}] {stats}")
    return summary


def main(argv=None):
    """CLI: benchmark a model config over a synthetic or csv-indexed set,
    on the card by default:

        python -m hd_yolo_tpu_torch.engines.evaluate --cfg yolov5l6-mask \
            [--weights model.pt] [--data index.csv] [--n 32] [--img-size 640] \
            [--device cpu]
    """
    import argparse

    p = argparse.ArgumentParser("hd_yolo_tpu_torch evaluate")
    p.add_argument("--cfg", default="yolov5l6-mask")
    p.add_argument("--hyp", default="hyp-nuclei")
    p.add_argument("--weights", default=None)
    p.add_argument("--data", default=None, help="index csv (synthetic batch if omitted)")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--img-size", dest="img_size", type=int, default=640)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=8)
    p.add_argument("--no-masks", dest="masks", action="store_false")
    p.add_argument("--output", default="./eval_results")
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)

    def data_iter():
        if opt.data:
            from ..data.dataset import DataLoader, DetectionDataset

            ds = DetectionDataset(opt.data, {"img_size": opt.img_size}, train=False)
            for b in DataLoader(ds, opt.batch_size, drop_last=False):
                B = b["image"].shape[0]
                yield b["image"], [(opt.img_size, opt.img_size)] * B
        else:
            rng = np.random.default_rng(0)
            for _ in range(max(opt.n // opt.batch_size, 1)):
                imgs = rng.uniform(0, 1, (opt.batch_size, opt.img_size, opt.img_size, 3))
                yield imgs.astype(np.float32), [(opt.img_size, opt.img_size)] * opt.batch_size

    summary = run(
        {"model": {"cfg": opt.cfg, "hyp": opt.hyp, "weights": opt.weights}},
        data_iter, output_dir=opt.output, input_size=opt.img_size,
        compute_masks=opt.masks, force=opt.force, device=opt.device,
    )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
