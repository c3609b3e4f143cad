"""Worker processes of the port's tests across processes: each runs as one rank
of a gloo group on the CPU, imports torch and the port only, reads its
inputs from ``<io>/<case>_in.pt`` and writes ``<io>/<case>_out_<rank>.pt``.

    python tests/torch_parallel_workers.py --cases step,augment,slide \\
        --rank R --world N --store FILE --io DIR

Cases: ``step``, ``augment``, ``slide`` and ``packed`` (the sharded slide
with the packed mask branch) for ``tests/test_torch_parallel.py``, ``hnet``
for ``tests/test_torch_hnet_parallel.py``, ``mesh`` for
``tests/test_torch_mesh.py``.

``--device cuda`` runs the step, hnet and packed cases with both ranks on
the card (gloo carries the CUDA tensors; NCCL takes one rank a card).  ``--cases cli``
runs the training CLI instead (``engines/train.main`` with
the arguments of ``<io>/cli_args.json``) under torchrun's environment
contract (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``,
set by the caller), recording which files each rank writes and restores.
"""

import argparse
import datetime
import json
import logging
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hd_yolo_tpu_torch import LOGGER, parallel  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)


def case_step(rank, world, io, device):
    """One ``make_train_step(distributed=True)`` micro-step on this rank's
    half of the global batch."""
    from hd_yolo_tpu_torch.engines import optim as toptim
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.yolo import Model

    inp = torch.load(os.path.join(io, "step_in.pt"), weights_only=False)
    tm = Model.from_cfg("yolov5s-test", inp["hyp"], mask_rois=inp["mask_rois"])
    tm.load_state_dict(inp["state_dict"])
    tm.to(device)
    opt = toptim.build_optimizer(tm, inp["hyp"], 2, 8, accumulate=1)
    state = TrainState.create(tm, opt)
    batch = to_device(parallel.local_slice(inp["batch"], rank, world), device)
    state, metrics = make_train_step(distributed=True)(state, batch)
    return {"params": {n: p.detach().cpu() for n, p in zip(opt.names, opt.params)},
            "ema": {n: p.cpu() for n, p in zip(opt.names, state.ema.params)},
            "buffers": {n: b.cpu() for n, b in tm.named_buffers() if "running_" in n},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "step": int(state.step), "ema_updates": int(state.ema.updates)}


def case_augment(rank, world, io, device):
    """The device recipe of a distributed step on this rank's rows."""
    from hd_yolo_tpu_torch.data.device_augment import make_device_augment
    from hd_yolo_tpu_torch.engines.train_step import augment_batch

    inp = torch.load(os.path.join(io, "augment_in.pt"), weights_only=False)
    fn = make_device_augment(inp["hyp"], k_mosaic=2)
    local = parallel.local_slice(inp["batch"], rank, world)
    return augment_batch(fn, local, inp["seed"], inp["step"], distributed=True)


def case_slide(rank, world, io, device):
    """``slide_inference_sharded`` of ``yolov5s-test`` over the group."""
    from hd_yolo_tpu_torch.models.yolo import Model
    from hd_yolo_tpu_torch.wsi import slide_inference_sharded

    inp = torch.load(os.path.join(io, "slide_in.pt"), weights_only=False)
    m = Model.from_cfg("yolov5s-test", "hyp-nuclei", **inp["model_kw"])
    m.load_state_dict(inp["state_dict"])
    m.eval()
    return slide_inference_sharded(lambda t: m(t)["det"], inp["slide"],
                                   batch_per_device=inp["batch_per_device"], **inp["kw"])


def hnet_step(inp, rank, world, device="cpu"):
    """``inp['steps']`` ``make_train_step(distributed=True)`` micro-steps of
    an ``HNet`` (``inp``: cfg, state_dict, hyp, seed and the global batch)
    on this rank's rows (all of them at world 1, or outside a group): the
    last step's metrics and gradients (summed over the group) and every drop
    mask drawn are recorded."""
    from hd_yolo_tpu_torch.engines import optim as toptim
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.hnet import HNet, swin

    m = HNet(inp["cfg"], device=device)
    m.load_state_dict(inp["state_dict"], strict=True)
    m.train()
    opt = toptim.build_optimizer(m, inp["hyp"], 10, 10)
    state = TrainState.create(m, opt)
    batch = to_device(parallel.local_slice(inp["batch"], rank, world), device)
    draws = []

    def record(draw, shape):
        out = parallel.draw_rows(draw, shape)
        draws.append(out.cpu())
        return out

    swin.draw_rows = record
    seen = {}
    update = opt.update

    def spy(grads):                                 # the step's (all-reduced) gradients
        seen["grads"] = {n: None if g is None else g.detach().cpu().clone()
                         for n, g in zip(opt.names, grads)}
        return update(grads)

    opt.update = spy
    try:
        step = make_train_step(distributed=True, seed=inp["seed"])
        for _ in range(inp["steps"]):
            state, metrics = step(state, batch)
    finally:
        swin.draw_rows = parallel.draw_rows
    return {"params": {n: p.detach().cpu() for n, p in zip(opt.names, opt.params)},
            "buffers": {n: b.cpu() for n, b in m.named_buffers() if "running_" in n},
            "metrics": {k: float(v) for k, v in metrics.items()}, "draws": draws,
            "grads": seen["grads"]}


def case_hnet(rank, world, io, device):
    """The hnet step of each configuration of ``hnet_in.pt``."""
    inp = torch.load(os.path.join(io, "hnet_in.pt"), weights_only=False)
    return {name: hnet_step(c, rank, world, device) for name, c in inp.items()}


def case_mesh(rank, world, io, device):
    """One step of ``yolov5s-test`` on a (data, model) mesh of each shape of
    ``mesh_in.pt``, its parameters placed by ``shard_params_tp``: the shards
    each rank holds, then the whole parameters and the metrics; and the same
    step with every parameter whole (``make_train_step`` over the mesh's
    ``data`` group, no placement)."""
    from hd_yolo_tpu_torch.engines import optim as toptim
    from hd_yolo_tpu_torch.engines.train_step import TrainState, make_train_step, to_device
    from hd_yolo_tpu_torch.models.yolo import Model

    inp = torch.load(os.path.join(io, "mesh_in.pt"), weights_only=False)
    out = {}
    for shape in inp["shapes"]:
        mesh = parallel.create_mesh(shape)
        d = mesh.get_local_rank(parallel.DATA_AXIS)
        batch = to_device(parallel.local_slice(inp["batch"], d, shape[0]), device)
        res = {}
        for placed_run in (True, False):
            tm = Model.from_cfg("yolov5s-test", inp["hyp"], mask_rois=inp["mask_rois"])
            tm.load_state_dict(inp["state_dict"])
            opt = toptim.build_optimizer(tm, inp["hyp"], 2, 8, accumulate=1)
            state = TrainState.create(tm, opt)
            if placed_run:
                placed = parallel.shard_params_tp(tm, mesh, inp["min_size"])
                res["held"] = {n: tuple(p.shape) for n, p in tm.named_parameters()}
                step = parallel.make_mesh_train_step(mesh, placed)
            else:
                step = make_train_step(distributed=True,
                                       group=mesh.get_group(parallel.DATA_AXIS))
            state, metrics = step(state, batch)
            key = "" if placed_run else "whole_"
            if placed_run:
                res["after"] = {n: tuple(p.shape) for n, p in tm.named_parameters()}
                parallel.unshard_params(tm, placed)
            res[key + "params"] = {n: p.detach().cpu().clone() for n, p in tm.named_parameters()}
            res[key + "metrics"] = {k: float(v) for k, v in metrics.items()}
        out[tuple(shape)] = res
    return out


def case_packed(rank, world, io, device):
    """``slide_inference_sharded`` of ``yolov5s-test`` with the packed mask
    branch over the group."""
    from hd_yolo_tpu_torch.models.yolo import Model
    from hd_yolo_tpu_torch.wsi import slide_inference_sharded

    inp = torch.load(os.path.join(io, "packed_in.pt"), weights_only=False)
    m = Model.from_cfg("yolov5s-test", "hyp-nuclei", **inp["model_kw"])
    m.load_state_dict(inp["state_dict"])
    m.eval().to(device)
    return slide_inference_sharded(lambda t: m(t)["det"], inp["slide"].to(device),
                                   batch_per_device=inp["batch_per_device"], **inp["kw"])


def run_cli(rank, io):
    """``engines/train.main`` under torchrun's environment, every file write
    and restore recorded with the rank that made it."""
    from hd_yolo_tpu_torch.engines import train as train_mod

    record = {"writes": [], "restores": [], "warnings": []}

    def spy(name, fn, key):
        def wrapped(*a, **k):
            record[key].append([name, str(a[0]) if a else ""])
            return fn(*a, **k)
        setattr(train_mod, name, wrapped)

    spy("save_cfg", train_mod.save_cfg, "writes")
    orig_save = torch.save

    def save(obj, f, *a, **k):                     # the checkpoints' writes
        record["writes"].append(["torch.save", os.path.basename(str(f))])
        return orig_save(obj, f, *a, **k)

    torch.save = save
    spy("restore_train_state", train_mod.restore_train_state, "restores")
    orig_loggers = train_mod.Loggers

    def loggers(save_dir):
        record["writes"].append(["Loggers", str(save_dir)])
        return orig_loggers(save_dir)

    train_mod.Loggers = loggers

    class Catch(logging.Handler):
        def emit(self, rec):
            if rec.levelno >= logging.WARNING:
                record["warnings"].append(rec.getMessage())

    LOGGER.addHandler(Catch())
    with open(os.path.join(io, "cli_args.json")) as f:
        argv = json.load(f)
    out = train_mod.main(argv)
    record["result"] = {k: v for k, v in out.items() if isinstance(v, (int, float, str))}
    record["group_left"] = not parallel.is_initialized()
    with open(os.path.join(io, f"cli_out_{rank}.json"), "w") as f:
        json.dump(record, f)


CASES = {"step": case_step, "augment": case_augment, "slide": case_slide, "hnet": case_hnet,
         "mesh": case_mesh, "packed": case_packed}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cases", required=True)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--store", default="")
    p.add_argument("--io", required=True)
    p.add_argument("--device", default="cpu", help="cpu, or cuda: the ranks share the card "
                   "(gloo carries CUDA tensors)")
    a = p.parse_args()
    if a.device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    if a.cases == "cli":
        run_cli(int(os.environ["RANK"]), a.io)
        return
    dist.init_process_group("gloo", store=dist.FileStore(a.store, a.world), rank=a.rank,
                            world_size=a.world, timeout=TIMEOUT)
    try:
        for case in a.cases.split(","):
            out = CASES[case](a.rank, a.world, a.io, a.device)
            torch.save(out, os.path.join(a.io, f"{case}_out_{a.rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
