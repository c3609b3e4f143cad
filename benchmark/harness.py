"""The benchmark's general driver: it finds a cell's configuration, traffic
mix, limits and metric readers by their names in ``BENCHMARK.json``, sets
the cell up from the seed, runs its closed loop for the window, traces a
short steady sub-window where asked, judges a seeded sample of the served
requests against the plain reference, and reduces it all to one result.

Files, each found by name (no cell has code of its own here):
  * ``configs/<config>.json``   the configuration (``BENCHMARK.json`` names the file);
  * ``workloads/<traffic>.json`` the traffic mix: its ``entry``
    (``entries/<entry>.py``), sizes, pool, calibration, judged sample and
    the spans a traced run places;
  * ``limits/<workload>.json``   the limit of each number ``correct`` compares;
  * ``metrics/<metric>.py``      the reader of each metric (``read(ctx)``);
  * ``spans/<span>.json``        the functions a traced run wraps in a span.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import sys
import time
from typing import Callable, Dict, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "hd_yolo_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, root: str, workload: str):
        self.bench = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
        self.w = cells[workload]
        self.dir = os.path.join(root, self.bench["paths"][0])
        centry = next(c for c in self.bench["configs"] if c["name"] == self.w["config"])
        self.cfg = read_json(os.path.join(root, centry["file"]))
        self.traffic = read_json(os.path.join(self.dir, "workloads", self.w["traffic"] + ".json"))
        lim = os.path.join(self.dir, "limits", workload + ".json")
        self.limits = read_json(lim)["limits"] if os.path.exists(lim) else {}

    def metrics(self, trace: bool):
        """This cell's metrics of the kind a run reports: end-to-end with
        ``trace`` off, per-layer with it on."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.w["name"] in m.get("workloads", [self.w["name"]])]

    def entry(self, seed: int, device):
        mod = load_module(os.path.join(self.dir, "entries", self.traffic["entry"] + ".py"),
                          "entry_" + self.traffic["entry"])
        return mod.Entry(self.cfg, self.traffic, seed, device)


def quantile(values, q: float) -> float:
    """Linear-interpolated ``q`` quantile (numpy's default definition)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def setup(cell: Cell, seed: int, device, t0: float) -> dict:
    """Everything before the first timed request: the seeded state, the
    pool, the reference's calibration, the program, the warm-up."""
    import torch

    import weights
    from entries.common import no_tf32

    marks = {"import_s": time.perf_counter() - t0}
    t = time.perf_counter()
    state = weights.seeded_state(cell.cfg, seed, device)
    entry = cell.entry(seed, device)
    marks["weights_and_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = weights.ref_model(cell.cfg, device, state)
    how = dict(cell.traffic["calibrate"], topk=cell.cfg["detector"]["pre_nms_topk"],
               max_masks=cell.cfg["detector"].get("max_masks", 300))
    with no_tf32():
        calib = weights.calibrate(ref, state, entry.calibration_input(), how)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    marks["reference_calibration_s"] = time.perf_counter() - t
    t = time.perf_counter()
    det = entry.build(state)
    lat = []
    for i in range(cell.traffic["warmup"]):
        t1 = time.perf_counter()
        entry.done(entry.call(det, i))
        lat.append(time.perf_counter() - t1)
    marks["program_and_warmup_s"] = time.perf_counter() - t
    return {"ref": ref, "entry": entry, "det": det, "calibration": calib,
            "warm_latency_s": lat[-1], "marks": marks}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             plant: Optional[Callable] = None, control: bool = False) -> dict:
    """One run of one cell → the result object (see ``run.py``).
    ``plant(out, i)`` rewrites each served output (a fault planted in the
    timed path, for the tests); ``control`` serves the reference computed
    in float8 in the program's place, after the window."""
    import torch

    import spans
    from entries.common import no_tf32, worst
    from reference.model import Prec

    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(root, workload)
    s = setup(cell, seed, device, t0)
    entry, det = s["entry"], s["det"]
    # the reference's calibration is the benchmark's own work, not set-up's
    setup_s = time.perf_counter() - t0 - s["marks"]["reference_calibration_s"]
    tr = cell.traffic
    sample = judged_sample(seed, tr["pool"], tr["judge"],
                           int(0.6 * seconds / max(s["warm_latency_s"], 1e-6)))
    kept, recent = {}, {}
    lat, enq = [], []
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        out = entry.call(det, i)
        b = time.perf_counter()
        entry.done(out)
        c = time.perf_counter()
        if plant is not None:
            out = plant(out, i)
        lat.append(c - a)
        enq.append(b - a)
        if i in sample:
            kept[i] = out
        recent[i % tr["pool"]] = (i, out)
        i += 1
        if c - start >= seconds:
            break
    window_s = time.perf_counter() - start
    mem = torch.cuda.max_memory_allocated() if on_card else 0
    for j in sorted(sample - set(kept)):       # past the window's end: the newest
        if j % tr["pool"] in recent:           # request on the same input, or one
            j, out = recent[j % tr["pool"]]    # served now where the window had none
        else:
            out = entry.call(det, j)
            entry.done(out)
            out = out if plant is None else plant(out, j)
        kept[j] = out
    del recent
    prof, span_args, prof_outs = None, {}, []
    if trace:
        sp = spans.Spans(cell.dir, tr["spans"])
        n_prof = tr["profile_requests"]

        def traced():
            for j in range(n_prof):
                prof_outs.append(entry.call(det, i + j))
                entry.done(prof_outs[-1])

        with sp:
            prof = spans.profile(traced, sp.defs.keys()) if on_card else None
            if not on_card:
                traced()
        prof = prof or {}
        prof["requests"] = n_prof
        span_args = sp.args
    mask_rois = entry.mask_rois(prof_outs or [kept[k] for k in sorted(kept)], span_args)
    del det, s["det"], prof_outs, span_args
    if on_card:
        torch.cuda.empty_cache()
    # the reference after the window, the program's state freed
    t_ref = time.perf_counter()
    rows = []
    with no_tf32():
        for j in sorted(kept):
            served = kept[j]
            if control:
                served = entry.serve_reference(s["ref"], j, Prec(fp8=True))
            rows.append(entry.judge(s["ref"], j, served, Prec(fp8=False)))
    judged = worst(rows)
    judge_s = time.perf_counter() - t_ref
    checks = {k: {"value": judged[k], "limit": cell.limits.get(k, float("inf"))}
              for k in judged if not k.startswith("n_")}
    failed_rows = sum(1 for r in rows if any(r[k] > cell.limits.get(k, float("inf"))
                                             for k in r if not k.startswith("n_")))
    ctx = {"cell": cell, "seconds": seconds, "setup_s": setup_s, "latencies_s": lat,
           "enqueue_s": enq, "window_s": window_s, "items": entry.items,
           "pixels": entry.pixels, "profile": prof, "mask_rois": mask_rois,
           "flops": _flops(cell), "trace": trace}
    metrics = {}
    for m in cell.metrics(trace):
        reader = load_module(os.path.join(cell.dir, "metrics", m["name"] + ".py"),
                             "metric_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": failed_rows == 0 and all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(lat), "failed": failed_rows, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1 if on_card else 0, "memory_peak_bytes": int(mem)},
    }
    if trace and prof and "busy_s" in prof:
        result["device"].update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
        top = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(prof["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v[0]] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    result["checks"] = checks
    result["_log"] = {"setup": dict(s["marks"], setup_s=setup_s), "judge_s": judge_s,
                      "calibration": s["calibration"], "judged": rows,
                      "requests_in_window": len(lat), "sample": sorted(kept)}
    return result


def judged_sample(seed: int, pool: int, n: int, requests: int) -> set:
    """``n`` request indices drawn from ``seed`` among the first
    ``requests``, each on another of the ``pool`` inputs (index % pool), so
    that every judged request is a distinct input."""
    rng = random.Random(int(seed))
    rounds = max(1, requests // pool)
    return {rng.randrange(rounds) * pool + e for e in rng.sample(range(pool), min(n, pool))}


def _flops(cell: Cell) -> Dict[str, float]:
    """The model's operations a request from the configuration's shapes
    (the reference on the meta device), per tile."""
    import weights
    import yardstick

    meta = weights.ref_model(cell.cfg, "meta")
    tag = meta.hspecs[0]["tag"]
    return yardstick.model_flops(meta, tag, 1, cell.cfg["input_size"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
