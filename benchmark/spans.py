"""Spans placed from the benchmark's own files: each ``spans/<name>.json``
that a cell's workload file lists under ``spans`` names the functions of
the system it wraps at run time in a ``torch.profiler.record_function`` of
that name (and, where it says ``record_arg``, keeps that positional
argument, by reference, for a reader).  Nothing of the system is edited; the wrappers are removed after
the traced requests.  ``profile`` reduces one traced sub-window to what the
per-layer readers read."""

from __future__ import annotations

import functools
import importlib
import json
import os
import time
from typing import Callable, Dict, List

import torch


class Spans:
    def __init__(self, bench_dir: str, names: List[str]):
        """The spans ``names`` (a cell's workload file lists its own)."""
        self.defs = {}
        for name in names:
            with open(os.path.join(bench_dir, "spans", name + ".json")) as f:
                self.defs[name] = json.load(f)
        self.args: Dict[str, List] = {}
        self._undo = []

    def __enter__(self):
        from torch.profiler import record_function

        for name, d in self.defs.items():
            for t in d["targets"]:
                mod = importlib.import_module(t["module"])
                *path, attr = t["attr"].split(".")
                owner = functools.reduce(getattr, path, mod)
                orig = owner.__dict__[attr]
                self._undo.append((owner, attr, orig))
                setattr(owner, attr, self._wrap(name, orig, t.get("record_arg"), bool(path),
                                                record_function))
        return self

    def _wrap(self, name: str, fn: Callable, arg, method: bool, record_function):
        kept = self.args.setdefault(name, [])

        @functools.wraps(fn)
        def wrapped(*a, **k):
            if arg is not None:
                kept.append(a[arg + int(method)])
            with record_function(name):
                return fn(*a, **k)

        return wrapped

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile(run: Callable[[], None], span_names) -> dict:
    """``run()`` under the profiler (CPU and CUDA).  Returns the wall seconds
    (host clock, the work synchronised), the device's busy seconds (the
    union of its kernel, copy and set intervals), the kernel launches, the
    device seconds and calls of each kernel name, each span's calls, host
    seconds and device seconds of the kernels its ops launched, and the
    longest idle gaps with the span the host was in when each began."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    names = set(span_names)
    dev, kernels, spans = [], {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in names:
                continue
            s, t = e.time_range.start, e.time_range.end
            dev.append((s, t, e.name))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += (t - s) / 1e6
            k[1] += 1
        elif e.name in names:
            sp = spans.setdefault(e.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                                           "ranges": []})
            sp["calls"] += 1
            sp["host_s"] += (e.time_range.end - e.time_range.start) / 1e6
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = e.cuda_time_total
            sp["device_s"] += dt / 1e6
            sp["ranges"].append((e.time_range.start, e.time_range.end))
    busy = _union((s, t) for s, t, _ in dev) / 1e6
    launches = sum(1 for _, _, n in dev if not n.startswith(("Memcpy", "Memset")))
    gaps = []
    dev.sort()
    end = None
    for s, t, _ in dev:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = t if end is None else max(end, t)
    gaps.sort(reverse=True)

    def host_in(at):
        inner = [(r[1] - r[0], n) for n, sp in spans.items() for r in sp["ranges"]
                 if r[0] <= at <= r[1]]
        return min(inner)[1] if inner else "outside the spans"

    idle = {}
    for g, at in gaps:
        key = host_in(at)
        idle[key] = idle.get(key, 0.0) + g / 1e6
    for sp in spans.values():
        sp.pop("ranges")
    return {"wall_s": wall, "busy_s": busy, "launches": launches, "kernels": kernels,
            "spans": spans, "idle_by_span": idle}
