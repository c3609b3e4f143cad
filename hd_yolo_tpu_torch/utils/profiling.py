"""Profiling and model-info utilities (port of ``hd_yolo_tpu/utils/profiling.py``).

``Profile`` and ``Timeout`` time and guard a block; ``flops_of`` counts a
call's floating-point operations with ``torch.utils.flop_counter`` (the
operations PyTorch dispatches: convolutions, matmuls, their backwards — a
hand kernel launched through ``ctypes`` is not seen);
``device_memory_stats`` reads ``torch.cuda.memory_stats``; ``model_info``
sums parameters and FLOPs; ``measure_latency`` times calls on the card with
CUDA events after warm-ups; ``trace`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Any, Callable, Dict

import torch
from torch import nn

from .. import LOGGER


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profile(contextlib.ContextDecorator):
    """Wall-clock accumulator (context or decorator): ``dt`` the last block's
    seconds, ``t`` the sum.  The card is synchronized at both ends, so its
    queued work counts in the block that queued it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __enter__(self):
        _sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.dt = time.perf_counter() - self.start
        self.t += self.dt


class Timeout(contextlib.ContextDecorator):
    """SIGALRM guard: a block running past ``seconds`` gets ``TimeoutError``,
    swallowed where ``suppress`` (the main thread of a POSIX process only)."""

    def __init__(self, seconds: int, timeout_msg: str = "", suppress: bool = True):
        self.seconds = int(seconds)
        self.msg = timeout_msg
        self.suppress = suppress

    def _handler(self, signum, frame):
        raise TimeoutError(self.msg)

    def __enter__(self):
        signal.signal(signal.SIGALRM, self._handler)
        signal.alarm(self.seconds)

    def __exit__(self, exc_type, exc_val, exc_tb):
        signal.alarm(0)
        return self.suppress and exc_type is TimeoutError


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The floating-point operations of one call ``fn(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (a multiply-add
    is 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The card's allocator statistics (``torch.cuda.memory_stats``: current
    and peak bytes allocated and reserved, ...); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def model_info(model: nn.Module, input_shape=(1, 640, 640, 3), verbose: bool = False,
               **forward_kw) -> Dict[str, Any]:
    """Parameter count, tensor count and the GFLOPs of one forward on a
    zero batch of ``input_shape`` (``flops_of``; None where it fails),
    logged as one line (and each parameter with ``verbose``)."""
    params = list(model.named_parameters())
    n_params = sum(p.numel() for _, p in params)
    gflops = None
    try:
        dev = params[0][1].device if params else torch.device("cpu")
        x = torch.zeros(input_shape, dtype=torch.float32, device=dev)
        with torch.no_grad():
            gflops = flops_of(model, x, **forward_kw) / 1e9
    except Exception as e:   # the summary never fails its caller
        LOGGER.debug(f"flops estimate failed: {e}")
    msg = f"model summary: {len(params)} tensors, {n_params:,} parameters"
    if gflops:
        msg += f", {gflops:.1f} GFLOPs @ {input_shape[1]}px"
    LOGGER.info(msg)
    if verbose:
        for name, p in params:
            LOGGER.info(f"{name:60s} {tuple(p.shape)}")
    return {"n_params": n_params, "n_tensors": len(params), "gflops": gflops}


def measure_latency(fn: Callable, *args, iters: int = 10, warmup: int = 3) -> float:
    """Seconds a call of ``fn(*args)`` after ``warmup`` calls: on the card
    CUDA events around ``iters`` calls (device time of the queue), else the
    host clock."""
    for _ in range(warmup):
        fn(*args)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """A ``torch.profiler`` trace of the block (the CPU, and the card where
    there is one), written as a Chrome trace to ``log_dir/name``; yields the
    profiler (``key_averages()`` for a table)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts, record_shapes=True)
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, name))

