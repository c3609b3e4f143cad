"""Build and bind the hand-written Hopper kernels.

Each ``*.cu`` file in this directory is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, and loaded with
``ctypes``.  Sources are built at first use (or all at once, in parallel, by
:func:`build_all`) into ``build/`` beside them, keyed by a hash of the source
and flags, so a changed source is rebuilt and an unchanged one is reused.

Every C entry point launches on the caller's CUDA stream, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it.
:func:`constants` reads a source's ``constexpr int`` limits without building
it, so that a wrapper plans by the kernel's own numbers.  Nothing
here imports torch's CUDA runtime or runs ``nvcc`` at import time: the CPU
tests import every module.

:func:`register_op` makes a launch function the CUDA kernel of a
``torch.library`` op ``hd_yolo_tpu_torch::<name>`` with a fake
implementation of its outputs, so ``torch.export`` keeps the launch as one
call in its graph.
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import operator
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# source stem → extra nvcc flags.  NMS must not contract its IoU arithmetic
# into FMAs: the conflict test ``IoU > thr`` has to see the same float32
# values as the plain version (its source also uses explicit _rn intrinsics).
KERNELS: Dict[str, list] = {
    "stem": [],
    "nms": ["--fmad=false"],
    "roi_align": [],
    "mask_head": [],
    "mask_head_f32": [],
    "roi_align_single": [],
    "stem_k108": [],
    "stem_dot108": [],
    "stem_tc": [],
    "stem_tf32": [],
    "roi_align_bwd": [],
    "roi_align_single_bwd": [],
}

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name → (library, argtypes)
_SIGNATURES = {
    "stem_conv": ("stem", [_P] * 5 + [_I] * 12 + [_P]),
    "stem_conv_plan": ("stem", [_I] * 10 + [_P]),
    "nms_keep": ("nms", [_P] * 5 + [_I, _I, _I, _F, _I, _P]),
    "roi_align_bounded": ("roi_align", [_P, _I] + [_P] * 6 + [_I] * 8 + [_P]),
    "roi_align_bounded_bwd": ("roi_align_bwd", [ctypes.c_char_p, _I] + [_P] * 7 + [_I] * 9 + [_P]),
    "mask_head": ("mask_head", [_P] * 9 + [_I, _I, _P]),
    "mask_head_f32": ("mask_head_f32", [_P] * 10 + [_I, _I, _P]),
    "mask_head_f32_smem_bytes": ("mask_head_f32", []),
    "roi_align_levels": ("roi_align_single", [ctypes.c_char_p, _I, _P] + [_I] * 7 + [_P]),
    "roi_align_levels_limits": ("roi_align_single", [_I]),
    "roi_align_levels_bwd": ("roi_align_single_bwd", [ctypes.c_char_p, _I, _P] + [_I] * 7 + [_P]),
    "roi_align_levels_bwd_rois": ("roi_align_single_bwd", [_P] * 3 + [_I] * 11 + [_P]),
    "stem_k108": ("stem_k108", [_P] * 5 + [_I] * 6 + [_P]),
    "stem_dot108": ("stem_dot108", [_P] * 5 + [ctypes.c_longlong, _I, _P]),
    "stem_tc": ("stem_tc", [_P] * 5 + [_I] * 7 + [_P]),
    "mask_head_smem_bytes": ("mask_head", []),
    "stem_tc_smem_bytes": ("stem_tc", [_I, _I, _I]),
    "stem_tf32": ("stem_tf32", [_P] * 5 + [_I] * 7 + [_P]),
    "stem_tf32_smem_bytes": ("stem_tf32", [_I, _I, _I]),
}


def register_op(name: str, schema: str, launch, fake):
    """Define the functional op ``hd_yolo_tpu_torch::<name>(schema)``, with
    ``launch`` as its CUDA kernel and ``fake`` giving its outputs' shapes
    and dtypes; returns its ``OpOverload``.  (``torch.library.define`` /
    ``impl`` rather than ``custom_op``: the latter's Python autograd and
    dispatch layers cost ~4x the host time a call, on a host-bound path.)"""
    import torch

    qualname = f"hd_yolo_tpu_torch::{name}"
    torch.library.define(qualname, schema)
    torch.library.impl(qualname, "cuda", launch)
    torch.library.register_fake(qualname, fake)
    return getattr(torch.ops.hd_yolo_tpu_torch, name).default


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_CONSTANTS: Dict[str, Dict[str, int]] = {}
_CONSTEXPR = re.compile(r"^constexpr int (\w+) = ([^;]+);", re.M)
_INT_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
            ast.Div: operator.floordiv, ast.LShift: operator.lshift}


def constants(name: str) -> Dict[str, int]:
    """The namespace-scope ``constexpr int`` constants of ``<name>.cu`` that
    are a literal or integer arithmetic on earlier ones (one built on a
    macro is left out), read from the source: no build, so the CPU tests
    plan by them too."""
    if name not in _CONSTANTS:
        with open(os.path.join(_DIR, name + ".cu")) as f:
            src = f.read()
        vals: Dict[str, int] = {}

        def ev(node):
            if isinstance(node, ast.Constant) and type(node.value) is int:
                return node.value
            if isinstance(node, ast.Name) and node.id in vals:
                return vals[node.id]
            if isinstance(node, ast.BinOp) and type(node.op) in _INT_OPS:
                left, right = ev(node.left), ev(node.right)
                return None if left is None or right is None else \
                    _INT_OPS[type(node.op)](left, right)
            return None

        for key, expr in _CONSTEXPR.findall(src):
            v = ev(ast.parse(expr.strip(), mode="eval").body)
            if v is not None:
                vals[key] = v
        _CONSTANTS[name] = vals
    return _CONSTANTS[name]


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")


def _flags(name: str) -> list:
    return ARCH_FLAGS + BASE_FLAGS + KERNELS[name]


def _lib_path(name: str) -> str:
    src = os.path.join(_DIR, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_DIR, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    out = _lib_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so.tmp", delete=False).name
    cmd = [nvcc()] + _flags(name) + ["-o", tmp, os.path.join(_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel, one ``nvcc`` per source, all started together.
    Returns the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = {n: _start_build(n) for n in KERNELS}
    errors = []
    for n, job in jobs.items():
        if job is not None:
            try:
                _finish_build(n, job)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v``'s lines for one source (registers, shared memory
    and spill bytes of each kernel), from a build into a scratch file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        cmd = [nvcc()] + _flags(name) + ["-Xptxas", "-v", "-o", os.path.join(d, "lib.so"),
                                         os.path.join(_DIR, name + ".cu")]
        r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {r.returncode}):\n{r.stdout}{r.stderr}")
    return "\n".join(line.strip() for line in (r.stdout + r.stderr).splitlines()
                     if "ptxas" in line or "spill" in line)


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return _LIBS[name]


def fn(symbol: str):
    """The bound C entry point ``symbol`` (building its source if needed)."""
    if symbol not in _FNS:
        lib_name, argtypes = _SIGNATURES[symbol]
        f = getattr(_lib(lib_name), symbol)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[symbol] = f
    return _FNS[symbol]


def check(code: int, symbol: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch: cudaError {code}")


def device_and_stream(t):
    """(device index, raw handle of the current CUDA stream) for ``t``: the
    raw accessor where torch has it (a few µs less host time a launch than
    building a ``torch.cuda.Stream``), else the public one."""
    import torch

    index = t.device.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return index, raw(index)
    return index, torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
