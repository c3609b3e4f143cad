"""What both entries share: the program's Detector on a seeded state dict,
the host pool of inputs from the seed, TF32 kept off for the reference."""

from __future__ import annotations

import ast
import contextlib
import inspect
import textwrap
from typing import Dict, List

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# what ``Detector.__init__`` sets, and so what ``detector`` sets in its place
DETECTOR_ATTRS = {"device", "model", "input_size", "labels_text"}


def init_attrs(cls) -> set:
    """The ``self.<name>`` that ``cls.__init__``'s source assigns."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(cls.__init__)))
    return {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.ctx, ast.Store) and isinstance(n.value, ast.Name)
            and n.value.id == "self"}


def detector(cfg: dict, extra: dict, state: Dict[str, torch.Tensor], device):
    """The system's ``Detector`` on ``cfg`` with ``state`` loaded: the model
    built on the meta device by ``Model.from_cfg`` (the arguments
    ``Detector`` passes it), its storage made on ``device`` and filled by
    ``load_state_dict`` (strict), so no weight is drawn on the host.
    ``Detector.__init__`` is bypassed (it draws every weight on the host),
    so this fails, rather than serve a Detector short of some state, if
    that ``__init__`` comes to set anything but ``DETECTOR_ATTRS``."""
    from hd_yolo_tpu_torch.detector import Detector
    from hd_yolo_tpu_torch.models.yolo import Model

    if init_attrs(Detector) != DETECTOR_ATTRS:
        raise RuntimeError(
            f"Detector.__init__ sets {sorted(init_attrs(Detector))}, and the benchmark builds "
            f"a Detector with only {sorted(DETECTOR_ATTRS)} set: it needs a public way to "
            f"build a Detector on given weights without drawing them on the host")
    kw = dict(cfg.get("detector", {}), **extra)
    with torch.device("meta"):
        model = Model.from_cfg(cfg["model"], cfg["hyp"], dtype=DTYPES[cfg["dtype"]], **kw)
    model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    model.eval()
    det = Detector.__new__(Detector)
    det.device, det.model = torch.device(device), model
    det.input_size, det.labels_text = cfg["input_size"], {}
    assert set(vars(det)) == DETECTOR_ATTRS
    return det


def host_pool(shape, n: int, seed: int, device) -> List[np.ndarray]:
    """``n`` distinct uint8 arrays of ``shape`` (uniform pixels) from
    ``seed``, drawn on the card and kept in (pageable) host memory."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return [torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                          dtype=torch.uint8).cpu().numpy() for _ in range(n)]


@contextlib.contextmanager
def no_tf32():
    """float32 products stay float32 (the reference's precision)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def worst(rows: List[dict]) -> dict:
    """Each number's worst (largest) reading over the judged requests; the
    counts summed."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = out.get(k, 0) + v if k.startswith("n_") else max(out.get(k, 0.0), v)
    return out
