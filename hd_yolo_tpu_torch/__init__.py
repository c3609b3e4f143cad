"""hd_yolo_tpu_torch — the PyTorch/CUDA port of ``hd_yolo_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module names
(``models/layers.py``, ``ops/nms.py``, ...) so each counterpart is easy to
find.  It imports torch and nothing of JAX or of ``hd_yolo_tpu``.

The hot ops on the inference path are hand-written CUDA kernels for sm_90a
(``kernels/*.cu``), each beside a plain PyTorch version of the same function.
A wrapper picks by the tensor's device: a CUDA tensor launches the kernel, a
CPU tensor runs the plain version.  Entry points default to
``device="cuda"`` and raise when CUDA is missing.
"""

import logging
import os

__version__ = "0.1.0"

LOGGER = logging.getLogger("hd_yolo_tpu_torch")
if not LOGGER.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    LOGGER.addHandler(_h)
    LOGGER.setLevel(os.environ.get("HD_YOLO_LOGLEVEL", "INFO"))

from .config import load_cfg  # noqa: E402,F401


def __getattr__(name):  # lazy top-level API: hd_yolo_tpu_torch.Detector, .Ensemble, .HNet etc.
    if name in ("Detector", "Detections"):
        from . import detector

        return getattr(detector, name)
    if name == "Model":
        from .models.yolo import Model

        return Model
    if name == "Ensemble":
        from .models.ensemble import Ensemble

        return Ensemble
    if name == "HNet":
        from .hnet import HNet

        return HNet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
