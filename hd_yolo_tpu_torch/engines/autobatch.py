"""AutoBatch: the largest batch size that fits the card's memory (port of
``hd_yolo_tpu/engines/autobatch.py``).

One representative step runs at each probe batch size; the peak memory it
allocated (``torch.cuda.max_memory_allocated`` after a reset) is fitted by
a line in the batch size, solved for ``fraction`` of the memory this
process can hold (``torch.cuda.mem_get_info``'s free bytes plus what its
allocator already reserved).  Off the card there are no memory statistics,
and the fallback batch size comes back.  Only an out-of-memory error ends
the probing early; any other error of a probe step is raised.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import LOGGER


def autobatch(step_fn: Callable[[int], None], fraction: float = 0.8,
              probes: Sequence[int] = (1, 2, 4), fallback: int = 16, device=None,
              info: Optional[Dict] = None) -> int:
    """``step_fn(batch_size)`` runs one representative step at that size.
    ``info``, where given, receives the fit: ``limit``, ``per_image`` and
    ``base`` bytes and the ``used`` bytes of each probe."""
    d = torch.device(device if device is not None else "cuda")
    if d.type != "cuda":
        LOGGER.info(f"autobatch: no memory stats on {d}; using fallback {fallback}")
        return fallback
    free, _ = torch.cuda.mem_get_info(d)
    limit = free + torch.cuda.memory_reserved(d)

    used = []
    for b in probes:
        torch.cuda.reset_peak_memory_stats(d)
        try:
            step_fn(b)
        except torch.cuda.OutOfMemoryError as e:       # out of memory at a probe size
            LOGGER.warning(f"autobatch: probe {b} failed ({e})")
            return max(probes[0], 1)
        used.append(torch.cuda.max_memory_allocated(d))

    # linear fit mem = k·b + base
    k, base = np.polyfit(list(probes), used, deg=1)
    if info is not None:
        info.update(limit=limit, per_image=float(k), base=float(base), used=used)
    if k <= 0:
        return fallback
    b_opt = max(int((limit * fraction - base) / k), 1)
    LOGGER.info(f"autobatch: limit={limit / 2**30:.1f}GiB fit k={k / 2**20:.0f}MiB/img "
                f"base={base / 2**30:.1f}GiB → batch {b_opt} at {fraction:.0%}")
    return b_opt
