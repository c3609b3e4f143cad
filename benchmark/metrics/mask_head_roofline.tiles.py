"""Per cent of its roofline the mask head runs at: the least time of the
head's work on the ROIs served with a mask (operations of ``mask_head_flops``;
the pooled input and weights read once, the 28 x 28 probabilities written
once) at the card's peaks, over the mask-head kernel's device time a batch."""

import yardstick

KERNELS = ("mask_head_kernel",)


def read(ctx):
    p = ctx["profile"]
    n = ctx["mask_rois"]
    if not p or "kernels" not in p or n <= 0:
        return None
    t = sum(v[0] for k, v in p["kernels"].items() if any(s in k for s in KERNELS))
    if t <= 0:
        return None
    dtype = ctx["cell"].cfg["dtype"]
    least, _ = yardstick.least_seconds(yardstick.mask_head_bytes(n, dtype=dtype),
                                       yardstick.mask_head_flops(n), yardstick.PEAK[dtype])
    return 100.0 * least / (t / p["requests"])
