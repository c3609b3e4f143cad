"""Per cent of its roofline the stem runs at: the least time of the stem's
work (the float32 input, kernel, scale and bias read once, the output
written once; 2·B·Ho·Wo·N·k²·C operations) at the card's peaks, over the
device time a batch of the kernels that implement the stem."""

import yardstick
from reference.model import make_divisible

# the kernels that implement the first conv today: the bf16 ring form
# (``stem_tc``) and the direct kernel (``stem``)
KERNELS = ("stem_ring_kernel", "stem_bf16_kernel", "stem_tf32_kernel")


def read(ctx):
    p = ctx["profile"]
    if not p or "kernels" not in p:
        return None
    t = sum(v[0] for k, v in p["kernels"].items() if any(n in k for n in KERNELS))
    if t <= 0:
        return None
    cfg = ctx["cell"].cfg
    f, n, m, args = cfg["model"]["backbone"][0]
    gw = cfg["model"]["width_multiple"]
    N = make_divisible(args[0] * gw)
    S = cfg["input_size"]
    nbytes, flops = yardstick.stem_work(ctx["items"], S, S, 3, N, args[1], args[2], args[3],
                                        cfg["dtype"])
    least, _ = yardstick.least_seconds(nbytes, flops, yardstick.PEAK[cfg["dtype"]])
    return 100.0 * least / (t / p["requests"])
