"""Per cent of the card's bf16 peak that the model's work a batch takes of
the window's mean wall time a batch: the trunk, det and mask-branch convs
of every tile counted from the configuration's shapes, and the mask head
on the ROIs served with a mask."""

import yardstick


def read(ctx):
    f = ctx["flops"]
    work = ctx["items"] * (f["trunk"] + f.get("seg", 0.0)) + yardstick.mask_head_flops(
        ctx["mask_rois"])
    wall = ctx["window_s"] / len(ctx["latencies_s"])
    return 100.0 * work / (wall * yardstick.BF16_FLOPS)
