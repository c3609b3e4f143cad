"""Per cent of the card's bf16 peak that the model's work a slide takes of
the window's mean wall time a slide: the trunk, det and mask-branch convs
of each of the slide's tiles counted from the configuration's shapes, and the mask head
on the ROIs of a valid detection in its tiles' mask slots."""

import yardstick


def read(ctx):
    f = ctx["flops"]
    work = ctx["items"] * (f["trunk"] + f.get("seg", 0.0)) + yardstick.mask_head_flops(
        ctx["mask_rois"])
    wall = ctx["window_s"] / len(ctx["latencies_s"])
    return 100.0 * work / (wall * yardstick.BF16_FLOPS)
