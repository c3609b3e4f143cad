"""Per cent of the traced sub-window's wall time in which nothing ran on the
card: 100 x (1 - busy / wall), busy the union of the device's kernel,
copy and set intervals."""


def read(ctx):
    p = ctx["profile"]
    if not p or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
