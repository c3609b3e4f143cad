"""Device kernels launched a tile batch (profiler count over the traced
batches; copies and sets not counted)."""


def read(ctx):
    p = ctx["profile"]
    return p["launches"] / p["requests"] if p and p.get("launches") else None
