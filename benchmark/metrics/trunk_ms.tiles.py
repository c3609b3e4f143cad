"""Device milliseconds a batch of the kernels launched inside
``Model.trunk`` (the ``bench.trunk`` span)."""


def read(ctx):
    p = ctx["profile"]
    sp = (p or {}).get("spans", {}).get("bench.trunk")
    return sp["device_s"] / p["requests"] * 1e3 if sp and sp["device_s"] > 0 else None
