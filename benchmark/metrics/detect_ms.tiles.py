"""Device milliseconds a batch of the kernels launched inside the headers'
``Detect.forward`` (the ``bench.detect`` span: det convs, decode, NMS,
scores, mask branch)."""


def read(ctx):
    p = ctx["profile"]
    sp = (p or {}).get("spans", {}).get("bench.detect")
    return sp["device_s"] / p["requests"] * 1e3 if sp and sp["device_s"] > 0 else None
