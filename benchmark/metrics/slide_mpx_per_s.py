"""Slide megapixels of every slide completed in the window over the window
(host clock)."""


def read(ctx):
    return len(ctx["latencies_s"]) * ctx["pixels"] / 1e6 / ctx["window_s"]
