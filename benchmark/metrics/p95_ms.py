"""95th percentile of the latency of every request in the window: a tile
batch from the call to its outputs synchronised, a slide from the call to
its rows on the host (host clock; the count is on the run's log)."""

from harness import quantile


def read(ctx):
    return quantile(ctx["latencies_s"], 0.95) * 1e3
