"""Tiles of every batch completed in the window over the window (host clock)."""


def read(ctx):
    return len(ctx["latencies_s"]) * ctx["items"] / ctx["window_s"]
