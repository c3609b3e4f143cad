"""Seconds from the process's start to the first timed request (host
clock), less the reference's calibration (the benchmark's own work)."""


def read(ctx):
    return ctx["setup_s"]
