"""Host milliseconds from the call into ``Detector.tiles`` to its return,
before the synchronisation, mean over the window's batches."""


def read(ctx):
    e = ctx["enqueue_s"]
    return sum(e) / len(e) * 1e3 if e else None
