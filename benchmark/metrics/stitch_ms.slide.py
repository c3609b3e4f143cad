"""Host milliseconds a slide inside the stitch and the fetch
(``bench.stitch`` + ``bench.fetch`` spans): the band NMS and gather
enqueued, then the one copy to the host, which waits for the card."""


def read(ctx):
    p = ctx["profile"]
    sp = (p or {}).get("spans", {})
    if "bench.stitch" not in sp or "bench.fetch" not in sp:
        return None
    return (sp["bench.stitch"]["host_s"] + sp["bench.fetch"]["host_s"]) / p["requests"] * 1e3
