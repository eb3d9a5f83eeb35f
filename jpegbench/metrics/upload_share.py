"""upload_share: the share of a decode call's wall time in a host route's
coefficient, quant and extent upload from the dispatching thread
(runtime/batch._process_chunk_host), in %.

The program's `upload` spans (BatchStats.span_s) summed over the
window's calls, over the sum of `total_s`.  Nothing to read where the
program records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("upload", 0.0) for s in stats) / total
