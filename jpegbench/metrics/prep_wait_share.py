"""prep_wait_share: the share of a decode call's wall time that the
dispatching thread waits for a chunk's preparation on the prep pool (the
plan and its staged upload, runtime/batch._prepare_chunk), in %.

The program's `prep_wait` spans (BatchStats.span_s) summed over the
window's calls, over the sum of `total_s`.  Nothing to read where the
program records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("prep_wait", 0.0) for s in stats) / total
