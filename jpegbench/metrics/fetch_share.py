"""fetch_share: the share of a decode call's wall time in the fetch of each
chunk's RGB to the host (runtime/batch._fetch: the interleave on the
device and the copy), as measured, where fetch_crop_share is the
remainder of the other shares, in %.

The program's `fetch` spans (BatchStats.span_s) summed over the window's
calls, over the sum of `total_s`.  Nothing to read where the program
records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("fetch", 0.0) for s in stats) / total
