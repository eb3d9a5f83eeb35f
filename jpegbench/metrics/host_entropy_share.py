"""host_entropy_share: the share of a decode call's wall time in a host
route's entropy decode: the native decoder on BatchDecoder's pool
(runtime/host.py) and the padding of each image's coefficients into the
chunk's raster, in %.

The program's `host_entropy` spans (BatchStats.span_s) summed over the
window's calls, over the sum of `total_s`.  Nothing to read where the
program records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("host_entropy", 0.0) for s in stats) / total
