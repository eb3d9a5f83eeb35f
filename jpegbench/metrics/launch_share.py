"""launch_share: the share of a decode call's wall time enqueueing the
device chains: the fused chains (runtime/fused.py), the staged and
speculative chains (ops/fsm.py), the gather decoder and the pixel stage
(pipeline.device_decode_fn), on every dispatch and retry, in %.

The program's `launch` spans (BatchStats.span_s) summed over the
window's calls, over the sum of `total_s`.  Nothing to read where the
program records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("launch", 0.0) for s in stats) / total
