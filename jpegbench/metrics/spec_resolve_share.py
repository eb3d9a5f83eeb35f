"""spec_resolve_share: the share of a decode call's wall time in the
speculative route's one host read, in %.

`spec_resolve` (runtime/fused.py, inside `launch`) is
fsm.spec_sync_resolve_host: the blocking read of the cold and stitch
scans' packed quotas, hits and flags, then the per-image chain check on
the host.  On this route it is the dispatching thread's wait for the
card.  Σ span_s["spec_resolve"] / Σ total_s over the window's calls.
Nothing to read where no call has the span (a program without it, or a
window with no speculative chunk)."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    if not any("spec_resolve" in s["span_s"] for s in stats):
        return None
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * sum(s["span_s"].get("spec_resolve", 0.0)
                       for s in stats) / total
