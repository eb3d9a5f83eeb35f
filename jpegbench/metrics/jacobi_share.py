"""jacobi_share: the share of the window's chunks whose single-pass
resolve missed, so that the speculative route ran the Jacobi fixed point
(backend "fsm-spec"), in %.

Counter: Σ spec_sync_misses / Σ chunks over the calls whose record holds
the `spec_scan` span (the speculative route's cold and stitch scans).
Nothing to read where no call has that span (a program without it, or a
window with no speculative chunk)."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "spec_scan" in
             s.get("span_s", {})]
    chunks = sum(s["chunks"] for s in stats)
    if chunks == 0:
        return None
    return 100.0 * sum(s["spec_sync_misses"] for s in stats) / chunks
