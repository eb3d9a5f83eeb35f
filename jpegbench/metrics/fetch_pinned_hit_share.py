"""fetch_pinned_hit_share: the share of the window's fetched chunks whose
page-locked host block came from PyTorch's caching host allocator without
growing its pool, in %.

Counters: BatchStats.fetch_pinned_hits over BatchStats.fetch_chunks (the
device chunks fetched to the host, runtime/batch._fetch), summed over the
window's calls.  Nothing to read where the program keeps no such count or
the window fetched no chunk."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "fetch_pinned_hits" in s]
    chunks = sum(s["fetch_chunks"] for s in stats)
    if chunks == 0:
        return None
    return 100.0 * sum(s["fetch_pinned_hits"] for s in stats) / chunks
