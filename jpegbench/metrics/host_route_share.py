"""host_route_share: the share of the window's chunks that the program
decoded on a host route (host Huffman, then coefficients up), in %.

Counter: the chunks by the route that returned them
(BatchStats.route_chunks; "host", "host-bucketed", "oracle",
"oracle-bucketed", "cpu", after any fallback) over all chunks of the
window's calls.  Nothing to read where the program keeps no such count
or the window decoded no chunk."""

HOST_ROUTES = ("host", "host-bucketed", "oracle", "oracle-bucketed", "cpu")


def read(ctx):
    stats = [s for s in ctx.window.stats if "route_chunks" in s]
    chunks = sum(s["chunks"] for s in stats)
    if chunks == 0:
        return None
    host = sum(n for s in stats for r, n in s["route_chunks"].items()
               if r in HOST_ROUTES)
    return 100.0 * host / chunks
