"""lane_pack_share: the share of the window's chunks whose lane matrix
the program packed on the card from the chunk's scan bytes, in %.

Counter: BatchStats.lane_pack_chunks (the chunks whose lane matrix
runtime/batch._Upload.adopt packed on their device, csrc/pack.cu on a
card) over all chunks of the window's calls.  Nothing to read where the
program keeps no such count or the window decoded no chunk."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "lane_pack_chunks" in s]
    chunks = sum(s["chunks"] for s in stats)
    if chunks == 0:
        return None
    return 100.0 * sum(s["lane_pack_chunks"] for s in stats) / chunks
