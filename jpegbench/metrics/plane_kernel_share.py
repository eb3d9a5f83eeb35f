"""plane_kernel_share: the share of the window's chunks whose pixel stage
launched the planes kernel (csrc/planes.cu, the subsampled pixel stage
on the card), in %.

Counter: BatchStats.plane_kernel_chunks (the chunks whose dispatch
launched it) over all chunks of the window's calls.  Nothing to read
where the program keeps no such count or the window decoded no chunk."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "plane_kernel_chunks" in s]
    chunks = sum(s["chunks"] for s in stats)
    if chunks == 0:
        return None
    return 100.0 * sum(s["plane_kernel_chunks"] for s in stats) / chunks
