"""bucket_chunk_images: the images of a chunk on the bucket chain, on
average over the window.

Counters: BatchStats.bucket_images over bucket_chunks (the chunks the
program launched on the fsm-bucketed chain), summed over the window's
calls.  Each such chunk pays the chain's fixed cost (plan, stage, lane
pack, scan, scatter, assembly, planes launch, fetch block) once, so
fewer images a chunk is more of that cost an image.  Nothing to read
where the program keeps no such count or no chunk took the bucket
chain."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "bucket_chunks" in s]
    chunks = sum(s["bucket_chunks"] for s in stats)
    if chunks == 0:
        return None
    return sum(s["bucket_images"] for s in stats) / chunks
