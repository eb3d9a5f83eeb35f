"""bucket_pad_share: the share of the bucket rasters' blocks that are
padding, in %, over the chunks the program decoded on the bucket chain.

Counters: BatchStats.bucket_blocks (each chunk's images times its bucket
raster's blocks) and bucket_real_blocks (the images' own blocks), summed
over the window's calls; share = 100 x (1 - real / raster).  The scan,
the scatter and the planes kernel work over the whole raster, so this is
the part of their work that no picture asks for.  Nothing to read where
the program keeps no such count or no chunk took the bucket chain."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "bucket_blocks" in s]
    raster = sum(s["bucket_blocks"] for s in stats)
    if raster == 0:
        return None
    return 100.0 * (1.0 - sum(s["bucket_real_blocks"] for s in stats)
                    / raster)
