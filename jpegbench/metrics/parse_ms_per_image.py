"""parse_ms_per_image: the parse pool's busy time a picture, in ms.

The program's `parse` spans (io/parser.py on BatchDecoder's pool, one a
stream), summed over the threads and the window's calls
(BatchStats.span_s), over the pictures the calls decoded: the work
behind `parse_wait_share`'s wait.  Nothing to read where the program
records no spans."""


def read(ctx):
    stats = [s for s in ctx.window.stats if "span_s" in s]
    images = sum(s["n_images"] for s in stats)
    if images == 0:
        return None
    return 1e3 * sum(s["span_s"].get("parse", 0.0) for s in stats) / images
