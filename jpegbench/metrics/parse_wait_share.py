"""parse_wait_share: the share of a decode call's wall time that the
caller waits on the parse futures (io/parser.py, io/destuff.py on
BatchDecoder's pool), in %.

The program's own host-clock waits of each decode call of the window
(BatchStats): the sum of `parse_s` over the sum of `total_s`."""


def read(ctx):
    stats = ctx.window.stats
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * (sum(s["parse_s"] for s in stats)) / total
