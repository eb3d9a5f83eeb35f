"""dispatch_share: the share of a decode call's wall time spent
dispatching chunks: plan building and uploads (runtime/batch._Window,
_Upload), host entropy decode on the host routes (runtime/host.py, the
native library) and kernel launches, in %.

The program's own host-clock waits of each decode call of the window
(BatchStats): the sum of `entropy_s` over the sum of `total_s`."""


def read(ctx):
    stats = ctx.window.stats
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * (sum(s["entropy_s"] for s in stats)) / total
