"""device_wait_share: the share of a decode call's wall time in the
retry ladder, its fences and the device synchronisation
(runtime/batch._finish): the wait for the device chains, in %.

The program's own host-clock waits of each decode call of the window
(BatchStats): the sum of `device_s` over the sum of `total_s`."""


def read(ctx):
    stats = ctx.window.stats
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    return 100.0 * (sum(s["device_s"] for s in stats)) / total
