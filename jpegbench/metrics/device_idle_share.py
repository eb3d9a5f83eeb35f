"""device_idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card, in %.

1 - the union of the device's kernel, copy and memset intervals inside
the window span / the window's length (devtrace.Trace)."""


def read(ctx):
    tr = ctx.window.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
