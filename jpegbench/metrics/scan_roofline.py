"""scan_roofline: the device entropy kernels' share of their memory
roofline, in %.

Kernels: `fsm_scan_kernel` (csrc/fsm_scan.cu) and `scatter_kernel`
(csrc/place.cuh, the body of place_events in csrc/materialize.cu), their
summed device time over the traced window.  Need: what the decode of the
window's pictures asks of them, whatever a kernel moves: each picture's
entropy-coded bytes read once, and its coefficients as int16 (blocks x
64 x 2 bytes) written once.  Least time = need / the card's HBM
bandwidth (peaks.json); share = least time / kernel time.  Nothing to
read where these kernels did not run."""

KERNELS = ("fsm_scan_kernel", "scatter_kernel")


def read(ctx):
    tr = ctx.window.trace
    peak = ctx.peaks["cards"].get(ctx.device_kind)
    if tr is None or peak is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    need = sum(ctx.streams[i].scan_bytes + ctx.streams[i].n_blocks * 128
               for call in ctx.window.calls for i in call)
    return 100.0 * need / peak["hbm_bytes_per_s"] / seconds
