"""pixels_roofline: the pixel kernel's share of its memory roofline, in %.

Kernel: `pixels_kernel` (csrc/pixels.cu), its summed device time over
the traced window.  Need: each picture's coefficients as int16 (blocks x
64 x 2 bytes) read once and its RGB at its true size (height x width x 3
bytes) written once.  Least time = need / the card's HBM bandwidth
(peaks.json); share = least time / kernel time.  Nothing to read where
the kernel did not run (every sampling but 4:4:4 takes the plane path)."""

KERNELS = ("pixels_kernel",)


def read(ctx):
    tr = ctx.window.trace
    peak = ctx.peaks["cards"].get(ctx.device_kind)
    if tr is None or peak is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    need = sum(ctx.streams[i].n_blocks * 128
               + ctx.streams[i].width * ctx.streams[i].height * 3
               for call in ctx.window.calls for i in call)
    return 100.0 * need / peak["hbm_bytes_per_s"] / seconds
