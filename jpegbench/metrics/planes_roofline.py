"""planes_roofline: the planes kernel's share of its memory roofline, in %.

Kernels: `planes_idct_kernel` and `planes_colour_kernel` (csrc/planes.cu,
the pixel stage of every subsampled picture), their summed device time
over the traced window.  Need: each picture's own blocks' coefficients
as int16 (blocks x 64 x 2 bytes) read once and its RGB at its true size
(height x width x 3 bytes) written once; a bucket raster's padding is no
part of it.  Least time = need / the card's HBM bandwidth (peaks.json);
share = least time / kernel time.  Nothing to read where the kernel did
not run (4:4:4 takes the pixels kernel)."""

KERNELS = ("planes_idct_kernel", "planes_colour_kernel")


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
