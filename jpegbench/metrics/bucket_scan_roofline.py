"""bucket_scan_roofline: the device entropy kernels' share of their memory
roofline where they decode bucket rasters, in %.

scan_roofline's reader, read in the cells whose chunks take the
fsm-bucketed chain: `fsm_scan_kernel` (its `kPad` variant there) and
`scatter_kernel`, against each picture's scan bytes read once and its
own blocks' int16 coefficients written once.  The raster's padding is
no part of that need, so the time the kernels spend on it counts as
lost share.  Nothing to read where these kernels did not run."""

from jpegbench.metrics.scan_roofline import read  # noqa: F401
