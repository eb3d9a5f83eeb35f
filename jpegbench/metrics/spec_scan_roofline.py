"""spec_scan_roofline: the speculative route's entropy kernels' share of
their memory roofline, in %.

Kernels: `fsm_scan_kernel` (csrc/fsm_scan.cu: the cold, stitch and
Jacobi scans), the slot materialize (`compact_kernel`,
`slot_unpack_kernel`, `slot_expand_kernel`; csrc/slots.cu, compact.cuh)
and `scatter_kernel` (csrc/place.cuh: the classic materialize after a
slot overflow), their summed device time over the traced window.  The
gather into per-image rows (ops/fsm._spec_gather16: ATen copies and
`index_select`) has no kernel of its own name and is left out; the
breakdown's device ops show it.  Need: scan_roofline's, so that the two
routes compare: each picture's entropy-coded bytes read once, and its
coefficients as int16 (blocks x 64 x 2 bytes) written once.  Least
time = need / the card's HBM bandwidth (peaks.json); share = least time
/ kernel time.  Nothing to read where these kernels did not run, or
where the window held no speculative chunk (no `spec_scan` span)."""

KERNELS = ("fsm_scan_kernel", "compact_kernel", "slot_unpack_kernel",
           "slot_expand_kernel", "scatter_kernel")


def read(ctx):
    tr = ctx.window.trace
    peak = ctx.peaks["cards"].get(ctx.device_kind)
    if tr is None or peak is None:
        return None
    if not any("spec_scan" in s.get("span_s", {}) for s in ctx.window.stats):
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    need = sum(ctx.streams[i].scan_bytes + ctx.streams[i].n_blocks * 128
               for call in ctx.window.calls for i in call)
    return 100.0 * need / peak["hbm_bytes_per_s"] / seconds
