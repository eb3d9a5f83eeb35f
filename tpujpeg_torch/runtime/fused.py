"""Per-chunk decode: FSM scan -> materialize -> DC resolve -> pixels, on
one device.

Counterparts of tpujpeg/runtime/fused.py: compiled_fused_decoder for a
single-group restart plan (`decode_chunk_fused`, with its profiling cuts
`stop_after`), compiled_superchunk_decoder for several such plans behind
one wide scan (`decode_superchunk`, `pack_superchunk`),
compiled_fused_bucketed for a size-class bucket chunk of mixed exact
geometries (`decode_chunk_bucketed`) and the sync-spec tail
(`decode_spec_sync_fused`).  PyTorch runs eagerly, so each chain is a
plain function; the kernels launch on the current stream back to back
and nothing returns to the host until the caller reads a result (the
spec tail's one resolve read aside).

  * the dense coefficient tensor stays int16 from materialize to the
    pixels; for 4:4:4 the pixel kernel (ops/pixels.rgb_444) reads the
    lane matrix in place through a lane table (`restart_lanes`,
    `bucket_lanes`) and writes the cropped raster, so nothing is
    assembled;
  * DC stays as DPCM differences in the dense tensor; the resolved
    predictors ride a separate [L, max_blk] cumsum and replace the DC row
    inside the pixel stage;
  * per-image coefficients are assembled only for callers that ask for
    them (want_coeffs=True) and for the plane path of the other
    samplings.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import fsm
from ..ops.pixels import LaneTable, lane_table, rgb_444
from ..pipeline import Geometry, device_decode_fn
from ..utils.profiling import span


@functools.lru_cache(maxsize=64)
def restart_lanes(layout, L: int, pad_to: int, mcus_y: int, mcus_x: int,
                  device) -> LaneTable:
    """The pixel kernel's runs of a 4:4:4 restart plan: lane l of the
    matrix is entry l (a restart segment of whole MCUs of three blocks,
    or unused), then one zero-coefficient entry per MCU row of each
    padding image."""
    rows = np.zeros((L, 4), np.int32)
    rows[:, 0] = rows[:, 3] = -1
    for b, (first, n_lanes, rib, last) in enumerate(layout):
        lanes = first + np.arange(n_lanes)
        rows[lanes, 0] = b
        rows[lanes, 1] = np.arange(n_lanes) * (rib // 3)
        rows[lanes, 2] = rib // 3
        rows[lanes[-1], 2] = last // 3
        rows[lanes, 3] = lanes
    b, my = np.divmod(np.arange((pad_to - len(layout)) * mcus_y), mcus_y)
    pad = np.stack([b + len(layout), my * mcus_x, np.full_like(b, mcus_x),
                    np.full_like(b, -1)], axis=1)
    return lane_table(np.concatenate([rows, pad]), device)


@functools.lru_cache(maxsize=64)
def bucket_lanes(L: int, pad_to: int, lanes_per_img: int, k: int,
                 mcus_y: int, mcus_x: int, device) -> LaneTable:
    """The pixel kernel's runs of a bucket-raster plan: lane l holds k
    padded MCU rows of image l // lanes_per_img; lanes past the matrix
    (pad_to images ask for more) are zero runs."""
    lane = np.arange(pad_to * lanes_per_img)
    row0 = (lane % lanes_per_img) * k
    n_rows = np.clip(mcus_y - row0, 0, k)
    rows = np.stack([np.where(n_rows > 0, lane // lanes_per_img, -1),
                     row0 * mcus_x, n_rows * mcus_x,
                     np.where(lane < L, lane, -1)], axis=1)
    return lane_table(rows, device)


def assembly_index(layout, max_blk: int, device) -> torch.Tensor:
    """Flat (lane * max_blk + blk) source of every block of every image,
    in image order: int64 [n_imgs * n_blocks_img], built on `device`.

    Every image of a chunk has the same block count; block j of an image
    with layout (first, n_lanes, rib, last) sits in lane first + j // rib
    while j < (n_lanes - 1) * rib, and in its last lane after that."""
    _, n0, rib0, last0 = layout[0]
    nb = (n0 - 1) * rib0 + last0
    lay = torch.as_tensor(layout, dtype=torch.int64, device=device)
    first, n_lanes, rib, last = (c[:, None] for c in lay.unbind(1))
    n_full = (n_lanes - 1) * rib
    j = torch.arange(nb, dtype=torch.int64, device=device)[None, :]
    in_full = j < n_full
    lane = torch.where(in_full, first + j // rib, first + n_lanes - 1)
    blk = torch.where(in_full, j % rib, j - n_full)
    return (lane * max_blk + blk).reshape(-1)


def _assemble_rows(per_lane: torch.Tensor, layout, pad_to: int) -> torch.Tensor:
    """[L, max_blk, ...] lane rows -> [pad_to, n_blocks_img, ...].

    The slicing of the JAX package's _assemble_rows as one gather; images
    past len(layout) are zero padding."""
    L, max_blk = per_lane.shape[:2]
    tail = per_lane.shape[2:]
    idx = assembly_index(layout, max_blk, per_lane.device)
    rows = per_lane.reshape((L * max_blk,) + tail).index_select(0, idx)
    n_imgs = len(layout)
    rows = rows.reshape((n_imgs, -1) + tail)
    if pad_to > n_imgs:
        pad = torch.zeros((pad_to - n_imgs,) + rows.shape[1:],
                          dtype=rows.dtype, device=rows.device)
        rows = torch.cat([rows, pad])
    return rows


def _pixel_tail(geom: Geometry, coeffs_t: torch.Tensor, dc_lane: torch.Tensor,
                lanes, assemble, quant: torch.Tensor, want_coeffs: bool,
                fancy: bool, exact: bool, extents=None):
    """The chains' pixel stage: 4:4:4 reads the lane matrix in place
    through the runs of `lanes()`; other geometries take
    `device_decode_fn` on the assembled [B, n_blocks, 64] coefficients.
    `assemble()` -> (coeffs, dc) runs only where it is needed.

    Returns (rgb, risk, coeffs, dc); coeffs and dc are None when
    want_coeffs is False."""
    coeffs = dc = None
    if want_coeffs or not geom.is_444:
        coeffs, dc = assemble()
    if geom.is_444:
        rgb, risk = rgb_444(geom, coeffs_t, lanes(), quant, dc=dc_lane,
                            extents=extents, exact=exact)
    else:
        rgb, risk = device_decode_fn(geom, coeffs, quant, fancy=fancy, dc=dc,
                                     extents=extents, exact=exact)
    if not want_coeffs:
        coeffs = dc = None
    return rgb, risk, coeffs, dc


STOPS = ("scan", "materialize", "assemble")


def _sum32(*tensors) -> torch.Tensor:
    """The JAX checksums' int32 sum (wraparound) of all elements: summed
    in int64 on the device, then wrapped to int32."""
    total = sum(torch.sum(t, dtype=torch.int64) for t in tensors)
    total = total & 0xFFFFFFFF
    return torch.where(total >= 1 << 31, total - (1 << 32),
                       total).to(torch.int32)


def _restart_tail(plan: fsm.FsmPlan, ev: torch.Tensor, err_mal: torch.Tensor,
                  quant: torch.Tensor, geom: Geometry, pad_to: int,
                  want_coeffs: bool, slots, fancy: bool,
                  exact: bool, stop_after: str | None = None):
    """A restart plan's chain after its scan: materialize its events [N,
    L] -> DC resolve -> pixels.  Returns (rgb, risk, coeffs, dc, err_mal,
    err_slot), or (checksum, err_mal, err_slot) at stop_after
    "materialize" / "assemble"."""
    L = ev.shape[1]
    M = plan.max_blk * 64
    coeffs_t, err_mal, err_slot = fsm.materialize_checked(
        ev, M, err_mal, slots=slots)
    if stop_after == "materialize":
        return _sum32(coeffs_t), err_mal, err_slot
    per_lane = coeffs_t.T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)

    def assemble():
        return (_assemble_rows(per_lane, plan.layout, pad_to),  # [B, nb, 64]
                _assemble_rows(dc_lane, plan.layout, pad_to))   # [B, nb]

    if stop_after == "assemble":
        return _sum32(*assemble()), err_mal, err_slot
    rgb, risk, coeffs, dc = _pixel_tail(
        geom, coeffs_t, dc_lane,
        lambda: restart_lanes(plan.layout, L, pad_to, geom.mcus_y,
                              geom.mcus_x, quant.device),
        assemble, quant, want_coeffs, fancy, exact)
    return rgb, risk, coeffs, dc, err_mal, err_slot


def decode_chunk_fused(plan: fsm.FsmPlan, quant: torch.Tensor, geom: Geometry,
                       pad_to: int, steps=fsm.STEPS_PRODUCTION,
                       want_coeffs: bool = True, uploaded=None,
                       slots: bool | int | None = False, fancy: bool = False,
                       exact: bool = False, stop_after: str | None = None):
    """Decode one restart plan on the device of `quant`.

    quant: int32 [pad_to, n_comp, 64] zigzag quant tables.  `uploaded` is
    the plan's (xs, seg_n_blocks) already on that device.  slots: the
    materialize route (fsm.materialize_checked): False, the default, is
    the classic scatter; a caller that asks for slots reads err_slot.
    fancy: triangle chroma upsampling for subsampled geometries, exact:
    the reference's exact colour (pipeline.device_decode_fn).

    Returns (rgb uint8 [pad_to, 3, H, W], riskbits uint8 [pad_to, H, W/8]
    or None when exact, coeffs int16 [pad_to, n_blocks, 64] with raw DC
    differences, dc int32 [pad_to, n_blocks] resolved, err_mal [L],
    err_env [L], err_slot [L]); coeffs and dc are None when want_coeffs
    is False.

    stop_after ("scan", "materialize" or "assemble"; a profiling cut, the
    JAX program's): the chain stops after that stage and returns a
    checksum that consumes the stage's whole output, the JAX program's
    int32 sum with wraparound: (sum of the events, err_mal, err_env)
    after the scan, (sum of the dense int16 tensor, err_mal, err_env,
    err_slot) after materialize, (sum of the assembled [pad_to, nb, 64]
    coefficients plus the assembled DC, err_mal, err_env, err_slot) after
    assemble.  On 4:4:4 the full chain reads the lane matrix in place, so
    its cut at "assemble" runs an assembly the full chain does not.
    """
    if stop_after is not None and stop_after not in STOPS:
        raise ValueError(f"stop_after={stop_after!r}")
    dev = quant.device
    if uploaded is None:
        uploaded = (plan.xs_lanes.to(dev),
                    torch.as_tensor(plan.seg_n_blocks).to(dev))
    xs, seg_n = uploaded
    events, err_mal, err_env = fsm.fsm_scan(xs, seg_n, plan.tables, steps)
    n_cols, S, L = events.shape
    ev = events.reshape(n_cols * S, L)
    if stop_after == "scan":
        return _sum32(ev), err_mal, err_env
    out = _restart_tail(plan, ev, err_mal, quant, geom, pad_to, want_coeffs,
                        slots, fancy, exact, stop_after)
    if stop_after is not None:
        chk, err_mal, err_slot = out
        return chk, err_mal, err_env, err_slot
    rgb, risk, coeffs, dc, err_mal, err_slot = out
    return rgb, risk, coeffs, dc, err_mal, err_env, err_slot


def superchunk_lanes(plans: list):
    """N single-group plans as one wide lane matrix, described: every
    sub-plan's rows in order, zero-padded to the largest stride (the zero
    columns are inert: a lane is done before them and never refills).
    Returns (fsm.ScanLanes of [Lw, stride], seg_n int32 [Lw], sub_lanes
    tuple)."""
    lanes = [p.xs_lanes for p in plans]
    return (fsm.ScanLanes.stack(lanes),
            np.concatenate([p.seg_n_blocks for p in plans]),
            tuple(sl.shape[0] for sl in lanes))


def pack_superchunk(plans: list):
    """superchunk_lanes' matrix packed on the host: (xs uint8 [Lw,
    stride], seg_n int32 [Lw], sub_lanes tuple)."""
    lanes, seg_n, sub_lanes = superchunk_lanes(plans)
    return lanes.host(), seg_n, sub_lanes


def decode_superchunk(plans: list, quants: torch.Tensor, geom: Geometry,
                      pad_to: int, fancy: bool = False,
                      steps=fsm.STEPS_PRODUCTION, uploaded=None,
                      want_coeffs: bool = True,
                      slots: bool | int | None = False, exact: bool = False):
    """N single-group restart plans of one geometry and table set, ONE
    scan: the wide-scan chain (the JAX package's
    compiled_superchunk_decoder).

    One `fsm_scan` launch walks every sub-plan's lanes (`pack_superchunk`);
    then each sub-chunk runs decode_chunk_fused's materialize -> DC
    resolve -> pixels on its own lane columns (copied out of the wide
    event matrix: the materialize kernels read a contiguous [N, L]).
    quants: int32 [n_sub, pad_to, n_comp, 64] on the device; `uploaded`
    is pack_superchunk's (xs, seg_n) already there; slots, fancy and exact
    as in decode_chunk_fused.

    Returns the sub-chunks' (rgb, risk, coeffs, dc) concatenated along the
    image axis (n_sub * pad_to images), err_mal [Lw], err_env [Lw],
    err_slot [Lw]; risk is None when exact, coeffs and dc when want_coeffs
    is False."""
    for p in plans:
        if len(p.lanes) != 1:
            raise ValueError("superchunk requires single-group plans")
        if p.tables != plans[0].tables:
            raise ValueError("superchunk requires one table set")
    dev = quants.device
    lanes, sn, sub_lanes = superchunk_lanes(plans)
    if uploaded is None:
        uploaded = (lanes.to(dev), torch.as_tensor(sn).to(dev))
    xs, seg_n = uploaded
    events, err_mal, err_env = fsm.fsm_scan(xs, seg_n, plans[0].tables,
                                            steps)
    n_cols, S, Lw = events.shape
    ev = events.reshape(n_cols * S, Lw)
    outs = []
    base = 0
    for plan, Ls, quant in zip(plans, sub_lanes, quants):
        outs.append(_restart_tail(
            plan, ev[:, base : base + Ls].contiguous(),
            err_mal[base : base + Ls], quant, geom, pad_to, want_coeffs,
            slots, fancy, exact))
        base += Ls

    def cat(i):
        parts = [o[i] for o in outs]
        return None if parts[0] is None else torch.cat(parts)

    return (cat(0), cat(1), cat(2), cat(3), cat(4), err_env, cat(5))


def _pad_lanes(x: torch.Tensor, need: int) -> torch.Tensor:
    """Zero lanes appended to [L, ...] up to `need` lanes."""
    if need <= x.shape[0]:
        return x
    pad = torch.zeros((need - x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def bucket_extents(plan: fsm.FsmBucketPlan, pad_to: int) -> np.ndarray:
    """int32 [pad_to, 2]: each image's true (mcus_y, mcus_x), zero rows
    for the padding images."""
    ext = np.zeros((pad_to, 2), np.int32)
    ext[: plan.n_imgs] = plan.extents
    return ext


def decode_chunk_bucketed(plan: fsm.FsmBucketPlan, quant: torch.Tensor,
                          bucket: Geometry, pad_to: int,
                          steps=fsm.STEPS_PRODUCTION,
                          want_coeffs: bool = True, uploaded=None,
                          slots: bool | int | None = False,
                          fancy: bool = False, exact: bool = False,
                          extents=None):
    """Decode one size-class bucket chunk of mixed exact geometries on the
    device of `quant`: scan bytes -> bucket-raster rgb, risk and errors.

    Per-image variation (true MCU extents, real lane quotas, raster
    padding) rides as vectors: quotas/wrap_at/skip drive the scan's
    bucket-raster emission (fsm.fsm_scan pad_info), so the per-lane rows
    land in the bucket's padded layout and assembly is a static reshape.
    `_dc_cumsum` carries each lane's predictor through the padding slots,
    so DC is zeroed outside each image's true extent: inside the pixel
    kernel for 4:4:4 (which reads the lane matrix in place), on the
    assembled DC otherwise.  The same extents [pad_to, 2] of true
    (mcus_y, mcus_x) go to the plane path, where the fancy upsampler
    replicates at each image's real edge.

    quant: int32 [pad_to, n_comp, 64]; `uploaded` is the plan's (xs,
    seg_n, wrap_at, skip) and `extents` its `bucket_extents` already on
    that device; slots, fancy and exact as in `decode_chunk_fused`.

    Returns (rgb uint8 [pad_to, 3, Hb, Wb], riskbits uint8 [pad_to, Hb,
    Wb/8] or None when exact, coeffs int16 [pad_to, nb_b, 64] with raw DC
    differences, dc int32 [pad_to, nb_b] resolved and masked, err_mal
    [L], err_env [L], err_slot [L]) at the bucket's size; callers crop
    each image.  coeffs and dc are None when want_coeffs is False.
    """
    dev = quant.device
    if uploaded is None:
        uploaded = (plan.lanes.to(dev), *(
            torch.as_tensor(a).to(dev)
            for a in (plan.seg_n, plan.wrap_at, plan.skip)))
    xs, seg_n, wrap_at, skip = uploaded
    bpm = bucket.blocks_per_mcu
    wb_bpm = bucket.mcus_x * bpm
    max_blk, k, lanes_per_img = plan.max_blk, plan.k, plan.lanes_per_img
    if max_blk != k * wb_bpm:
        raise ValueError("decode_chunk_bucketed: plan and bucket disagree")
    nb_b = bucket.n_blocks
    need = pad_to * lanes_per_img

    events, err_mal, err_env = fsm.fsm_scan(xs, seg_n, plan.tables, steps,
                                            pad_info=(wrap_at, skip))
    n_cols, S, L = events.shape
    ev = events.reshape(n_cols * S, L)
    coeffs_t, err_mal, err_slot = fsm.materialize_checked(
        ev, max_blk * 64, err_mal, slots=slots)
    per_lane = coeffs_t.T.reshape(L, max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, max_blk)
    ext = extents if extents is not None \
        else torch.as_tensor(bucket_extents(plan, pad_to)).to(dev)

    def assemble():
        # static bucket-raster assembly: lane rows are padded MCU rows
        rows = lanes_per_img * k
        coeffs = _pad_lanes(per_lane, need)[:need] \
            .reshape(pad_to, rows, wb_bpm, 64)[:, : bucket.mcus_y] \
            .reshape(pad_to, nb_b, 64)
        dc = _pad_lanes(dc_lane, need)[:need] \
            .reshape(pad_to, rows, wb_bpm)[:, : bucket.mcus_y] \
            .reshape(pad_to, nb_b)
        # zero DC outside each image's true extent, so the pixel stage and
        # any fetched coefficients see clean padding
        mcu = torch.arange(nb_b, dtype=torch.int32, device=dev) // bpm
        row = (mcu // bucket.mcus_x)[None, :]
        col = (mcu % bucket.mcus_x)[None, :]
        real = (row < ext[:, 0:1]) & (col < ext[:, 1:2])
        return coeffs, torch.where(real, dc, 0)

    rgb, risk, coeffs, dc = _pixel_tail(
        bucket, coeffs_t, dc_lane,
        lambda: bucket_lanes(L, pad_to, lanes_per_img, k, bucket.mcus_y,
                             bucket.mcus_x, dev),
        assemble, quant, want_coeffs, fancy, exact, extents=ext)
    return rgb, risk, coeffs, dc, err_mal, err_env, err_slot


def decode_spec_sync_fused(pending: fsm.SpecSyncPending, geom: Geometry,
                           quant: torch.Tensor, pad_to: int, n_imgs: int,
                           want_coeffs: bool = True,
                           slots: bool | int | None = False,
                           fancy: bool = False, exact: bool = False,
                           stop_after: str | None = None):
    """Finish a spec_sync_start chunk: the host resolve (one read; span
    `spec_resolve`), then merge -> materialize -> gather -> DC resolve ->
    pixels on the device.

    Raises SpecEnvelopeError / SpecSyncMiss from the resolve; fancy and
    exact as in `decode_chunk_fused`.  Returns (rgb, risk, coeffs int16
    [pad_to, nb, 64] raw DC, dc int32 [pad_to, nb], err [L], err_slot
    [L]); coeffs and dc are None when want_coeffs is False.

    stop_after (a profiling cut, as in `decode_chunk_fused`): returns
    (checksum, err, err_slot), the checksum `_sum32` of the stage's whole
    output: after "scan" every tensor of `pending` (the cold and stitch
    scans and the resolve's device part; no read yet, err and err_slot
    None), after "materialize" the merged events' dense int16 tensor,
    after "assemble" the gathered coefficients plus the resolved DC."""
    if stop_after is not None and stop_after not in STOPS:
        raise ValueError(f"stop_after={stop_after!r}")
    if stop_after == "scan":
        return _sum32(pending.ev1, pending.anchors, pending.ablk,
                      pending.recm, pending.ev2, pending.end2, pending.b1,
                      pending.blk2, pending.packed), None, None
    plan = pending.plan
    with span("spec_resolve"):
        quotas, cap_w = fsm.spec_sync_resolve_host(pending)
    coeffs, dc, err, err_slot = fsm._spec_sync_assemble(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        torch.as_tensor(quotas).to(quant.device), plan.tables, pad_to,
        int(plan.img_blocks[0]), n_imgs, cap_w, slots=slots,
        stop_after=stop_after,
    )
    if stop_after is not None:
        return _sum32(*(t for t in (coeffs, dc) if t is not None)), err, \
            err_slot
    rgb, risk = device_decode_fn(geom, coeffs, quant, fancy=fancy, dc=dc,
                                 exact=exact)
    if not want_coeffs:
        coeffs = dc = None
    return rgb, risk, coeffs, dc, err, err_slot
