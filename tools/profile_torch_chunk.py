"""Where one 128-image chunk's device time goes in tpujpeg_torch (CUDA).

Three chunks, each 16 committed q90 4:4:4 streams x 8, with the plan and
scan bytes already on the card:

  * restart: tests/fixtures/rst640 (a restart marker every MCU row)
    through the fused chain (runtime/fused.decode_chunk_fused): scan,
    materialize, lane transpose + DC cumsum, the pixel kernel on the lane
    matrix (exact colour, the engine's strict default, and f32 + flags);
  * spec: tests/fixtures/photo640 (no restart markers) through the
    single-pass speculative chain: cold + stitch scan, the resolve read,
    merge, compact, unpack, expand (the slot route; the classic scatter
    beside it), lane transpose + gather + DC cumsum, pixels (the kernel
    on [B, n_blocks, 64]);
  * bucketed: tests/fixtures/mixed_rst (16 sizes of 624-800 px, a
    restart marker every MCU row) through the size-bucketed chain
    (runtime/fused.decode_chunk_bucketed): pad_info scan, materialize
    (the scatter; beside it the two other placements as stages: ranked =
    cumsum init, compact_offsets, spread_full; full = compact_full,
    spread_full), lane transpose + DC cumsum, the pixel kernel on the
    lane matrix at the bucket's size (DC masked inside it).

Per stage, the median of 5 warm runs timed with CUDA events, each stage
synchronised on its own; then each whole chain as the strict engine
runs it (exact colour, no coefficients assembled), unsynchronised, the
same way; then torch.profiler's CUDA-time table over 3 runs of each
chain (also written to OUT_FILE when one is given).

Needs a CUDA card.  Run from the repo root:
    python tools/profile_torch_chunk.py [OUT_FILE]
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CHUNK = 128


def _ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _corpus(name):
    from tpujpeg_torch.io.parser import parse_file

    folder = os.path.join(ROOT, "tests", "fixtures", name)
    names = sorted(os.listdir(folder))
    return [parse_file(os.path.join(folder, n)) for n in names] \
        * (CHUNK // 16)


def _quant(imgs, dev):
    import numpy as np
    import torch

    return torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)).to(dev)


def restart_stages(dev):
    """(stages, chain, shapes) of the restart chunk."""
    import torch

    from tpujpeg_torch.ops import fsm, pixels
    from tpujpeg_torch.pipeline import Geometry
    from tpujpeg_torch.runtime import fused

    imgs = _corpus("rst640")
    plan = fsm.build_plan(imgs, split=False)
    xs = torch.as_tensor(plan.xs).to(dev)
    sn = torch.as_tensor(plan.seg_n_blocks).to(dev)
    quant = _quant(imgs, dev)
    geom = Geometry.of(imgs[0])
    L = xs.shape[0]
    M = plan.max_blk * 64

    st = {}
    st["scan"] = fsm.fsm_scan(xs, sn, plan.tables)
    ev = st["scan"][0].reshape(-1, L)
    st["mat"] = fsm.materialize_checked(ev, M, st["scan"][1])[0]
    per_lane = st["mat"].T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
    lanes = fused.restart_lanes(plan.layout, L, CHUNK, geom.mcus_y,
                                geom.mcus_x, dev)

    def transpose_dc():
        pl = st["mat"].T.reshape(L, plan.max_blk, 64)
        fsm._dc_cumsum(pl[:, :, 0], plan.tables, plan.max_blk)

    stages = [
        ("scan (fsm_scan)", lambda: fsm.fsm_scan(xs, sn, plan.tables)),
        ("materialize (place_events)",
         lambda: fsm.materialize_checked(ev, M, st["scan"][1])),
        ("materialize, slot route C=256",
         lambda: fsm.materialize_checked(ev, M, st["scan"][1], slots=256)),
        ("lane transpose + DC cumsum", transpose_dc),
        ("pixel kernel on the lane matrix, exact (pixels)",
         lambda: pixels.rgb_444(geom, st["mat"], lanes, quant, dc=dc_lane,
                                exact=True)),
        ("pixel kernel on the lane matrix, f32 + flags (pixels)",
         lambda: pixels.rgb_444(geom, st["mat"], lanes, quant, dc=dc_lane)),
    ]

    def chain():
        return fused.decode_chunk_fused(plan, quant, geom, CHUNK,
                                        uploaded=(xs, sn), want_coeffs=False,
                                        exact=True)

    shapes = (f"lane matrix {list(xs.shape)}, events {list(ev.shape)}, "
              f"dense [{M}, {L}]")
    return stages, chain, shapes


def spec_stages(dev):
    """(stages, chain, shapes) of the speculative chunk."""
    import torch

    from tpujpeg_torch.ops import fsm, materialize
    from tpujpeg_torch.pipeline import Geometry, device_decode_fn
    from tpujpeg_torch.runtime import fused

    imgs = _corpus("photo640")
    plan = fsm.build_spec_plan_batch(imgs, 1024)
    xs = torch.as_tensor(plan.xs).to(dev)
    quant = _quant(imgs, dev)
    geom = Geometry.of(imgs[0])
    L = xs.shape[0]
    nb = int(plan.img_blocks[0])
    C, G = materialize.SLOT_C, materialize.SLOT_G

    pending = fsm.spec_sync_start(imgs, plan=plan, xs_dev=xs)
    quotas, cap_w = fsm.spec_sync_resolve_host(pending)
    qd = torch.as_tensor(quotas).to(dev)
    M = cap_w * 64
    merge_args = (pending.ev1, pending.anchors, pending.ablk, pending.recm,
                  pending.ev2, pending.end2, pending.b1, pending.blk2, qd)
    ev, _ = fsm._spec_sync_merge(*merge_args)
    p, o = materialize.compact_to_rank(ev)
    o2, _ = materialize.slot_unpack(p, o, C, G)
    dense = materialize.slot_expand(o2, p, M, C, G)
    coeffs, dc = fsm._spec_gather16(dense.T.reshape(L, cap_w, 64), qd,
                                    plan.tables, CHUNK, nb, CHUNK)

    stages = [
        ("cold + stitch scan (fsm_scan x2, spec_sync_start)",
         lambda: fsm.spec_sync_start(imgs, plan=plan, xs_dev=xs)),
        ("resolve read (spec_sync_resolve_host)",
         lambda: fsm.spec_sync_resolve_host(pending)),
        ("merge (_spec_sync_merge)", lambda: fsm._spec_sync_merge(*merge_args)),
        ("compact", lambda: materialize.compact_to_rank(ev)),
        ("slot_unpack", lambda: materialize.slot_unpack(p, o, C, G)),
        ("slot_expand", lambda: materialize.slot_expand(o2, p, M, C, G)),
        ("classic scatter instead (place_events)",
         lambda: materialize.place_events(ev, M)),
        ("lane transpose + gather + DC cumsum (_spec_gather16)",
         lambda: fsm._spec_gather16(dense.T.reshape(L, cap_w, 64), qd,
                                    plan.tables, CHUNK, nb, CHUNK)),
        ("pixels, exact (device_decode_fn: the kernel on [B, n_blocks, 64])",
         lambda: device_decode_fn(geom, coeffs, quant, dc=dc, exact=True)),
    ]

    def chain():
        pend = fsm.spec_sync_start(imgs, plan=plan, xs_dev=xs)
        return fused.decode_spec_sync_fused(pend, geom, quant, CHUNK, CHUNK,
                                            slots=C, want_coeffs=False,
                                            exact=True)

    shapes = (f"lane matrix {list(xs.shape)} ({plan.n_lanes} lanes), merged "
              f"events {list(ev.shape)}, cap_w {cap_w}, dense [{M}, {L}]")
    return stages, chain, shapes


def bucketed_stages(dev):
    """(stages, chain, shapes) of the mixed-size chunk; the chain takes
    the scatter, the other placements are stages."""
    import torch

    from tpujpeg_torch.ops import fsm, materialize, pixels
    from tpujpeg_torch.pipeline import Geometry, bucket_geometry
    from tpujpeg_torch.runtime import fused

    imgs = _corpus("mixed_rst")
    bucket = bucket_geometry(Geometry.of(imgs[0]))
    plan = fsm.build_plan_bucketed(imgs, bucket)
    up = tuple(torch.as_tensor(a).to(dev)
               for a in (plan.xs, plan.seg_n, plan.wrap_at, plan.skip))
    xs, sn, wrap_at, skip = up
    quant = _quant(imgs, dev)
    L = xs.shape[0]
    M = plan.max_blk * 64

    def scan():
        return fsm.fsm_scan(xs, sn, plan.tables, pad_info=(wrap_at, skip))

    ev = scan()[0].reshape(-1, L)
    p0, o0 = materialize.compact_to_rank(ev, rank_kernel=False,
                                         stop_after="init")
    p, o = materialize.compact_offsets(p0, o0)
    cp = materialize.compact_full(ev)
    dense = materialize.place_events(ev, M)
    dc_lane = fsm._dc_cumsum(dense.T.reshape(L, plan.max_blk, 64)[:, :, 0],
                             plan.tables, plan.max_blk)
    lanes = fused.bucket_lanes(L, CHUNK, plan.lanes_per_img, plan.k,
                               bucket.mcus_y, bucket.mcus_x, dev)
    ext = torch.as_tensor(plan.extents).to(dev)

    def transpose_dc():
        pl = dense.T.reshape(L, plan.max_blk, 64)
        fsm._dc_cumsum(pl[:, :, 0], plan.tables, plan.max_blk)

    def chain():
        return fused.decode_chunk_bucketed(plan, quant, bucket, CHUNK,
                                           uploaded=up, want_coeffs=False,
                                           exact=True)

    stages = [
        ("scan (fsm_scan, pad_info)", scan),
        ("materialize scatter (place_events)",
         lambda: materialize.place_events(ev, M)),
        ("materialize ranked: cumsum init (torch)",
         lambda: materialize.compact_to_rank(ev, rank_kernel=False,
                                             stop_after="init")),
        ("materialize ranked: compact_offsets",
         lambda: materialize.compact_offsets(p0, o0)),
        ("materialize ranked: spread_full with offsets",
         lambda: materialize.spread_full(p, M, o=o)),
        ("materialize full: compact_full",
         lambda: materialize.compact_full(ev)),
        ("materialize full: spread_full",
         lambda: materialize.spread_full(cp, M)),
        ("lane transpose + DC cumsum", transpose_dc),
        ("pixel kernel on the lane matrix at bucket size, exact (pixels)",
         lambda: pixels.rgb_444(bucket, dense, lanes, quant, dc=dc_lane,
                                extents=ext, exact=True)),
    ]
    shapes = (f"lane matrix {list(xs.shape)}, bucket {bucket.mcus_x} x "
              f"{bucket.mcus_y} MCUs, events {list(ev.shape)}, dense "
              f"[{M}, {L}]")
    return stages, chain, shapes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    dev = torch.device("cuda")
    print(f"card: {smi}")
    from torch.profiler import ProfilerActivity, profile

    tables = []
    for name, build in (("restart", restart_stages), ("spec", spec_stages),
                        ("bucketed", bucketed_stages)):
        stages, chain, shapes = build(dev)
        print(f"{name} chunk: {shapes}")
        for stage, fn in stages:
            print(f"{name} stage {stage}: {_ms(fn):.3f} ms")
        print(f"{name} chain: {_ms(chain):.3f} ms")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                chain()
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=30)
        print(table)
        tables.append(f"{name} chunk ({shapes})\n{table}")
        del stages, chain
        torch.cuda.empty_cache()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(f"card: {smi}\n" + "\n".join(tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
