#!/usr/bin/env python3
"""Smoke test of tpujpeg_torch on one CUDA card: the port's main paths.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from tpujpeg_torch/csrc (one nvcc per source,
     started together, sm_90a);
  2. restart path: BatchDecoder(backend="fsm", chunk_size=128) on one
     128-image chunk (the 16 committed 640x640 q90 4:4:4 restart-every-
     MCU-row streams of tests/fixtures/rst640, each 8 times): every
     output equals the host reference decoder's (tpujpeg.runtime.host:
     native C++, or the numpy oracle where the native library does not
     build), two equal the numpy oracle's, no host fallback; the engine
     materializes packed lanes through the classic scatter;
  3. speculative path: the same engine on the 128-image chunk of the
     no-restart streams of tests/fixtures/photo640 (640x640 q90 4:4:4,
     ~123 lanes per image), materialized through the slot route: backend
     "fsm-spec-sync", zero resolve misses, zero host fallbacks, outputs as
     in phase 2;
  4. the slot-overflow rung: the spec chunk again at a preset capacity
     of 64 overflows, is decoded again through the classic scatter, and
     stays bit-exact;
  5. the Jacobi path: fsm.decode_speculative_batch on the spec chunk
     equals the sync path's coefficients;
  6. goldens: the 6 golden fixtures through backend="fsm" (one lane per
     image; 8_401x363 latches the envelope at every step count and leaves
     through the K retry to the host route, as in the JAX engine) and
     through backend="host" equal the reference's .array outputs;
     4_800x600 (22,500 blocks) through the speculative path equals the
     oracle;
  7. each kernel against its plain PyTorch version on the chunks' real
     inputs (torch.equal), with both times (CUDA events; kernels warm,
     median of 5; a plain version that takes seconds is timed once);
  8. throughput: end to end for both chunks, and the device chain with
     the slot route and with the classic scatter.

Each path of phases 2-6 runs with the launch counts set to 0 just before
it and read just after, and fails if a kernel it must run was not
launched.  The second-to-last line is a JSON object with one entry per
kernel (launches summed over those paths); the last line is
{"ok": true, "device": {...}}.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
RST = os.path.join(FIXTURES, "rst640")
PHOTO = os.path.join(FIXTURES, "photo640")
GOLDEN = ["1_320x240", "2_400x400", "3_120x120", "5_200x200", "6_225x168",
          "8_401x363"]
# denser than STEPS_SAFE symbols per byte: the scan latches the envelope
# (tests/test_torch_spec.py::test_dense_golden_latches_envelope_like_jax)
DENSE_GOLDEN = "8_401x363"
CHUNK = 128
REPEAT = CHUNK // 16
SLOT_KERNELS = ("compact", "slot_unpack", "slot_expand")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_once(fn):
    """(fn(), its milliseconds) for one run (CUDA events): for plain
    versions that take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def max_abs_err(got, want) -> int:
    import torch

    worst = 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def equal_all(got, want, what: str) -> int:
    """Check every tensor of `got` equals `want`'s; return max_abs_err."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        check((g is None) == (w is None), f"{what}: output {i} presence")
        if g is not None:
            check(torch.equal(g, w), f"{what}: output {i} kernel != plain")
    return max_abs_err(got, want)


def read_streams(folder: str) -> list[bytes]:
    names = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
    check(len(names) == 16, f"expected 16 streams in {folder}, found "
          f"{len(names)}")
    out = []
    for n in names:
        with open(os.path.join(folder, n), "rb") as f:
            out.append(f.read())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    sys.path.insert(0, ROOT)
    import numpy as np

    from tpujpeg.io.arrayio import read_array
    from tpujpeg.io.parser import parse
    from tpujpeg.oracle import decoder as oracle
    from tpujpeg.runtime import host
    from tpujpeg_torch.ops import fsm, materialize, pixels
    from tpujpeg_torch.pipeline import Geometry, soa_planes
    from tpujpeg_torch.runtime import fused, kernels
    from tpujpeg_torch.runtime.batch import BatchDecoder

    # ---- phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{smi} (nvidia-smi name, power.limit)"
    dev = torch.device("cuda")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # ---- phase 1: build the kernels
    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 1: built {kernels.LIB_PATH.name} from "
          f"{len(kernels._sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")

    totals = {name: 0 for name in kernels.KERNELS}

    def run_path(name: str, fn, need=(), any_of=()):
        """Run one path with the counts reset before and read after;
        check it launched every kernel of `need` and, for each group of
        `any_of`, all kernels of at least one alternative."""
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        print(f"{name}: launches {json.dumps(counts)}")
        for k in need:
            check(counts[k] > 0, f"{name}: kernel {k} was not launched")
        for alternatives in any_of:
            check(any(all(counts[k] > 0 for k in alt)
                      for alt in alternatives),
                  f"{name}: none of {alternatives} launched")
        for k, n in counts.items():
            totals[k] += n
        return out

    materialize_route = ((SLOT_KERNELS, ("place_events",)),)

    # ---- phase 2: the restart path on one 128-image chunk
    streams = read_streams(RST)
    datas = streams * REPEAT
    t0 = time.perf_counter()
    refs = [host.decode_cpu(parse(d)) for d in streams]
    print(f"phase 2: reference decoder {host.backend_name()}, 16 streams in "
          f"{time.perf_counter() - t0:.1f} s")
    dec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                       device="cuda")
    out = run_path("phase 2", lambda: dec.decode(datas),
                   need=("fsm_scan", "place_events", "pixels"))
    stats = dec.stats
    print(f"phase 2: stats {json.dumps(stats.as_dict())}")
    check(len(out) == CHUNK, "output count")
    for i, got in enumerate(out):
        check(got is not None and np.array_equal(got, refs[i % 16]),
              f"chunk output {i} differs from {host.backend_name()}")
    for i in (0, 9):
        want = oracle.decode(parse(streams[i])).astype(np.uint8)
        check(np.array_equal(out[i], want), f"output {i} differs from oracle")
    check(stats.backend == "fsm", f"backend {stats.backend}")
    check(stats.chunks == 1, f"chunks {stats.chunks}")
    check(stats.fsm_malformed_fallbacks == 0, "malformed fallback")
    check(stats.fsm_envelope_fallbacks == 0, "envelope fallback")
    print(f"phase 2: {CHUNK} outputs bit-exact vs {host.backend_name()}, "
          f"2 vs oracle; k_retries {stats.fsm_k_retries}, slot_retries "
          f"{stats.fsm_slot_retries}, repaired pixels "
          f"{stats.repaired_pixels}")

    # ---- phase 3: the speculative path on one 128-image chunk
    pstreams = read_streams(PHOTO)
    pdatas = pstreams * REPEAT
    pimgs = [parse(d) for d in pdatas]
    t0 = time.perf_counter()
    prefs = [host.decode_cpu(parse(d)) for d in pstreams]
    print(f"phase 3: reference decoder {host.backend_name()}, 16 streams in "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(im.restart_interval == 0 for im in pimgs), "restart markers")
    sdec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                        device="cuda")
    # the capacity the chunk is dispatched at (sampled or the default)
    c_used = sdec._slot_capacity(fsm_chunk_stub(pimgs))
    pout = run_path("phase 3", lambda: sdec.decode(pdatas),
                    need=("fsm_scan", "pixels")
                    + (SLOT_KERNELS if c_used else ("place_events",)))
    sstats = sdec.stats
    print(f"phase 3: stats {json.dumps(sstats.as_dict())}")
    for i, got in enumerate(pout):
        check(got is not None and np.array_equal(got, prefs[i % 16]),
              f"spec output {i} differs from {host.backend_name()}")
    for i in (2, 13):
        want = oracle.decode(parse(pstreams[i])).astype(np.uint8)
        check(np.array_equal(pout[i], want),
              f"spec output {i} differs from oracle")
    check(sstats.backend == "fsm-spec-sync", f"backend {sstats.backend}")
    check(sstats.chunks == 1, f"chunks {sstats.chunks}")
    check(sstats.spec_sync_misses == 0, "spec-sync miss")
    check(sstats.fsm_malformed_fallbacks == 0, "malformed fallback")
    check(sstats.fsm_envelope_fallbacks == 0, "envelope fallback")
    splan = fsm.build_spec_plan_batch(pimgs, 1024)
    sxs = torch.as_tensor(splan.xs).to(dev)
    pending = fsm.spec_sync_start(pimgs, plan=splan, xs_dev=sxs)
    quotas, cap_w = fsm.spec_sync_resolve_host(pending)
    print(f"phase 3: {CHUNK} outputs bit-exact vs {host.backend_name()}, "
          f"2 vs oracle; lanes {splan.n_lanes} (matrix "
          f"{list(splan.xs.shape)}), cap_w {cap_w}, slot capacity at "
          f"dispatch {c_used}, slot_retries {sstats.fsm_slot_retries} "
          f"(capacity now {sdec._slot_c}), k_retries "
          f"{sstats.fsm_k_retries}, repaired pixels "
          f"{sstats.repaired_pixels}")

    # ---- phase 4: the slot-overflow rung
    odec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                        device="cuda")
    odec._slot_c = 64
    oout = run_path("phase 4", lambda: odec.decode(pdatas),
                    need=("fsm_scan", "pixels", "place_events")
                    + SLOT_KERNELS)
    check(odec.stats.fsm_slot_retries >= 1,
          f"slot_retries {odec.stats.fsm_slot_retries}")
    check(odec.stats.backend == "fsm-spec-sync",
          f"backend {odec.stats.backend}")
    for i, got in enumerate(oout):
        check(np.array_equal(got, prefs[i % 16]),
              f"overflow-retry output {i} differs")
    print(f"phase 4: capacity 64 overflowed, slot_retries "
          f"{odec.stats.fsm_slot_retries}, classic retry bit-exact")
    odec.close()
    del oout

    # ---- phase 5: the Jacobi path on the same chunk
    jac, (jmal, jenv) = run_path(
        "phase 5", lambda: fsm.decode_speculative_batch(
            pimgs, device_out=True, pad_to=CHUNK, device=dev),
        need=("fsm_scan", "place_events"))
    syn, (serr, _) = fsm.decode_speculative_sync(pimgs, pending=pending,
                                                 pad_to=CHUNK)
    check(not bool(jmal.any() | jenv.any()), "Jacobi write pass latched")
    check(not bool(serr.any()), "sync tail latched")
    check(torch.equal(jac, syn), "Jacobi coefficients != sync coefficients")
    print(f"phase 5: Jacobi decode_speculative_batch == sync path, "
          f"coefficients {list(jac.shape)}")
    del jac, syn

    # ---- phase 6: goldens
    gdatas, gwant = [], []
    for n in GOLDEN:
        with open(os.path.join(FIXTURES, n + ".jpg"), "rb") as f:
            gdatas.append(f.read())
        gwant.append(read_array(os.path.join(FIXTURES, n + ".array")))
    gdec = BatchDecoder(backend="fsm", device="cuda")

    def goldens_fsm():
        # one decode per golden: each is one lane, and its route shows
        routes = []
        for n, data, w in zip(GOLDEN, gdatas, gwant):
            got = gdec.decode([data])[0]
            st = gdec.stats
            check(np.array_equal(got, w), f"golden {n} differs (fsm)")
            if n == DENSE_GOLDEN:
                # it leaves the device through the ladder: K retry, then
                # the host route
                check(st.backend == "host" and st.fsm_k_retries == 1
                      and st.fsm_envelope_fallbacks == 1
                      and st.fsm_malformed_fallbacks == 0,
                      f"golden {n}: route {st.as_dict()}")
            else:
                check(st.backend == "fsm", f"golden {n}: route "
                      f"{st.as_dict()}")
            routes.append(f"{n} {st.backend} (k_retries {st.fsm_k_retries}, "
                          f"envelope fallbacks {st.fsm_envelope_fallbacks})")
        return routes

    routes = run_path("phase 6 fsm", goldens_fsm,
                      need=("fsm_scan", "place_events", "pixels"))
    print("phase 6: golden routes: " + "; ".join(routes))
    with open(os.path.join(FIXTURES, "4_800x600.jpg"), "rb") as f:
        big = f.read()
    bout = run_path("phase 6 spec", lambda: gdec.decode([big]),
                    need=("fsm_scan", "pixels"), any_of=materialize_route)
    check(gdec.stats.backend == "fsm-spec-sync",
          f"4_800x600 backend {gdec.stats.backend}")
    check(np.array_equal(bout[0], oracle.decode(parse(big)).astype(np.uint8)),
          "4_800x600 differs from oracle")
    gdec.close()
    hdec = BatchDecoder(backend="host", device="cuda")
    hout = hdec.decode(gdatas)
    hdec.close()
    for n, g, w in zip(GOLDEN, hout, gwant):
        check(np.array_equal(g, w), f"golden {n} differs (host)")
    check(hdec.stats.backend == "host", f"host backend {hdec.stats.backend}")
    print(f"phase 6: {len(GOLDEN)} goldens bit-exact through backend fsm "
          f"(one lane each, routes above) and host; 4_800x600 bit-exact "
          f"through fsm-spec-sync")

    # ---- phase 7: kernels against their plain versions, real inputs
    rows = []
    imgs = [parse(d) for d in datas]
    plan = fsm.build_plan(imgs)
    xs = torch.as_tensor(plan.xs).to(dev)
    sn = torch.as_tensor(plan.seg_n_blocks).to(dev)
    L, stride = plan.xs.shape
    print(f"phase 7: restart lane matrix [{L}, {stride}], max_blk "
          f"{plan.max_blk}")
    scan_err = 0
    scan_plain_ms = None
    for steps in (fsm.STEPS_PRODUCTION, fsm.STEPS_SAFE):
        k = fsm._scan_steps(steps)
        got = fsm.fsm_scan(xs, sn, plan.tables, steps)
        want, ms = timed_once(
            lambda: fsm.fsm_scan_plain(xs, sn, plan.tables, k))
        if steps == fsm.STEPS_PRODUCTION:
            scan_plain_ms = ms
        scan_err = max(scan_err, equal_all(got, want, f"fsm_scan {steps}"))
        print(f"phase 7: fsm_scan restart steps {steps}: equal; lanes mal "
              f"{int(got[1].sum())} env {int(got[2].sum())}")
    scan_ms = cuda_ms(lambda: fsm.fsm_scan(xs, sn, plan.tables))

    # the speculative modes on the spec chunk's inputs
    SL = splan.xs.shape[0]
    caps = torch.full((SL,), splan.blk_cap, dtype=torch.int32, device=dev)
    cbits = torch.as_tensor(splan.chunk_bits).to(dev)
    inherit = torch.as_tensor(fsm._lane_masks(splan)[0]).to(dev)

    k_prod = fsm._scan_steps(fsm.STEPS_PRODUCTION)

    def cold(plain=False):
        if plain:
            return fsm.fsm_scan_spec_plain(sxs, caps, splan.tables, k_prod,
                                           chunk_bits=cbits, log_anchors=True)
        return fsm.fsm_scan_spec(sxs, caps, splan.tables, chunk_bits=cbits,
                                 log_anchors=True)

    got = cold()
    want, cold_plain_ms = timed_once(lambda: cold(plain=True))
    scan_err = max(scan_err, equal_all(got, want, "fsm_scan anchors"))
    cold_ms = cuda_ms(cold)
    P, bim_t = fsm._handoff(got.end_bits, got.end_bim, inherit,
                            splan.chunk_bytes)
    del got, want
    xs2 = sxs[:, :fsm.SPEC_STITCH_BYTES + fsm.SPEC_OVERLAP]
    cb2 = torch.clamp(cbits, max=fsm.SPEC_STITCH_BYTES * 8)

    def entry(plain=False):
        kw = dict(start_bits=P, start_bim=bim_t, chunk_bits=cb2)
        if plain:
            return fsm.fsm_scan_spec_plain(xs2, caps, splan.tables, k_prod,
                                           **kw)
        return fsm.fsm_scan_spec(xs2, caps, splan.tables, **kw)

    got = entry()
    want, entry_plain_ms = timed_once(lambda: entry(plain=True))
    scan_err = max(scan_err, equal_all(got, want, "fsm_scan entry"))
    entry_ms = cuda_ms(entry)
    print(f"phase 7: fsm_scan spec chunk [{SL}, {splan.xs.shape[1]}]: "
          f"anchor mode and speculative entry (stitch window) equal")
    del got, want
    rows.append(dict(
        name="fsm_scan", route="cuda", source="tpujpeg_torch/csrc/fsm_scan.cu",
        replaces="tpujpeg/ops/fsm.py:702", launches=totals["fsm_scan"],
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain_ms,
        ms_anchor_mode=cold_ms, plain_ms_anchor_mode=cold_plain_ms,
        ms_entry_mode=entry_ms, plain_ms_entry_mode=entry_plain_ms,
    ))

    # the classic scatter on the restart chunk
    events, err_mal, _ = fsm.fsm_scan(xs, sn, plan.tables)
    ev = events.reshape(-1, L)
    M = plan.max_blk * 64
    err_k = torch.zeros(L, dtype=torch.bool, device=dev)
    err_p = torch.zeros(L, dtype=torch.bool, device=dev)
    got = materialize.place_events(ev, M, err_k)
    want = materialize.place_events_plain(ev, M, err_p)
    pe_err = equal_all([got, err_k], [want, err_p], "place_events")
    print(f"phase 7: place_events [{ev.shape[0]}, {L}] -> [{M}, {L}] equal")
    rows.append(dict(
        name="place_events", route="cuda",
        source="tpujpeg_torch/csrc/materialize.cu",
        replaces="tpujpeg/ops/materialize.py:205,314",
        launches=totals["place_events"], max_abs_err=pe_err,
        ms=cuda_ms(lambda: materialize.place_events(ev, M)),
        plain_ms=cuda_ms(lambda: materialize.place_events_plain(ev, M)),
    ))
    restart_dense = got
    del want

    # the slot kernels on the spec chunk's merged events
    sev, _ = fsm._spec_sync_merge(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        torch.as_tensor(quotas).to(dev))
    SM = cap_w * 64
    G = materialize.SLOT_G
    slot_err = {k: 0 for k in SLOT_KERNELS}
    overflowed = {}
    for C in (256, 64):
        p, o = materialize.compact_to_rank(sev)
        slot_err["compact"] = max(slot_err["compact"], equal_all(
            (p, o), materialize.compact_to_rank_plain(sev), "compact"))
        o2, ovf = materialize.slot_unpack(p, o, C, G)
        slot_err["slot_unpack"] = max(slot_err["slot_unpack"], equal_all(
            (o2, ovf), materialize.slot_unpack_plain(p, o, C, G),
            f"slot_unpack C={C}"))
        dense = materialize.slot_expand(o2, p, SM, C, G)
        slot_err["slot_expand"] = max(slot_err["slot_expand"], equal_all(
            (dense,), (materialize.slot_expand_plain(o2, p, SM, C, G),),
            f"slot_expand C={C}"))
        overflowed[C] = int(ovf.sum())
        print(f"phase 7: slot route C={C} on merged events "
              f"[{sev.shape[0]}, {SL}] -> [{SM}, {SL}]: compact, unpack, "
              f"expand equal; overflow lanes {overflowed[C]}")
        if C == 256:
            slot_ms = {
                "compact": (cuda_ms(lambda: materialize.compact_to_rank(sev)),
                            cuda_ms(lambda: materialize.compact_to_rank_plain(
                                sev))),
                "slot_unpack": (
                    cuda_ms(lambda: materialize.slot_unpack(p, o, C, G)),
                    cuda_ms(lambda: materialize.slot_unpack_plain(p, o, C, G))),
                "slot_expand": (
                    cuda_ms(lambda: materialize.slot_expand(o2, p, SM, C, G)),
                    cuda_ms(lambda: materialize.slot_expand_plain(
                        o2, p, SM, C, G))),
            }
        del p, o, o2, ovf, dense
    check(overflowed[64] > 0, "capacity 64 did not overflow the spec chunk")
    spec_classic_ms = cuda_ms(lambda: materialize.place_events(sev, SM))
    print(f"phase 7: classic scatter on the same merged events "
          f"{spec_classic_ms:.4f} ms [{card}]")
    replaces = {"compact": "tpujpeg/ops/materialize.py:205",
                "slot_unpack": "tpujpeg/ops/materialize.py:728",
                "slot_expand": "tpujpeg/ops/materialize.py:773"}
    for k in SLOT_KERNELS:
        rows.append(dict(
            name=k, route="cuda", source="tpujpeg_torch/csrc/slots.cu",
            replaces=replaces[k], launches=totals[k],
            max_abs_err=slot_err[k], ms=slot_ms[k][0],
            plain_ms=slot_ms[k][1],
        ))
    del sev

    # the pixel kernel on the restart chunk
    geom = Geometry.of(imgs[0])
    quant = torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)).to(dev)
    per_lane = restart_dense.T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
    coeffs = fused._assemble_rows(per_lane, plan.layout, CHUNK)
    dc = fused._assemble_rows(dc_lane, plan.layout, CHUNK)
    zp, q, dcp = soa_planes(geom, coeffs, quant, dc)
    got = pixels.rgb_soa_fused(zp, q, dcp)
    want = pixels.rgb_soa_fused_plain(zp, q, dcp)
    px_err = equal_all(got, want, "rgb_soa_fused")
    print(f"phase 7: rgb_soa_fused {list(zp.shape)} -> rg/bk "
          f"{list(got[0].shape)} equal in every bit")
    rows.append(dict(
        name="pixels", route="cuda", source="tpujpeg_torch/csrc/pixels.cu",
        replaces="tpujpeg/ops/pixels_pallas.py:84",
        launches=totals["pixels"], max_abs_err=px_err,
        ms=cuda_ms(lambda: pixels.rgb_soa_fused(zp, q, dcp)),
        plain_ms=cuda_ms(lambda: pixels.rgb_soa_fused_plain(zp, q, dcp)),
    ))
    for r in rows:
        print(f"phase 7: {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms [{card}]")
    print(f"phase 7: fsm_scan anchor mode {cold_ms:.4f} ms (plain "
          f"{cold_plain_ms:.4f}), speculative entry {entry_ms:.4f} ms "
          f"(plain {entry_plain_ms:.4f}) [{card}]")
    del events, ev, per_lane, got, want, zp, dcp, restart_dense

    # ---- phase 8: throughput
    for name, d, data in (("restart", dec, datas), ("spec", sdec, pdatas)):
        d.decode(data)  # warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            d.decode(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        d.close()
        t = statistics.median(times)
        mb = d.stats.compressed_bytes / 1e6
        print(f"phase 8: {name} chunk end to end (parse, plan, upload, "
              f"device, fetch, repair) {CHUNK} images in {t * 1e3:.1f} ms "
              f"(median of 3): {CHUNK / t:.1f} images/s, {mb / t:.2f} "
              f"compressed MB/s, backend {d.stats.backend} [{card}]")

    squant = torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in pimgs
    ]).astype(np.int32)).to(dev)
    sgeom = Geometry.of(pimgs[0])
    # a capacity that holds this chunk: 256 if it does, else 512 (64 G)
    c_spec = 256 if overflowed[256] == 0 else 512
    rst_ovf = fused.decode_chunk_fused(
        plan, quant, geom, CHUNK, uploaded=(xs, sn), slots=256)[-1]
    c_rst = 256 if not bool(rst_ovf.any()) else 512

    def spec_chain(slots):
        p = fsm.spec_sync_start(pimgs, plan=splan, xs_dev=sxs)
        return fused.decode_spec_sync_fused(p, sgeom, squant, CHUNK, CHUNK,
                                            slots=slots)

    def restart_chain(slots):
        return fused.decode_chunk_fused(plan, quant, geom, CHUNK,
                                        uploaded=(xs, sn), slots=slots)

    spec_stages = "cold + stitch scan, resolve read, merge, materialize, " \
        "gather + DC, pixels"
    rst_stages = "scan, materialize, DC, assemble, pixels"
    chains = [
        ("spec", spec_chain, c_spec, pdatas, spec_stages),
        ("spec", spec_chain, False, pdatas, spec_stages),
        ("restart", restart_chain, c_rst, datas, rst_stages),
        ("restart", restart_chain, False, datas, rst_stages),
    ]
    for name, fn, slots, data, stages in chains:
        check(not bool(fn(slots)[-1].any()), f"{name}: slot overflow")
        ms = cuda_ms(lambda: fn(slots))
        mb = sum(len(x) for x in data) / 1e6
        print(f"phase 8: device chain {name} slots={slots} (plan and bytes "
              f"resident; {stages}) {ms:.2f} ms: "
              f"{CHUNK / ms * 1e3:.1f} images/s, "
              f"{mb / ms * 1e3:.2f} compressed MB/s [{card}]")

    # the Jacobi path's entropy decode alone (its own 2048-byte plan, bytes
    # resident): count passes to the fixed point, the write pass, gather
    jplan = fsm.build_spec_plan_batch(pimgs, 2048)
    jxs = torch.as_tensor(jplan.xs).to(dev)
    jac_ms = cuda_ms(lambda: fsm.decode_speculative_batch(
        pimgs, device_out=True, pad_to=CHUNK, plan=jplan, xs_dev=jxs))
    print(f"phase 8: Jacobi entropy decode of the spec chunk (plan and bytes "
          f"resident, {jplan.n_lanes} lanes of {jplan.xs.shape[1]} bytes; "
          f"count passes, flag reads, write pass, gather; no pixels) "
          f"{jac_ms:.2f} ms [{card}]")

    print(f"total wall time {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def fsm_chunk_stub(imgs):
    """The two fields BatchDecoder._slot_capacity reads of a chunk."""
    from types import SimpleNamespace

    return SimpleNamespace(slots_off=False, imgs=imgs[:1])


if __name__ == "__main__":
    sys.exit(main())
