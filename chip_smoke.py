#!/usr/bin/env python3
"""Smoke test of tpujpeg_torch on one CUDA card: the port's main path.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  1. build the three CUDA kernels from tpujpeg_torch/csrc (nvcc, sm_90a);
  2. the slice: BatchDecoder(backend="fsm", chunk_size=128) on one
     128-image chunk (the 16 committed 640x640 q90 4:4:4 restart-every-
     MCU-row streams of tests/fixtures/rst640, each 8 times): every output
     equals the host reference decoder's (tpujpeg.runtime.host: native
     C++, or the numpy oracle where the native library does not build),
     two equal the numpy oracle's, no host fallback, and every kernel was
     launched;
  3. each kernel against its plain PyTorch version on the chunk's real
     inputs (torch.equal), with both times (CUDA events, warm, median of 5);
  4. the 6 golden fixtures through BatchDecoder(backend="host"): host
     entropy, then the pixel kernel and strict repair, equal to the
     reference's .array outputs;
  5. throughput of the 128-image chunk, end to end and device chain only.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  The script imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(ROOT, "tests", "fixtures", "rst640")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
GOLDEN = ["1_320x240", "2_400x400", "3_120x120", "5_200x200", "6_225x168",
          "8_401x363"]
CHUNK = 128
REPEAT = CHUNK // 16


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


def max_abs_err(got, want) -> int:
    import torch

    worst = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        worst = max(worst, int(d.max()) if d.numel() else 0)
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
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

    # ---- phase 2: the slice on one 128-image chunk
    names = sorted(f for f in os.listdir(CORPUS) if f.endswith(".jpg"))
    check(len(names) == 16, f"expected 16 corpus streams, found {len(names)}")
    streams = []
    for n in names:
        with open(os.path.join(CORPUS, n), "rb") as f:
            streams.append(f.read())
    datas = streams * REPEAT
    t0 = time.perf_counter()
    refs = [host.decode_cpu(parse(d)) for d in streams]
    print(f"phase 2: reference decoder {host.backend_name()}, 16 streams in "
          f"{time.perf_counter() - t0:.1f} s")

    dec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                       device="cuda")
    kernels.reset_launches()
    out = dec.decode(datas)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    stats = dec.stats
    print(f"phase 2: stats {json.dumps(stats.as_dict())}")
    print(f"phase 2: launches {json.dumps(launches)}")
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print(f"phase 2: {CHUNK} outputs bit-exact vs {host.backend_name()}, "
          f"2 vs oracle; k_retries {stats.fsm_k_retries}, repaired pixels "
          f"{stats.repaired_pixels}")

    # ---- phase 3: kernels against their plain versions, real inputs
    imgs = [parse(d) for d in datas]
    plan = fsm.build_plan(imgs)
    xs = torch.as_tensor(plan.xs).to(dev)
    sn = torch.as_tensor(plan.seg_n_blocks).to(dev)
    L, stride = plan.xs.shape
    print(f"phase 3: lane matrix [{L}, {stride}], max_blk {plan.max_blk}")
    rows = []

    scan_err = 0
    for steps in (fsm.STEPS_PRODUCTION, fsm.STEPS_SAFE):
        k = fsm._scan_steps(steps)
        got = fsm.fsm_scan(xs, sn, plan.tables, steps)
        want = fsm.fsm_scan_plain(xs, sn, plan.tables, k)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"fsm_scan kernel != plain at {steps}")
        scan_err = max(scan_err, max_abs_err(got, want))
        print(f"phase 3: fsm_scan steps {steps}: events/err_mal/err_env "
              f"equal; lanes mal {int(got[1].sum())} env {int(got[2].sum())}")
    events, err_mal, _ = fsm.fsm_scan(xs, sn, plan.tables)
    scan_ms = cuda_ms(lambda: fsm.fsm_scan(xs, sn, plan.tables))
    scan_plain_ms = cuda_ms(lambda: fsm.fsm_scan_plain(
        xs, sn, plan.tables, fsm._scan_steps(fsm.STEPS_PRODUCTION)))
    rows.append(dict(
        name="fsm_scan", route="cuda", source="tpujpeg_torch/csrc/fsm_scan.cu",
        replaces="tpujpeg/ops/fsm.py:702", launches=launches["fsm_scan"],
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain_ms,
    ))

    ev = events.reshape(-1, L)
    M = plan.max_blk * 64
    err_k = torch.zeros(L, dtype=torch.bool, device=dev)
    err_p = torch.zeros(L, dtype=torch.bool, device=dev)
    got = materialize.place_events(ev, M, err_k)
    want = materialize.place_events_plain(ev, M, err_p)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and torch.equal(err_k, err_p),
          "place_events kernel != plain")
    print(f"phase 3: place_events [{ev.shape[0]}, {L}] -> [{M}, {L}] equal")
    rows.append(dict(
        name="place_events", route="cuda",
        source="tpujpeg_torch/csrc/materialize.cu",
        replaces="tpujpeg/ops/materialize.py:205,314",
        launches=launches["place_events"],
        max_abs_err=max_abs_err([got, err_k], [want, err_p]),
        ms=cuda_ms(lambda: materialize.place_events(ev, M)),
        plain_ms=cuda_ms(lambda: materialize.place_events_plain(ev, M)),
    ))

    geom = Geometry.of(imgs[0])
    quant = torch.as_tensor(np.stack([
        np.stack([im.quant_tables[c.quant_id] for c in im.components])
        for im in imgs
    ]).astype(np.int32)).to(dev)
    per_lane = got.T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
    coeffs = fused._assemble_rows(per_lane, plan.layout, CHUNK)
    dc = fused._assemble_rows(dc_lane, plan.layout, CHUNK)
    zp, q, dcp = soa_planes(geom, coeffs, quant, dc)
    got = pixels.rgb_soa_fused(zp, q, dcp)
    want = pixels.rgb_soa_fused_plain(zp, q, dcp)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        check(torch.equal(g, w), "rgb_soa_fused kernel != plain")
    print(f"phase 3: rgb_soa_fused {list(zp.shape)} -> rg/bk "
          f"{list(got[0].shape)} equal in every bit")
    rows.append(dict(
        name="pixels", route="cuda", source="tpujpeg_torch/csrc/pixels.cu",
        replaces="tpujpeg/ops/pixels_pallas.py:84",
        launches=launches["pixels"], max_abs_err=max_abs_err(got, want),
        ms=cuda_ms(lambda: pixels.rgb_soa_fused(zp, q, dcp)),
        plain_ms=cuda_ms(lambda: pixels.rgb_soa_fused_plain(zp, q, dcp)),
    ))
    for r in rows:
        print(f"phase 3: {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms [{card}]")
    del events, ev, per_lane, got, want, zp, dcp

    # ---- phase 4: goldens through host entropy + the pixel kernel
    gdatas, gwant = [], []
    for n in GOLDEN:
        with open(os.path.join(FIXTURES, n + ".jpg"), "rb") as f:
            gdatas.append(f.read())
        gwant.append(read_array(os.path.join(FIXTURES, n + ".array")))
    gdec = BatchDecoder(backend="host", device="cuda")
    gout = gdec.decode(gdatas)
    gdec.close()
    for n, g, w in zip(GOLDEN, gout, gwant):
        check(np.array_equal(g, w), f"golden {n} differs")
    check(gdec.stats.backend == "host", f"golden backend {gdec.stats.backend}")
    print(f"phase 4: {len(GOLDEN)} goldens bit-exact (host entropy + pixel "
          f"kernel, {gdec.stats.repaired_pixels} pixels repaired)")

    # ---- phase 5: throughput
    dec.decode(datas)  # warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        dec.decode(datas)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dec.close()
    t = statistics.median(times)
    mb = stats.compressed_bytes / 1e6
    print(f"phase 5: end to end (parse, plan, upload, device, fetch, repair) "
          f"{CHUNK} images in {t * 1e3:.1f} ms (median of 3): "
          f"{CHUNK / t:.1f} images/s, {mb / t:.2f} compressed MB/s [{card}]")
    uploaded = (xs, sn)
    chain_ms = cuda_ms(lambda: fused.decode_chunk_fused(
        plan, quant, geom, CHUNK, uploaded=uploaded))
    print(f"phase 5: device chain only (scan, materialize, DC, assemble, "
          f"pixels; plan resident) {chain_ms:.2f} ms: "
          f"{CHUNK / chain_ms * 1e3:.1f} images/s, "
          f"{mb / chain_ms * 1e3:.2f} compressed MB/s [{card}]")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
