#!/usr/bin/env python3
"""Smoke test of tpujpeg_torch on one CUDA card: the port's main paths.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  0. the card: nvidia-smi's name and power limit, torch and CUDA versions;
  1. build the CUDA kernels from tpujpeg_torch/csrc (one nvcc per source,
     started together, sm_90a) and the port's native host library
     (tpujpeg_torch/runtime/native, g++; without OpenMP where that link
     fails), both into tpujpeg_torch/_build;
  2. restart path: BatchDecoder(backend="fsm", chunk_size=128) on one
     128-image chunk (the 16 committed 640x640 q90 4:4:4 restart-every-
     MCU-row streams of tests/fixtures/rst640, each 8 times): every
     output equals the host reference decoder's
     (tpujpeg_torch.runtime.host: native C++, or the numpy oracle where
     the native library does not build), two equal the numpy oracle's, no
     host fallback, no pixel repaired (strict colour is exact on the
     card); the engine materializes packed lanes through the classic
     scatter, and the pixel kernel reads its dense lane matrix in place;
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
  6b. mixed sizes: BatchDecoder(backend="fsm", size_buckets=True) on one
     128-image chunk of the 16 committed mixed-size streams of
     tests/fixtures/mixed_rst (624-800 px a side, 4:4:4 q90, a restart
     marker every MCU row, one 101 x 101 MCU bucket; each 8 times), once
     per materialize route ("scatter", "ranked", "full"): backend
     "fsm-bucketed", no fallback, outputs as in phase 2, and each route
     launched its own kernels and no other route's;
  6c. 4:2:0, with box and with fancy chroma upsampling (fancy=False,
     True), 128 images each: the restart chunk (tests/fixtures/rst640_420,
     5,120 lanes of 240 blocks, backend "fsm"), the chunk without restart
     markers (tests/fixtures/photo640_420: the single-pass resolve misses
     on these streams, as in the JAX engine, because some lanes do not
     find the MCU phase again inside the stitch window, so the chunk is
     decoded by the Jacobi path, backend "fsm-spec", still on the card),
     and the mixed sizes (tests/fixtures/mixed_rst_420, four size-class
     buckets, backend "fsm-bucketed", route "scatter").  Every output
     equals the host reference decoder's with the same `fancy`, two per
     chunk equal the oracle's, no host fallback, and the pixel kernel is
     not launched: subsampled pixels take the plane path (torch ops).
     Then the slot route at 6 blocks per MCU (the 4:2:0 restart chunk
     through fused.decode_chunk_fused(slots=C) equals the classic
     scatter, no overflow), and the five small streams of
     tests/fixtures/sampling_small (4:2:2, 4:4:0, 4:1:1, grayscale with
     and without restart markers) through backend "fsm" and "host";
  6d. the probe tools, in this process: tools/bench_torch_gather.py's
     launch-path split of the two gathers' calls and its chain walks
     (print_split, print_chains; its CUDA-graph readings of the gathers
     and the chain come in phase 7, outside the counted run, and its
     torch.profiler cross-check not at all: it would leave the later
     launches of this process slower),
     and tools/bench_torch_materialize.py; together they drive the six
     probe kernels (gather_rows, gather_table, chain, compact_fine,
     compact_staged, spread_ranked);
  6e. the engine's surface: on the 128-image restart chunk, which
     build_plan's split packs into two stride groups,
     fsm.entropy_decode_fsm equals the host reference decoder's
     coefficients with two launches each of fsm_scan and place_events,
     and the engine's staged branch (the split forced) decodes it
     bit-exact with the same launches and pixels on [B, n_blocks, 64];
     both packings are timed with their uploads and with their bytes
     resident, and the link probe (measured_link_mbps) and the two link
     rates derived from these readings are printed beside the engine's
     constants, which must route as they do; decode(fetch=False) on the
     restart and spec chunks returns None with the fetch=True run's
     counters (both end to end times printed); backend "cpu" (workers =
     os.cpu_count()) on the restart chunk launches no kernel (on the
     goldens where the native library does not build); backend
     "oracle" on the goldens; backend "auto" takes the route its probe
     reads; fsm.decode_speculative on 4_800x600 equals the oracle, and
     decode_speculative_batch / decode_speculative_sync
     (device_out=False) on the spec chunk equal the reference; the root
     decode with each backend on one golden;
  7. each kernel against its plain PyTorch version on the chunks' real
     inputs (torch.equal), with both times (CUDA events; kernels warm,
     median of 5; a plain version that takes seconds is timed once, the
     STEPS_SAFE and 4:2:0 plain scans on the first 1,024 lanes), its
     bound (the bytes it must move over 3.35 TB/s, or its operations over
     67 Top/s, whichever is larger) and, where one PyTorch call computes
     the same function, that call's time.  The two kernels redesigned
     for this card are held in more uses: fsm_scan at STEPS_SAFE in the
     count and write passes of the Jacobi path (1,024 lanes), at one step
     per byte on lanes that latch the envelope and on malformed lanes,
     besides the restart, pad_info, 6-blocks-per-MCU, cold and stitch
     uses; place_events on the 4:2:0 events with an out-of-range target
     that latches and the event that packs to 0.  For place_events on
     both restart chunks' events a line of its own gives the zero fill
     alone, the kernel with its fill, index_put_, and the byte and sector
     bounds (sectors: valid events x 32 bytes read and written, plus the
     fill and the events).  The slot kernels (compact, slot_unpack,
     slot_expand) are held on the speculative chunk's merged events at
     C = 256 and 64 and on the restart chunk's events at the capacity
     phase 8 runs it and at 64 (both overflow at 64); slot_expand gets
     the same line as place_events on both, with zero fill + index_put_
     on the same targets (its bytes: o2, the payload of live rows and
     dense), and a line on how many slot groups a 32-lane tile's live
     lanes lie apart at one compacted row.  The three entries of
     csrc/compact.cuh are held on the speculative chunk's merged events
     (compact and compact_full), the restart chunk's (compact) and the
     mixed chunk's (compact_full, and compact_offsets on its column-cumsum
     offsets and on compact_fine's residual ones), and one line gives
     each time beside its byte bound (no memset).  spread_full, the
     second entry of csrc/place.cuh (the body of place_events), gets a
     line of its own on the mixed chunk, with and without offsets,
     beside its byte and sector bounds and index_put_; spread_ranked has
     the same bounds in its row.  A function of an offsets pair (p, o)
     must read p only where o >= 0, so its bounds count p there alone.
     compact_fine (csrc/compact.cuh's masked walk), compact_staged (that
     walk, then the ranked walk) and compact_offsets get a line of their
     own: each beside its byte bound, the sector bound of a scatter of
     both outputs (2 x 64 bytes an event), and its PyTorch call (a zero
     fill of p, a -1 fill of o and two index_put_, held equal to the
     kernel first), with the share of the masked walk's events stored
     directly (behind its window).
     The pixel kernel is held in both colour modes
     on the restart chunk's dense lane matrix (the engine's input), on
     the same coefficients as [B, n_blocks, 64] (the speculative, Jacobi
     and host routes' layout) and on the mixed chunk's bucket-raster lane
     matrix (padded rows, DC masked outside each image's extent: the
     bucketed chain's input, the whole 808x808 raster compared), with
     kernel, plain, bytes, bound and share.  The two gathers are read
     apart from their launch path (tools/bench_torch_gather.py's
     gather_readings): device ms from one CUDA graph of 20 calls, call ms
     (one call between events) and the host's us per call, for the
     kernel and for its PyTorch call (torch.gather, index_select), at the
     tool's shape and at a shape of the same layout past L2, held equal
     to the plain version at both and on index views 4, 8 and 12 bytes
     into their storage; their row's ms, plain_ms, library_ms and bound
     are the shape past L2's.  chain is held equal on every source at T
     4,096 (the step masks) and 4,093 (it multiplies by a reciprocal),
     at 0, 4,096 and 65,536 steps, and read as device ns per step from a
     CUDA graph beside its latency floor (the same walk with the step
     taken out, over a table that is one permutation cycle;
     tools/bench_torch_gather.py's chain_readings) and the share.
     fsm_scan at the multi-byte columns (2, 3), (2, 4) and (4, 7) on the
     restart chunk, held against the plain scan on its first 1,024 lanes
     (the plain version on the host CPU), each with its ms, bytes, bound
     and share beside (1, 2) read in the same phase; decode_segments on
     the restart and spec chunks' segment plans equal to the host
     reference decoder's coefficients on every image, and on the
     restart chunk's first 1,024 lanes to its plain version (host CPU),
     with its bound (bytes: the scan, lane arrays, tables and the dense
     int32 output; operations: ~40 a symbol, counted from this run's
     nonzero coefficients) on both chunks, its zero fill alone, the
     deepest lane's symbol steps and their mean (counted on the host
     from the decoded coefficients: a DC, each nonzero AC, a ZRL per 16
     zeros before one, an EOB before z = 63), ns a deepest-lane step
     (kernel less fill) and its latency floor (those steps x the chain
     probe's shared-memory floor read above) with the share floor /
     kernel;
  6f. the pipelined engine (decode streams; chunks prepared on the prep
     pool, uploaded from page-locked memory on a copy stream) on batches
     of several 128-image chunks: R, 1,024 restart streams (rst640 x 64,
     8 chunks); M, runs of 128 restart and 128 no-restart streams in
     turns (rst640, photo640; 8 chunks, "fsm" and "fsm-spec-sync"); B,
     512 mixed sizes (mixed_rst x 32, size_buckets=True, 4 chunks).
     Every output equals the host reference decoder's, no fallback, and
     the launch counts equal those of the same bytes decoded one
     128-image run per decode call (the serial form).  Three warm runs
     each of the pipelined decode with fetch=True and fetch=False and of
     the serial form (median, min, max, images/s), the host split of a
     run (BatchStats parse_s, entropy_s, device_s and the rest of
     total_s), the device's busy share of a fetch=False run of R from a
     torch.profiler trace (utils/profiling.device_trace, written to a
     temporary directory), and one restart chunk's build_plan and
     its upload two ways (the engine's, each array pinned and copied on
     the copy stream, and pageable);
  6g. the gather backend: BatchDecoder(backend="gather") on the 128-image
     restart chunk (10,240 lanes) and on the spec chunk (one lane an
     image: a deep walk): outputs as in phases 2 and 3, decode_segments
     and pixels launched once a chunk and fsm_scan not at all; end to end
     (three warm runs) and the segment decoder alone and with the pixel
     stage (plan and bytes resident), median, min and max;
  6h. the wide-scan superchunk: four restart chunks (the corpus in four
     orders) through fused.decode_superchunk, one scan of 40,960 lanes,
     equal to four decode_chunk_fused calls (rgb, coefficients, DC, the
     masks) and, on four images, to the host reference; with the bytes
     resident the superchunk against the four calls, and the wide scan
     alone against four 10,240-lane scans;
  6i. several devices (tpujpeg_torch/parallel): one card, so every mesh
     names cuda:0 two or eight times and its shards run in turn (no
     reading here is one of scaling).  The batch-sharded pixel stage
     (sharding.compiled_batch_decoder, exact colour) of the 128-image
     restart chunk's coefficients over two shards equals
     device_decode_fn on one device, pixels launched once a shard, no
     transfer between shards, total 128 x 640 x 640, both timed;
     BatchDecoder(mesh=) on the two-shard mesh over the restart chunk
     (the staged chain: fsm_scan, place_events; and backend "gather":
     decode_segments, no scan), the spec chunk (the
     staged single-pass decode on the classic scatter, no slot kernel)
     and the mixed chunk (host-bucketed, no scan), each output equal to
     the host reference its one-device phase holds, pixels launched
     twice, end to end cold and warm; tools/validate_torch_huge.py's decode_striped of the
     committed 8192 x 8192 4:2:0 stream on 8 stripes, box and fancy,
     equal to host.decode_cpu, with 0 and 28 halo copies and 8 gathers;
     two processes (this script with --dist-worker, gloo over
     localhost, both on cuda:0) decode their round-robin shards of the
     16 rst640 streams, equal to the host reference, and
     allreduce_metrics sums 16 images and the streams' bytes; where
     there are two cards, the batch-sharded decode again on cuda:0 and
     cuda:1 (else a line says why it was skipped);
  7b. exact colour over all 134,217,728 triples of [-256, 255]^3 on the
     card, Y slab by Y slab, against the oracle's ycbcr_to_rgb_exact in
     numpy: the pixel kernel's exact mode (DC-only blocks whose samples
     are the triple) and color.color_exact in float64 (the plane path's);
  8. throughput: end to end for the 4:4:4 chunks (restart, speculative,
     mixed on "scatter") and the three 4:2:0 chunks with both `fancy`
     values (two timed decodes each, after the phase's own decode), the
     device chain of each as the strict engine runs it (median, min and
     max of 5 runs, 7 for the 4:2:0 chains), the rounds of the Jacobi
     fixed point on the 4:2:0 spec chunk (run on the host: a flag read
     after each round) and what those reads cost (the chain against the
     same launches with no read, the same rgb), and the plane path's
     stage times (IDCT, block -> raster, upsample, f32 and exact colour,
     pack); the restart chain cut after the scan, materialize and
     assemble (decode_chunk_fused stop_after; cumulative times, the cut
     checksums held to the scan's events and the full chain's assembled
     coefficients) and whole.

Each path of phases 2-6i runs with the launch counts set to 0 just before
it and read just after, and fails if a kernel it must run was not
launched; every engine of phases 2-6c reports 0 repaired pixels.  The second-to-last line is a JSON object with one entry per
kernel (launches summed over those paths, and per 128-image chunk of
each path); the last line is {"ok": true, "device": {...}}.  The script
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
RST = os.path.join(FIXTURES, "rst640")
PHOTO = os.path.join(FIXTURES, "photo640")
MIXED = os.path.join(FIXTURES, "mixed_rst")
RST420 = os.path.join(FIXTURES, "rst640_420")
PHOTO420 = os.path.join(FIXTURES, "photo640_420")
MIXED420 = os.path.join(FIXTURES, "mixed_rst_420")
SMALL = os.path.join(FIXTURES, "sampling_small")
GOLDEN = ["1_320x240", "2_400x400", "3_120x120", "5_200x200", "6_225x168",
          "8_401x363"]
# denser than STEPS_SAFE symbols per byte: the scan latches the envelope
# (tests/test_torch_spec.py::test_dense_golden_latches_envelope_like_jax)
DENSE_GOLDEN = "8_401x363"
CHUNK = 128
REPEAT = CHUNK // 16
SLOT_KERNELS = ("compact", "slot_unpack", "slot_expand")
# materialize route -> the kernels only it launches on a bucketed chunk
ROUTE_KERNELS = {"scatter": ("place_events",),
                 "ranked": ("compact_offsets", "spread_full"),
                 "full": ("compact_full", "spread_full")}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM 32-bit rate outside the tensor cores


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def cuda_times(fn, reps: int = 5) -> tuple[float, float, float]:
    """(median, min, max) milliseconds of fn() over `reps` warm runs
    (CUDA events)."""
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
    return statistics.median(times), min(times), max(times)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` warm runs (CUDA events)."""
    return cuda_times(fn, reps)[0]


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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the bytes a function must move
    (each input read once, each output written once) over the memory
    rate, or its operations over the 32-bit rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def segment_steps(coeffs, plan):
    """Symbol steps of each lane of a segment plan, counted on the host
    from its decoded coefficients (int32 [n_blocks_total, 64], zigzag):
    per block 1 DC, 1 per nonzero AC coefficient, 1 ZRL per full 16 zeros
    before a nonzero, and 1 EOB when the last nonzero lies before z = 63."""
    import numpy as np

    nz = coeffs[:, 1:] != 0
    steps = 1 + nz.sum(axis=1, dtype=np.int64)
    prev = np.zeros(len(coeffs), np.int64)
    for z in range(1, 64):
        hit = nz[:, z - 1]
        steps += np.where(hit, (z - prev - 1) // 16, 0)
        prev = np.where(hit, z, prev)
    steps += prev < 63
    cum = np.concatenate([[0], np.cumsum(steps)])
    base = plan.seg_block_base.astype(np.int64)
    live = plan.seg_n_blocks > 0
    return (cum[base + plan.seg_n_blocks] - cum[base])[live]


def read_streams(folder: str, count: int = 16) -> list[bytes]:
    names = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
    check(len(names) == count, f"expected {count} streams in {folder}, "
          f"found {len(names)}")
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

    from tpujpeg_torch.io.arrayio import read_array
    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch import pipeline
    from tpujpeg_torch.ops import fsm, materialize, pixels, probes
    from tpujpeg_torch.ops.color import color_channels, color_exact, pack_mask
    from tpujpeg_torch.oracle import decoder as oracle
    from tpujpeg_torch.pipeline import Geometry, bucket_geometry
    from tpujpeg_torch.runtime import fused, host, kernels
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
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    t0 = time.perf_counter()
    print(f"phase 1: host reference decoder {host.backend_name()} "
          f"(tpujpeg_torch/runtime/native, {time.perf_counter() - t0:.1f} s)")

    totals = {name: 0 for name in kernels.KERNELS}
    by_path = {}

    def run_path(name: str, fn, need=(), any_of=(), never=()):
        """Run one path with the counts reset before and read after;
        check it launched every kernel of `need`, none of `never` and,
        for each group of `any_of`, all kernels of at least one
        alternative."""
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        by_path[name] = counts
        print(f"{name}: launches {json.dumps(counts)}")
        for k in need:
            check(counts[k] > 0, f"{name}: kernel {k} was not launched")
        for k in never:
            check(counts[k] == 0, f"{name}: kernel {k} was launched")
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
    check(stats.repaired_pixels == 0, "repaired pixels")
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
    check(sstats.repaired_pixels == 0, "repaired pixels")
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
    check(odec.stats.backend == "fsm-spec-sync"
          and odec.stats.repaired_pixels == 0,
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
            check(np.array_equal(got, w) and st.repaired_pixels == 0,
                  f"golden {n} differs (fsm)")
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
    check(gdec.stats.backend == "fsm-spec-sync"
          and gdec.stats.repaired_pixels == 0,
          f"4_800x600 backend {gdec.stats.backend}")
    check(np.array_equal(bout[0], oracle.decode(parse(big)).astype(np.uint8)),
          "4_800x600 differs from oracle")
    gdec.close()
    hdec = BatchDecoder(backend="host", device="cuda")
    hout = hdec.decode(gdatas)
    hdec.close()
    for n, g, w in zip(GOLDEN, hout, gwant):
        check(np.array_equal(g, w), f"golden {n} differs (host)")
    check(hdec.stats.backend == "host" and hdec.stats.repaired_pixels == 0,
          f"host backend {hdec.stats.backend}")
    print(f"phase 6: {len(GOLDEN)} goldens bit-exact through backend fsm "
          f"(one lane each, routes above) and host; 4_800x600 bit-exact "
          f"through fsm-spec-sync")

    # ---- phase 6b: mixed sizes through the size buckets, per route
    mstreams = read_streams(MIXED)
    mdatas = mstreams * REPEAT
    mimgs = [parse(d) for d in mdatas]
    t0 = time.perf_counter()
    mrefs = [host.decode_cpu(parse(d)) for d in mstreams]
    sizes = sorted({(im.width, im.height) for im in mimgs})
    buckets = {bucket_geometry(Geometry.of(im)) for im in mimgs}
    check(len(sizes) == 16 and len(buckets) == 1,
          f"mixed corpus: {len(sizes)} sizes, {len(buckets)} buckets")
    bucket = buckets.pop()
    print(f"phase 6b: reference decoder {host.backend_name()}, 16 streams "
          f"of {len(sizes)} sizes ({sizes[0]} .. {sizes[-1]}) in "
          f"{time.perf_counter() - t0:.1f} s; bucket {bucket.mcus_x} x "
          f"{bucket.mcus_y} MCUs")
    mwant = {i: oracle.decode(parse(mstreams[i])).astype(np.uint8)
             for i in (4, 11)}
    mdecs = {}
    for route, own in ROUTE_KERNELS.items():
        others = {k for r, ks in ROUTE_KERNELS.items() if r != route
                  for k in ks} - set(own)
        mdec = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                            device="cuda", size_buckets=True,
                            materialize_route=route)
        mout = run_path(f"phase 6b {route}", lambda: mdec.decode(mdatas),
                        need=("fsm_scan", "pixels") + own,
                        never=tuple(others) + SLOT_KERNELS)
        mstats = mdec.stats
        print(f"phase 6b {route}: stats {json.dumps(mstats.as_dict())}")
        check(len(mout) == CHUNK, "output count")
        for i, got in enumerate(mout):
            check(got is not None and np.array_equal(got, mrefs[i % 16]),
                  f"mixed {route} output {i} differs from "
                  f"{host.backend_name()}")
        for i, want in mwant.items():
            check(np.array_equal(mout[i], want),
                  f"mixed {route} output {i} differs from oracle")
        check(mstats.backend == "fsm-bucketed", f"backend {mstats.backend}")
        check(mstats.chunks == 1, f"chunks {mstats.chunks}")
        check(mstats.fsm_malformed_fallbacks == 0, "malformed fallback")
        check(mstats.fsm_envelope_fallbacks == 0, "envelope fallback")
        check(mstats.repaired_pixels == 0, "repaired pixels")
        print(f"phase 6b {route}: {CHUNK} outputs of 16 sizes bit-exact vs "
              f"{host.backend_name()}, 2 vs oracle; k_retries "
              f"{mstats.fsm_k_retries}, repaired pixels "
              f"{mstats.repaired_pixels}")
        mdecs[route] = mdec
        del mout

    # ---- phase 6c: 4:2:0 chunks, box and fancy; the other samplings
    def quant_of(images):
        return torch.as_tensor(np.stack([
            np.stack([im.quant_tables[c.quant_id] for c in im.components])
            for im in images
        ]).astype(np.int32)).to(dev)

    plane_never = ("pixels",) + SLOT_KERNELS
    sub = {}   # chunk name -> streams, data, parsed images
    for name, folder in (("restart", RST420), ("spec", PHOTO420),
                         ("mixed", MIXED420)):
        st = read_streams(folder)
        sub[name] = (st, st * REPEAT, [parse(d) for d in st * REPEAT])
    check(all(im.blocks_per_mcu == 6 and im.sampling == "4:2:0"
              for _, _, ims in sub.values() for im in ims), "4:2:0 corpora")
    check(all(im.restart_interval == im.mcus_x
              for n in ("restart", "mixed") for im in sub[n][2])
          and all(im.restart_interval == 0 for im in sub["spec"][2]),
          "4:2:0 corpora restart intervals")
    buckets420 = sorted({bucket_geometry(Geometry.of(im))
                         for im in sub["mixed"][2]})
    in_bucket = {b: [im for im in sub["mixed"][2]
                     if bucket_geometry(Geometry.of(im)) == b]
                 for b in buckets420}
    print(f"phase 6c: mixed 4:2:0 corpus in {len(buckets420)} size-class "
          f"buckets: " + ", ".join(
              f"{b.mcus_x} x {b.mcus_y} MCUs ({len(ims)} images)"
              for b, ims in in_bucket.items()))
    want_backend = {"restart": ("fsm",), "mixed": ("fsm-bucketed",),
                    # the single-pass resolve, or after its miss the Jacobi
                    # path: both decode on the card
                    "spec": ("fsm-spec", "fsm-spec-sync")}
    decs420 = {}
    for fancy in (False, True):
        for name, (st, data, ims) in sub.items():
            tag = f"phase 6c {name} 4:2:0 fancy={fancy}"
            t0 = time.perf_counter()
            refs420 = [host.decode_cpu(parse(d), fancy=fancy) for d in st]
            t_ref = time.perf_counter() - t0
            d420 = BatchDecoder(backend="fsm", chunk_size=CHUNK, strict=True,
                                device="cuda", fancy=fancy,
                                size_buckets=name == "mixed")
            out420 = run_path(tag, lambda: d420.decode(data),
                              need=("fsm_scan", "place_events"),
                              never=plane_never)
            s420 = d420.stats
            print(f"{tag}: stats {json.dumps(s420.as_dict())}")
            check(len(out420) == CHUNK, f"{tag}: output count")
            for i, got in enumerate(out420):
                check(got is not None and np.array_equal(got, refs420[i % 16]),
                      f"{tag}: output {i} differs from {host.backend_name()}")
            for i in (1, 14):
                want = oracle.decode(parse(st[i]), fancy=fancy) \
                    .astype(np.uint8)
                check(np.array_equal(out420[i], want),
                      f"{tag}: output {i} differs from oracle")
            check(s420.backend in want_backend[name],
                  f"{tag}: backend {s420.backend}")
            check(s420.chunks == (len(buckets420) if name == "mixed" else 1),
                  f"{tag}: chunks {s420.chunks}")
            check(s420.fsm_malformed_fallbacks == 0
                  and s420.fsm_envelope_fallbacks == 0,
                  f"{tag}: host fallback")
            check(s420.repaired_pixels == 0, f"{tag}: repaired pixels")
            why = ""
            if name == "spec" and s420.spec_sync_misses:
                why = ("; the single-pass resolve missed (some lanes do not "
                       "find the MCU phase again inside the "
                       f"{fsm.SPEC_STITCH_BYTES}-byte stitch window, as in "
                       "the JAX engine) and the Jacobi path decoded the "
                       "chunk on the card")
            print(f"{tag}: {CHUNK} outputs bit-exact vs "
                  f"{host.backend_name()} ({t_ref:.1f} s for 16), 2 vs "
                  f"oracle; backend {s420.backend}, sync misses "
                  f"{s420.spec_sync_misses}, k_retries {s420.fsm_k_retries}, "
                  f"repaired pixels {s420.repaired_pixels}{why}")
            decs420[(name, fancy)] = d420
            del out420

    # the slot route at 6 blocks per MCU: 240-block restart lanes whose
    # 8-block slot groups straddle the six-block MCUs
    rimgs420 = sub["restart"][2]
    plan420 = fsm.build_plan(rimgs420, split=False)
    up420 = (torch.as_tensor(plan420.xs).to(dev),
             torch.as_tensor(plan420.seg_n_blocks).to(dev))
    quant420 = quant_of(rimgs420)
    geom420 = Geometry.of(rimgs420[0])
    c420 = materialize.suggest_slot_c(materialize.events_per_block(
        host.entropy_decode(rimgs420[0]))) or 512
    classic420 = fused.decode_chunk_fused(plan420, quant420, geom420, CHUNK,
                                          uploaded=up420, fancy=True)
    slotted420 = run_path(
        "phase 6c slots 4:2:0", lambda: fused.decode_chunk_fused(
            plan420, quant420, geom420, CHUNK, uploaded=up420, fancy=True,
            slots=c420),
        need=("fsm_scan",) + SLOT_KERNELS, never=("pixels", "place_events"))
    if bool(slotted420[-1].any()):
        # the sampled image is not the densest of the chunk
        c420 = 512
        slotted420 = fused.decode_chunk_fused(
            plan420, quant420, geom420, CHUNK, uploaded=up420, fancy=True,
            slots=c420)
    check(not bool(slotted420[-1].any()), "4:2:0 slot route overflowed")
    check(all(torch.equal(a, b) for a, b in zip(slotted420, classic420)),
          "4:2:0 slot route != classic scatter")
    print(f"phase 6c: 4:2:0 restart chunk (max_blk {plan420.max_blk}) "
          f"through the slot route at C={c420}: no overflow, equal to the "
          f"classic scatter")
    del slotted420, classic420

    # 4:2:2, 4:4:0, 4:1:1, grayscale (with and without restart markers)
    small = read_streams(SMALL, 5)
    simgs = [parse(d) for d in small]
    kinds = [f"{im.sampling}{' rst' if im.restart_interval else ''}"
             for im in simgs]
    check({im.sampling for im in simgs} == {"4:2:2", "4:4:0", "4:1:1", "gray"},
          f"small corpus samplings {kinds}")
    for fancy in (False, True):
        swant = [oracle.decode(im, fancy=fancy).astype(np.uint8)
                 for im in simgs]
        for i, im in enumerate(simgs):
            check(np.array_equal(host.decode_cpu(im, fancy=fancy), swant[i]),
                  f"small stream {kinds[i]}: host reference != oracle")
        for backend in ("fsm", "host"):
            sd = BatchDecoder(backend=backend, device="cuda", fancy=fancy)
            tag = f"phase 6c small {backend} fancy={fancy}"
            sout = run_path(
                tag, lambda: sd.decode(small),
                need=("fsm_scan", "place_events") if backend == "fsm" else (),
                never=plane_never)
            sd.close()
            for i, got in enumerate(sout):
                check(got is not None and np.array_equal(got, swant[i]),
                      f"{tag}: {kinds[i]} differs from the oracle")
            check(sd.stats.backend == backend
                  and sd.stats.chunks == len({Geometry.of(im)
                                              for im in simgs})
                  and sd.stats.fsm_malformed_fallbacks == 0
                  and sd.stats.fsm_envelope_fallbacks == 0
                  and sd.stats.repaired_pixels == 0,
                  f"{tag}: route {sd.stats.as_dict()}")
            print(f"{tag}: {', '.join(kinds)} bit-exact vs the oracle and "
                  f"{host.backend_name()}; backend {sd.stats.backend}, "
                  f"repaired pixels {sd.stats.repaired_pixels}")

    # ---- phase 6d: the probe tools, in this process
    import bench_torch_gather
    import bench_torch_materialize

    def gather_tool():
        bench_torch_gather.print_split(dev, smi)
        bench_torch_gather.print_chains(dev)

    run_path("phase 6d gather tool", gather_tool,
             need=("gather_rows", "gather_table", "chain"))
    check(run_path("phase 6d materialize tool",
                   lambda: bench_torch_materialize.main(
                       ["--corpus", "rst640_420"]),
                   need=("fsm_scan", "place_events", "compact_offsets",
                         "compact_fine", "compact_staged",
                         "spread_ranked")) == 0,
          "tools/bench_torch_materialize.py failed")
    torch.cuda.empty_cache()

    # ---- phase 6e: the engine's surface
    from tpujpeg_torch.runtime import batch as engine

    def counters(st) -> dict:
        return {k: v for k, v in st.as_dict().items()
                if k not in ("parse_s", "entropy_s", "device_s", "total_s")}

    rimgs = [parse(d) for d in datas]
    rgeom = Geometry.of(rimgs[0])
    rcoef = [host.entropy_decode(parse(d)) for d in streams]
    plan1 = fsm.build_plan(rimgs, split=False)
    plan2 = fsm.build_plan(rimgs)
    check(len(plan1.groups) == 1 and len(plan2.groups) == 2,
          f"restart chunk: {len(plan2.groups)} stride groups under split")
    print("phase 6e: restart chunk lane matrices: one group "
          f"{list(plan1.xs.shape)}; split "
          + " + ".join(str(list(g[0].shape)) for g in plan2.groups))
    got = run_path("phase 6e entropy_decode_fsm",
                   lambda: fsm.entropy_decode_fsm(rimgs),
                   need=("fsm_scan", "place_events"))
    counts = by_path["phase 6e entropy_decode_fsm"]
    check(counts["fsm_scan"] == 2 and counts["place_events"] == 2,
          f"entropy_decode_fsm launches {counts}")
    got = got.reshape(CHUNK, rgeom.n_blocks, 64)
    for i in range(CHUNK):
        check(np.array_equal(got[i], rcoef[i % 16]),
              f"entropy_decode_fsm image {i} differs from "
              f"{host.backend_name()}")
    del got
    print(f"phase 6e: entropy_decode_fsm on the split restart chunk equals "
          f"{host.backend_name()}'s coefficients, {CHUNK} images")

    # the staged branch of the engine: the split taken at any link rate
    split_at = engine._LINK_MBPS_SPLIT
    engine._LINK_MBPS_SPLIT = float("inf")
    try:
        tdec = BatchDecoder(backend="fsm", chunk_size=CHUNK, device="cuda")
        tout = run_path("phase 6e staged", lambda: tdec.decode(datas),
                        need=("fsm_scan", "place_events", "pixels"))
    finally:
        engine._LINK_MBPS_SPLIT = split_at
    counts = by_path["phase 6e staged"]
    check(counts["fsm_scan"] == 2 and counts["place_events"] == 2
          and counts["pixels"] == 1, f"staged chain launches {counts}")
    for i, g in enumerate(tout):
        check(np.array_equal(g, refs[i % 16]),
              f"staged output {i} differs from {host.backend_name()}")
    check(counters(tdec.stats) == counters(stats),
          f"staged stats {tdec.stats.as_dict()}")
    tdec.close()
    del tout
    print(f"phase 6e: the engine's staged branch (two scans, the perm "
          f"gather, assemble_batched, pixels on [B, n_blocks, 64]) on the "
          f"restart chunk: {CHUNK} outputs bit-exact, counters equal to "
          f"phase 2's")

    # both packings of the restart chunk, each with its upload, then with
    # its bytes resident; the link probe and the two derived rates
    rquant = quant_of(rimgs)

    def fused_chain(up):
        return fused.decode_chunk_fused(plan1, rquant, rgeom, CHUNK,
                                        uploaded=up, want_coeffs=False,
                                        exact=True)

    def staged_chain(up):
        per_lane, _ = fsm.decode_plan(plan2, uploaded=up)
        coeffs = fsm.assemble_batched(per_lane, layout=plan2.layout,
                                      pad_to=CHUNK)
        return pipeline.device_decode_fn(rgeom, coeffs, rquant, exact=True)

    def upload1():
        return tuple(torch.as_tensor(a).to(dev) for a in plan1.groups[0])

    up1, up2 = upload1(), fsm.upload_plan(plan2, dev)
    check(torch.equal(fused_chain(up1)[0], staged_chain(up2)[0]),
          "fused and staged chains differ")

    def entropy_chain():
        # the fsm route's device entropy decode: scan, materialize, DC
        ev, mal, _ = fsm.fsm_scan(*up1, plan1.tables)
        n_cols, K, L = ev.shape
        ct, _, _ = fsm.materialize_checked(ev.reshape(n_cols * K, L),
                                           plan1.max_blk * 64, mal)
        return fsm._dc_cumsum(ct.T.reshape(L, plan1.max_blk, 64)[:, :, 0],
                              plan1.tables, plan1.max_blk)

    timing = {
        "fused, upload": lambda: fused_chain(upload1()),
        "staged, upload": lambda: staged_chain(fsm.upload_plan(plan2, dev)),
        "fused, resident": lambda: fused_chain(up1),
        "staged, resident": lambda: staged_chain(up2),
        "entropy (fused packing)": entropy_chain,
    }
    tms = {k: cuda_times(fn) for k, fn in timing.items()}
    link = engine.measured_link_mbps(dev)
    bytes1 = sum(a.nbytes for a in plan1.groups[0])
    bytes2 = sum(a.nbytes for g in plan2.groups for a in g) \
        + plan2.perm.nbytes
    coef_bytes = CHUNK * rgeom.n_blocks * 64 * 4   # the host route's int32
    ent_ms = tms["entropy (fused packing)"][0]
    fsm_rate = (coef_bytes - bytes1) / ent_ms / 1e3
    extra_ms = tms["staged, resident"][0] - tms["fused, resident"][0]
    split_rate = (bytes1 - bytes2) / extra_ms / 1e3 if extra_ms > 0 \
        else float("inf")
    for k, (ms, lo, hi) in tms.items():
        print(f"phase 6e: restart chunk, {k}: {ms:.3f} ms (min {lo:.3f}, "
              f"max {hi:.3f}) [{card}]")
    print(f"phase 6e: link probe {link:.1f} MB/s; coefficient bytes "
          f"{coef_bytes}, scan bytes {bytes1} (one group), {bytes2} (split);"
          f" entropy chain {ent_ms:.3f} ms -> fsm route pays below "
          f"{fsm_rate:.1f} MB/s (engine constant "
          f"{engine._LINK_MBPS_FSM_THRESHOLD}); the staged chain costs "
          f"{extra_ms:.3f} ms more on the card -> the split pays below "
          f"{split_rate:.1f} MB/s (engine constant "
          f"{engine._LINK_MBPS_SPLIT}) [{card}]")
    check((link < fsm_rate) == (link < engine._LINK_MBPS_FSM_THRESHOLD)
          and (link < split_rate) == (link < engine._LINK_MBPS_SPLIT),
          "the engine's link constants route otherwise than this run's "
          "readings")
    del up1, up2

    # fetch=False: the same ladder and counters, nothing fetched
    for name, d, data, st in (("restart", dec, datas, stats),
                              ("spec", sdec, pdatas, sstats)):
        res = run_path(f"phase 6e fetch=False {name}",
                       lambda: d.decode(data, fetch=False),
                       need=("fsm_scan", "pixels"))
        check(res is None and counters(d.stats) == counters(st),
              f"fetch=False {name}: {d.stats.as_dict()}")
        e2e = {True: [], False: []}
        for fetch in (True, False, True, False):
            t0 = time.perf_counter()
            d.decode(data, fetch=fetch)
            torch.cuda.synchronize()
            e2e[fetch].append(f"{(time.perf_counter() - t0) * 1e3:.1f}")
        print(f"phase 6e: {name} chunk end to end (two warm runs each, in "
              f"turns), fetch=True {' and '.join(e2e[True])} ms, "
              f"fetch=False {' and '.join(e2e[False])} ms; counters equal "
              f"[{card}]")

    # backend "cpu": the native library on a pool, no kernel at all
    every = tuple(kernels.KERNELS)
    workers = os.cpu_count()
    cdec = BatchDecoder(backend="cpu", workers=workers, chunk_size=CHUNK,
                        device="cuda")
    native = host.backend_name() != "numpy-oracle"
    cdata, cwant = (datas, [refs[i % 16] for i in range(CHUNK)]) if native \
        else (gdatas, gwant)
    t0 = time.perf_counter()
    cout = run_path("phase 6e cpu", lambda: cdec.decode(cdata), never=every)
    t_cpu = (time.perf_counter() - t0) * 1e3
    cdec.close()
    for i, (g, w) in enumerate(zip(cout, cwant)):
        check(np.array_equal(g, w), f"backend cpu output {i} differs")
    check(cdec.stats.backend == "cpu", f"backend {cdec.stats.backend}")
    del cout
    where = "the restart chunk" if native \
        else "the goldens only: no native library"
    print(f"phase 6e: backend cpu ({host.backend_name()}, {workers} "
          f"workers) on {where}: {len(cdata)} outputs bit-exact in "
          f"{t_cpu:.1f} ms, 0 launches of every kernel")

    # backend "oracle": the numpy decoder's entropy, goldens only
    odec = BatchDecoder(backend="oracle", device="cuda")
    oout = run_path("phase 6e oracle", lambda: odec.decode(gdatas))
    odec.close()
    for n, g, w in zip(GOLDEN, oout, gwant):
        check(np.array_equal(g, w), f"golden {n} differs (oracle)")
    check(odec.stats.backend == "oracle", f"backend {odec.stats.backend}")
    print(f"phase 6e: backend oracle on the {len(GOLDEN)} goldens "
          f"bit-exact (the numpy oracle is too slow for the 128-image "
          f"chunks)")

    # backend "auto": the route its probe reads
    adec = BatchDecoder(backend="auto", chunk_size=CHUNK, device="cuda")
    to_fsm = adec._prefers_fsm()
    aout = run_path("phase 6e auto", lambda: adec.decode(datas),
                    need=("pixels",) + (("fsm_scan", "place_events")
                                        if to_fsm else ()),
                    never=() if to_fsm else ("fsm_scan",))
    adec.close()
    for i, g in enumerate(aout):
        check(np.array_equal(g, refs[i % 16]), f"auto output {i} differs")
    check(adec.stats.backend == ("fsm" if to_fsm else "host"),
          f"auto backend {adec.stats.backend}")
    del aout
    print(f"phase 6e: backend auto: link {link:.1f} MB/s against "
          f"{engine._LINK_MBPS_FSM_THRESHOLD} MB/s, native library "
          f"{host.backend_name()} -> route {adec.stats.backend}; {CHUNK} "
          f"outputs bit-exact")

    # the single-image and host-returning speculative entry points
    bimg = parse(big)
    bcoef = run_path("phase 6e decode_speculative",
                     lambda: fsm.decode_speculative(bimg),
                     need=("fsm_scan", "place_events"))
    check(np.array_equal(bcoef, oracle.entropy_decode(bimg)),
          "decode_speculative 4_800x600 differs from the oracle")
    pcoef = [host.entropy_decode(parse(d)) for d in pstreams]
    for name, fn in (
            ("decode_speculative_batch",
             lambda: fsm.decode_speculative_batch(pimgs)),
            ("decode_speculative_sync",
             lambda: fsm.decode_speculative_sync(pimgs, device_out=False))):
        res = run_path(f"phase 6e {name}", fn,
                       need=("fsm_scan", "place_events"))
        check(len(res) == CHUNK and all(
            np.array_equal(r, pcoef[i % 16]) for i, r in enumerate(res)),
            f"{name}(device_out=False) differs from {host.backend_name()}")
    print(f"phase 6e: decode_speculative on 4_800x600 equals the oracle; "
          f"decode_speculative_batch and decode_speculative_sync "
          f"(device_out=False) on the spec chunk equal "
          f"{host.backend_name()}, {CHUNK} images")

    # the package root's decode, every backend, on one golden
    import tpujpeg_torch

    gpath = os.path.join(FIXTURES, GOLDEN[2] + ".jpg")
    for b in ("cuda", "auto", "cpu", "oracle"):
        r = tpujpeg_torch.decode(gpath, backend=b)
        check(r.dtype == np.int32 and np.array_equal(r, gwant[2]),
              f"tpujpeg_torch.decode backend {b} differs on {GOLDEN[2]}")
    print(f"phase 6e: tpujpeg_torch.decode with backends cuda, auto, cpu, "
          f"oracle on {GOLDEN[2]}: bit-exact")
    torch.cuda.empty_cache()

    # ---- phase 6f: the pipelined engine on batches of several chunks
    from types import SimpleNamespace

    from tpujpeg_torch.utils.profiling import device_busy, device_trace, scope

    def host_split(st) -> str:
        rest = st.total_s - st.parse_s - st.entropy_s - st.device_s
        return (f"parse_s {st.parse_s * 1e3:.1f}, entropy_s "
                f"{st.entropy_s * 1e3:.1f}, device_s {st.device_s * 1e3:.1f}"
                f", rest (fetch, crop) {rest * 1e3:.1f} of total_s "
                f"{st.total_s * 1e3:.1f} ms")

    def wall_runs(fn, n: int = 3) -> list:
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    def ms3(times: list) -> str:
        return (f"{statistics.median(times):.2f} ms (min {min(times):.2f}, "
                f"max {max(times):.2f})")

    def spread(times: list, n_imgs: int) -> str:
        return (f"{ms3(times)}, "
                f"{n_imgs / statistics.median(times) * 1e3:.1f} images/s")

    runs6f = {
        "R": ([d for _ in range(REPEAT * 8) for d in streams],
              [r for _ in range(REPEAT * 8) for r in refs], {}, "fsm"),
        "M": ([d for k in range(8) for _ in range(REPEAT)
               for d in (streams if k % 2 == 0 else pstreams)],
              [r for k in range(8) for _ in range(REPEAT)
               for r in (refs if k % 2 == 0 else prefs)], {},
              "fsm+fsm-spec-sync"),
        "B": ([d for _ in range(REPEAT * 4) for d in mstreams],
              [r for _ in range(REPEAT * 4) for r in mrefs],
              {"size_buckets": True}, "fsm-bucketed"),
    }
    t_6f = time.perf_counter()
    for name, (bdatas, brefs, bargs, bbackend) in runs6f.items():
        n_chunks = len(bdatas) // CHUNK
        bdec = BatchDecoder(backend="fsm", chunk_size=CHUNK, device="cuda",
                            **bargs)
        bout = run_path(f"phase 6f {name}", lambda: bdec.decode(bdatas),
                        need=("fsm_scan", "pixels"))
        bst = bdec.stats
        check(bst.backend == bbackend and bst.chunks == n_chunks,
              f"6f {name}: backend {bst.backend}, chunks {bst.chunks}")
        check(bst.fsm_malformed_fallbacks == 0
              and bst.fsm_envelope_fallbacks == 0
              and bst.repaired_pixels == 0, f"6f {name}: {bst.as_dict()}")
        for i, (g, w) in enumerate(zip(bout, brefs)):
            check(g is not None and np.array_equal(g, w),
                  f"6f {name}: output {i} differs from {host.backend_name()}")
        check(len(bout) == len(brefs), f"6f {name}: output count")
        del bout

        def serial():
            return [r for j in range(0, len(bdatas), CHUNK)
                    for r in bdec.decode(bdatas[j : j + CHUNK])]

        sout = run_path(f"phase 6f {name} serial", serial,
                        need=("fsm_scan", "pixels"))
        del sout
        check(by_path[f"phase 6f {name}"]
              == by_path[f"phase 6f {name} serial"],
              f"6f {name}: pipelined launches differ from the serial form's")
        piped = wall_runs(lambda: bdec.decode(bdatas))
        split_t = host_split(bdec.stats)
        piped_nf = wall_runs(lambda: bdec.decode(bdatas, fetch=False))
        split_nf = host_split(bdec.stats)
        ser = wall_runs(serial)
        n_imgs = len(bdatas)
        print(f"phase 6f {name}: {n_imgs} images in {n_chunks} chunks, "
              f"backend {bst.backend}, outputs bit-exact vs "
              f"{host.backend_name()}, 0 fallbacks, launches equal to the "
              f"serial form's {json.dumps(by_path[f'phase 6f {name}'])}")
        print(f"phase 6f {name}: pipelined decode fetch=True "
              f"{spread(piped, n_imgs)}; fetch=False "
              f"{spread(piped_nf, n_imgs)}; serial (one decode per "
              f"128-image run, fetch=True) {spread(ser, n_imgs)} [{card}]")
        print(f"phase 6f {name}: host split, fetch=True: {split_t}; "
              f"fetch=False: {split_nf} [{card}]")
        if name == "R":
            with tempfile.TemporaryDirectory() as trace_dir:
                with device_trace(trace_dir):
                    with scope("batch R"):
                        bdec.decode(bdatas, fetch=False)
                busy = device_busy(os.path.join(trace_dir, "trace.json"),
                                   "batch R")
            check(busy["events"] > 0, "6f: the trace holds no device work")
            print(f"phase 6f R: device_trace of a fetch=False run: "
                  f"{busy['events']} kernels and copies, busy "
                  f"{busy['busy_us'] / 1e3:.2f} of {busy['window_us'] / 1e3:.2f}"
                  f" ms of the batch's wall window: busy share "
                  f"{busy['busy_us'] / busy['window_us']:.4f} [{card}]")
            # one chunk's host stages apart: the plan, then its arrays up
            # two ways (median of 5 warm runs each)
            cimgs = rimgs[:CHUNK]
            stub = SimpleNamespace(imgs=cimgs, geom=rgeom)
            plan_ms = wall_runs(lambda: fsm.build_plan(cimgs, split=False), 5)
            cplan = fsm.build_plan(cimgs, split=False)
            arrs = [a for g in cplan.groups for a in g] \
                + [cplan.perm, bdec._quant_host(stub)]
            up_bytes = sum(a.nbytes for a in arrs)

            def engine_upload():
                up = bdec._upload()
                for a in arrs:
                    up(a)
                up.done().event.synchronize()

            def pageable():
                [torch.from_numpy(a).to(dev) for a in arrs]
                torch.cuda.synchronize()

            ups = {k: wall_runs(f, 5) for k, f in (
                ("the engine's (each array pinned, copied on the copy "
                 "stream)", engine_upload),
                ("pageable", pageable))}
            print(f"phase 6f: one 128-image restart chunk: build_plan "
                  f"{ms3(plan_ms)}; its {up_bytes} bytes up: " + "; ".join(
                      f"{k} {ms3(v)}, "
                      f"{up_bytes / statistics.median(v) / 1e3:.1f} MB/s"
                      for k, v in ups.items()) + f" [{card}]")
        bdec.close()
    print(f"phase 6f: {time.perf_counter() - t_6f:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 6g: the gather backend (the lockstep-lane segment decoder)
    from tpujpeg_torch.ops import entropy

    t_6g = time.perf_counter()
    gather_kernel = {}
    for name, gdatas, grefs, gimgs in (("restart", datas, refs, rimgs),
                                       ("spec", pdatas, prefs, pimgs)):
        gdec = BatchDecoder(backend="gather", chunk_size=CHUNK, strict=True,
                            device="cuda")
        path = f"phase 6g {name}"
        gout = run_path(path, lambda: gdec.decode(gdatas),
                        need=("decode_segments", "pixels"),
                        never=("fsm_scan",))
        counts = by_path[path]
        check(counts["decode_segments"] == 1 and counts["pixels"] == 1,
              f"{path}: launches {counts}")
        gst = gdec.stats
        check(gst.backend == "gather" and gst.chunks == 1
              and gst.repaired_pixels == 0 and not gst.failures,
              f"{path}: stats {gst.as_dict()}")
        check(len(gout) == CHUNK, f"{path}: output count")
        for i, g in enumerate(gout):
            check(g is not None and np.array_equal(g, grefs[i % 16]),
                  f"{path}: output {i} differs from {host.backend_name()}")
        del gout
        e2e = wall_runs(lambda: gdec.decode(gdatas))
        gdec.close()
        # the device work with the plan, its bytes and its tables
        # resident: the segment decoder (zero fill + kernel), and it with
        # the pixel stage; apart, on the host's clock, what `decode_plan`
        # adds at dispatch: `device_luts` finding the table set
        gplan = entropy.build_segment_plan(gimgs)
        gup = tuple(torch.as_tensor(a).to(dev)
                    for a in entropy.plan_arrays(gplan))
        gluts = entropy.device_luts(gplan.luts, dev)
        gquant = quant_of(gimgs)
        ggeom = Geometry.of(gimgs[0])
        lookup = wall_runs(lambda: entropy.device_luts(gplan.luts, dev), 5)

        def seg():
            return entropy.decode_segments(
                *gup[:5], gluts, gup[5], cap=gplan.cap,
                n_blocks_total=gplan.n_blocks_total)

        def chain():
            coeffs, _ = seg()
            return pipeline.device_decode_fn(
                ggeom, coeffs.reshape(len(gimgs), ggeom.n_blocks, 64), gquant,
                exact=True)

        k_ms = cuda_times(seg)
        c_ms = cuda_times(chain)
        gather_kernel[name] = (gplan, gup, k_ms)
        print(f"{path}: {CHUNK} outputs bit-exact vs {host.backend_name()}, "
              f"launches decode_segments {counts['decode_segments']}, "
              f"pixels {counts['pixels']}, fsm_scan {counts['fsm_scan']}; "
              f"lanes {int((gplan.seg_n_blocks > 0).sum())} (padded "
              f"{gplan.seg_n_blocks.shape[0]}), cap {gplan.cap}; end to end "
              f"{spread(e2e, CHUNK)}; segment decoder (plan, bytes and "
              f"tables resident) {k_ms[0]:.3f} ms (min {k_ms[1]:.3f}, max "
              f"{k_ms[2]:.3f}); with the pixel stage, exact "
              f"{c_ms[0]:.3f} ms (min {c_ms[1]:.3f}, max {c_ms[2]:.3f}); "
              f"device_luts finding the {gplan.luts.shape[0]} tables "
              f"(host clock) {statistics.median(lookup):.3f} ms (min "
              f"{min(lookup):.3f}, max {max(lookup):.3f}) [{card}]")
        del gup
    print(f"phase 6g: {time.perf_counter() - t_6g:.1f} s")

    # ---- phase 6h: the wide-scan superchunk: four restart chunks, one scan
    t_6h = time.perf_counter()
    # four chunks of the restart corpus, each in another order
    h_imgs = [[rimgs[(i + 5 * j) % 16] for i in range(CHUNK)]
              for j in range(4)]
    h_plans = [fsm.build_plan(ims, split=False) for ims in h_imgs]
    h_quants = torch.stack([quant_of(ims) for ims in h_imgs])
    hxs, hsn, h_sub = fused.pack_superchunk(h_plans)
    h_up = (torch.as_tensor(hxs).to(dev), torch.as_tensor(hsn).to(dev))
    h_one = [(torch.as_tensor(p.xs).to(dev),
              torch.as_tensor(p.seg_n_blocks).to(dev)) for p in h_plans]
    wide = run_path("phase 6h superchunk", lambda: fused.decode_superchunk(
        h_plans, h_quants, rgeom, CHUNK, uploaded=h_up, exact=True),
        need=("fsm_scan", "place_events", "pixels"))
    check(by_path["phase 6h superchunk"]["fsm_scan"] == 1,
          "superchunk: more than one scan")
    narrow = run_path("phase 6h four chunks", lambda: [
        fused.decode_chunk_fused(p, q, rgeom, CHUNK, uploaded=u, exact=True)
        for p, q, u in zip(h_plans, h_quants, h_one)],
        need=("fsm_scan", "place_events", "pixels"))
    base = 0
    for j, (one, L_j) in enumerate(zip(narrow, h_sub)):
        for i in (0, 2, 3):   # rgb, coeffs, dc (risk is None: exact)
            check(torch.equal(one[i], wide[i][j * CHUNK:(j + 1) * CHUNK]),
                  f"superchunk output {i} of chunk {j} != decode_chunk_fused")
        for i in (4, 6):      # err_mal, err_slot
            check(torch.equal(one[i], wide[i][base:base + L_j]),
                  f"superchunk mask {i} of chunk {j} != decode_chunk_fused")
        check(not bool(one[4].any() | one[5].any()), "superchunk: latched")
        base += L_j
    check(torch.equal(torch.cat([o[5] for o in narrow]), wide[5]),
          "superchunk err_env != decode_chunk_fused")
    for j in (0, 3):
        out_j = wide[0][j * CHUNK:(j + 1) * CHUNK].permute(0, 2, 3, 1).cpu()
        for i in (0, CHUNK - 1):
            check(np.array_equal(out_j[i].numpy(), refs[(i + 5 * j) % 16]),
                  f"superchunk image {i} of chunk {j} differs from "
                  f"{host.backend_name()}")
    del wide, narrow, out_j
    sc_ms = cuda_times(lambda: fused.decode_superchunk(
        h_plans, h_quants, rgeom, CHUNK, uploaded=h_up, want_coeffs=False,
        exact=True))
    four_ms = cuda_times(lambda: [fused.decode_chunk_fused(
        p, q, rgeom, CHUNK, uploaded=u, want_coeffs=False, exact=True)
        for p, q, u in zip(h_plans, h_quants, h_one)])
    wscan_ms = cuda_times(lambda: fsm.fsm_scan(h_up[0], h_up[1],
                                               h_plans[0].tables))
    nscan_ms = cuda_times(lambda: [fsm.fsm_scan(u[0], u[1], p.tables)
                                   for p, u in zip(h_plans, h_one)])
    print(f"phase 6h: superchunk of four 128-image restart chunks (lane "
          f"matrix {list(hxs.shape)}, sub-chunks {list(h_sub)}) equals four "
          f"decode_chunk_fused calls (rgb, coefficients, DC, masks), images "
          f"0 and {CHUNK - 1} of chunks 0 and 3 equal {host.backend_name()}; "
          f"launches {json.dumps(by_path['phase 6h superchunk'])} against "
          f"{json.dumps(by_path['phase 6h four chunks'])} [{card}]")
    print(f"phase 6h: bytes resident, exact, no coefficients kept: "
          f"superchunk {sc_ms[0]:.3f} ms (min {sc_ms[1]:.3f}, max "
          f"{sc_ms[2]:.3f}); four chunks {four_ms[0]:.3f} ms (min "
          f"{four_ms[1]:.3f}, max {four_ms[2]:.3f}); the scan alone: one "
          f"scan of {hxs.shape[0]} lanes {wscan_ms[0]:.3f} ms (min "
          f"{wscan_ms[1]:.3f}, max {wscan_ms[2]:.3f}), four scans of "
          f"{h_sub[0]} lanes {nscan_ms[0]:.3f} ms (min {nscan_ms[1]:.3f}, "
          f"max {nscan_ms[2]:.3f}) [{card}]")
    del h_up, h_one, h_quants
    print(f"phase 6h: {time.perf_counter() - t_6h:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 6i: several devices (parallel/sharding.py, distributed.py)
    t_6i = time.perf_counter()
    phase_several_devices(run_path, by_path, card, datas, refs, pdatas,
                          prefs, mdatas, mrefs, rimgs, rgeom, rquant)
    print(f"phase 6i: {time.perf_counter() - t_6i:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 7: kernels against their plain versions, real inputs
    rows = []
    chunk_paths = {"restart": "phase 2", "spec": "phase 3"}
    chunk_paths.update({f"bucketed {r}": f"phase 6b {r}"
                        for r in ROUTE_KERNELS})
    chunk_paths.update({f"4:2:0 {n}": f"phase 6c {n} 4:2:0 fancy=True"
                        for n in sub})
    chunk_paths.update({"gather tool": "phase 6d gather tool",
                        "materialize tool": "phase 6d materialize tool",
                        "staged restart": "phase 6e staged",
                        "gather restart": "phase 6g restart",
                        "gather spec": "phase 6g spec",
                        "superchunk of 4 chunks": "phase 6h superchunk",
                        "4 chunks apart": "phase 6h four chunks",
                        "batch-sharded restart, 2 shards":
                            "phase 6i batch-sharded",
                        "mesh engine restart, 2 shards":
                            "phase 6i mesh restart",
                        "mesh engine gather, 2 shards":
                            "phase 6i mesh gather",
                        "mesh engine spec, 2 shards": "phase 6i mesh spec",
                        "mesh engine mixed, 2 shards":
                            "phase 6i mesh mixed"})

    def per_chunk(kernel: str) -> dict:
        """Launches of `kernel` per 128-image chunk of each path."""
        return {label: by_path[path][kernel]
                for label, path in chunk_paths.items()
                if by_path[path][kernel]}

    def scan_bound(xs_t, tables, n_planes: int, K: int, bpc: int = 1) -> dict:
        """Bound of one scan over xs_t [L, n] with `tables` at bpc bytes
        a column: the byte matrix, quotas and the packed tables read,
        n_planes int32 [ceil(n / bpc) + 6, K, L] planes and two latches
        written; ~60 32-bit operations per symbol step."""
        Ls, n = xs_t.shape
        steps_total = (-(-n // bpc) + fsm.FLUSH_COLS) * K * Ls
        return bound(Ls * n + 4 * Ls + fsm.scan_table(tables).nbytes
                     + 4 * n_planes * steps_total + 2 * Ls,
                     60 * steps_total)
    imgs = [parse(d) for d in datas]
    plan = fsm.build_plan(imgs, split=False)
    xs = torch.as_tensor(plan.xs).to(dev)
    sn = torch.as_tensor(plan.seg_n_blocks).to(dev)
    L, stride = plan.xs.shape
    print(f"phase 7: restart lane matrix [{L}, {stride}], max_blk "
          f"{plan.max_blk}")
    scan_err = 0
    scan_plain_ms = None
    for steps in (fsm.STEPS_PRODUCTION, fsm.STEPS_SAFE):
        k = fsm._scan_steps(steps)
        # lanes are independent: the retry's step count is held against
        # its plain version on the first 1,024 lanes
        n = L if steps == fsm.STEPS_PRODUCTION else 1024
        got = fsm.fsm_scan(xs[:n], sn[:n], plan.tables, steps)
        want, ms = timed_once(
            lambda: fsm.fsm_scan_plain(xs[:n], sn[:n], plan.tables, k))
        if steps == fsm.STEPS_PRODUCTION:
            scan_plain_ms = ms
        scan_err = max(scan_err, equal_all(got, want, f"fsm_scan {steps}"))
        print(f"phase 7: fsm_scan restart steps {steps} on {n} lanes: equal; "
              f"lanes mal {int(got[1].sum())} env {int(got[2].sum())}")
    scan_ms = cuda_ms(lambda: fsm.fsm_scan(xs, sn, plan.tables))
    # lanes that latch: a 0xFF tail on every seventh restart lane is an
    # invalid code (malformed); at one step per byte the dense lanes of the
    # chunk without restart markers overflow the bit buffer (envelope)
    bad = xs[:1024, :1024].clone()
    bad[::7, 300:] = 0xFF
    caps1k = torch.full((1024,), splan.blk_cap, dtype=torch.int32, device=dev)
    for what, x, q, tabs, k, flag in (
            ("malformed", bad, sn[:1024], plan.tables, 2, 1),
            ("envelope", sxs[:1024, :512], caps1k, splan.tables, 1, 2)):
        got = fsm.fsm_scan(x, q, tabs, k)
        want = fsm.fsm_scan_plain(x, q, tabs, k)
        scan_err = max(scan_err, equal_all(got, want, f"fsm_scan {what}"))
        check(bool(got[flag][::7].any()), f"no {what} lane latched")
        print(f"phase 7: fsm_scan at {k} steps per byte on {list(x.shape)} "
              f"({what} lanes): equal; lanes mal {int(got[1].sum())} env "
              f"{int(got[2].sum())}")
    del bad, got, want

    # the speculative modes on the spec chunk's inputs
    SL = splan.xs.shape[0]
    caps = torch.full((SL,), splan.blk_cap, dtype=torch.int32, device=dev)
    cbits = torch.as_tensor(splan.chunk_bits).to(dev)
    inherit = torch.as_tensor(fsm._lane_masks(splan)[0]).to(dev)

    k_prod = fsm._scan_steps(fsm.STEPS_PRODUCTION)[1]

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
    # the Jacobi path's two uses, at the retry's step count: the count
    # pass (no events) and the write pass, from the same entry states
    jkw = dict(start_bits=P[:1024], start_bim=bim_t[:1024],
               chunk_bits=cbits[:1024])
    k_safe = fsm._scan_steps(fsm.STEPS_SAFE)[1]
    want = fsm.fsm_scan_spec_plain(sxs[:1024], caps[:1024], splan.tables,
                                   k_safe, **jkw)
    for emit in (False, True):
        got = fsm.fsm_scan_spec(sxs[:1024], caps[:1024], splan.tables,
                                fsm.STEPS_SAFE, emit=emit, **jkw)
        scan_err = max(scan_err, equal_all(
            got, want if emit else want._replace(events=None),
            f"fsm_scan count/write emit={emit}"))
    count_ms = cuda_ms(lambda: fsm.fsm_scan_spec(
        sxs, caps, splan.tables, start_bits=P, start_bim=bim_t,
        chunk_bits=cbits, emit=False))
    print(f"phase 7: fsm_scan count pass (emit=False) and write pass at "
          f"steps {fsm.STEPS_SAFE} on 1024 lanes equal; count pass on the "
          f"chunk {count_ms:.4f} ms [{card}]")
    del got, want

    # the bucket-raster emission on the mixed chunk's lanes
    bplan = fsm.build_plan_bucketed(mimgs, bucket)
    bup = tuple(torch.as_tensor(a).to(dev) for a in
                (bplan.xs, bplan.seg_n, bplan.wrap_at, bplan.skip))
    bxs, bsn, bwrap, bskip = bup
    BL, bstride = bplan.xs.shape

    def pad_scan(plain=False, lanes=BL, pad=(bwrap, bskip), cols=bstride):
        args = (bxs[:lanes, :cols], bsn[:lanes], bplan.tables)
        pad = (pad[0][:lanes], pad[1][:lanes])
        if plain:
            return fsm.fsm_scan_plain(*args, k_prod, pad_info=pad)
        return fsm.fsm_scan(*args, pad_info=pad)

    got = pad_scan()
    want, pad_plain_ms = timed_once(lambda: pad_scan(plain=True))
    scan_err = max(scan_err, equal_all(got, want, "fsm_scan pad_info"))
    pad_ms = cuda_ms(pad_scan)
    check(not bool(got[1].any() | got[2].any()), "pad scan latched lanes")
    mev = got[0].reshape(-1, BL)
    merr = got[1]
    del got, want
    # this corpus has one MCU row per lane, so a lane ends where its row
    # wraps; cut the rows in four with 7 padding slots after each to make
    # the counters wrap and skip inside the lanes (the first 1024 lanes and
    # their first 1024 byte columns, read in place: two or three wraps)
    synth = (torch.clamp(bwrap // 4, min=1), torch.full_like(bskip, 7))
    got = pad_scan(lanes=1024, pad=synth, cols=1024)
    want = pad_scan(plain=True, lanes=1024, pad=synth, cols=1024)
    scan_err = max(scan_err, equal_all(got, want, "fsm_scan pad_info wraps"))
    check(not torch.equal(got[0], pad_scan(lanes=1024, cols=1024)[0]),
          "synthetic pad counters changed nothing")
    print(f"phase 7: fsm_scan pad_info on the mixed chunk [{BL}, {bstride}] "
          f"(max_blk {bplan.max_blk}, {bplan.lanes_per_img} lanes per "
          f"image) equal; wrapping counters equal on 1024 lanes x 1024 "
          f"columns")
    del got, want
    # the restart scan at 6 blocks per MCU, at the 4:2:0 chunk's shape
    xs420, sn420 = up420
    L420, stride420 = plan420.xs.shape
    got = fsm.fsm_scan(xs420, sn420, plan420.tables)
    want, sub_plain_ms = timed_once(lambda: fsm.fsm_scan_plain(
        xs420[:1024], sn420[:1024], plan420.tables, k_prod))
    scan_err = max(scan_err, equal_all(
        (got[0][:, :, :1024], got[1][:1024], got[2][:1024]), want,
        "fsm_scan 4:2:0"))
    check(not bool(got[1].any() | got[2].any()), "4:2:0 scan latched lanes")
    sub_ms = cuda_ms(lambda: fsm.fsm_scan(xs420, sn420, plan420.tables))
    ev420 = got[0].reshape(-1, L420)
    print(f"phase 7: fsm_scan on the 4:2:0 restart chunk [{L420}, "
          f"{stride420}] (max_blk {plan420.max_blk}, 6 blocks per MCU) "
          f"equal to the plain scan on the first 1024 lanes; events "
          f"{list(ev420.shape)}, dense [{plan420.max_blk * 64}, {L420}]")
    del got, want
    # multi-byte columns on the restart chunk: each spec on the card, held
    # against the plain scan on the first 1,024 lanes on the host CPU (the
    # plain scan on the card pays a launch per vector op: 10.9 s for the
    # whole chunk at (1, 2))
    multi = {}
    n_mb = 1024
    xs_h, sn_h = xs[:n_mb].cpu(), sn[:n_mb].cpu()
    for steps in ((2, 3), (2, 4), (4, 7)):
        got = fsm.fsm_scan(xs, sn, plan.tables, steps)
        t0 = time.perf_counter()
        want = fsm.fsm_scan_plain(xs_h, sn_h, plan.tables, steps)
        mb_plain = (time.perf_counter() - t0) * 1e3
        scan_err = max(scan_err, equal_all(
            (got[0][:, :, :n_mb].cpu(), got[1][:n_mb].cpu(),
             got[2][:n_mb].cpu()), want, f"fsm_scan {steps}"))
        lanes = (int(got[1].sum()), int(got[2].sum()))
        del got, want
        mb_ms = cuda_times(lambda: fsm.fsm_scan(xs, sn, plan.tables, steps))
        multi[steps] = dict(ms=mb_ms, plain_ms=mb_plain, lanes=lanes,
                            **scan_bound(xs, plan.tables, 1, steps[1],
                                         steps[0]))
    prod_ms = cuda_times(lambda: fsm.fsm_scan(xs, sn, plan.tables))
    for steps, r in multi.items():
        ms, lo, hi = r["ms"]
        print(f"phase 7: fsm_scan restart steps {steps} on [{L}, {stride}] "
              f"(events [{-(-stride // steps[0]) + fsm.FLUSH_COLS}, "
              f"{steps[1]}, {L}]): equal to the plain scan on the first "
              f"{n_mb} lanes (plain on the host CPU {r['plain_ms']:.1f} ms); "
              f"lanes mal {r['lanes'][0]} env {r['lanes'][1]}; kernel "
              f"{ms:.4f} ms (min {lo:.4f}, max {hi:.4f}), "
              f"{r['bound_bytes']} bytes, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, share {r['bound_ms'] / ms:.3f}; (1, 2) in "
              f"the same phase {prod_ms[0]:.4f} ms (min {prod_ms[1]:.4f}, "
              f"max {prod_ms[2]:.4f}) [{card}]")
    del xs_h, sn_h
    rows.append(dict(
        name="fsm_scan", route="cuda", source="tpujpeg_torch/csrc/fsm_scan.cu",
        replaces="tpujpeg/ops/fsm.py:702", launches=totals["fsm_scan"],
        launches_per_chunk=per_chunk("fsm_scan"),
        max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain_ms,
        **scan_bound(xs, plan.tables, 1, k_prod), library_ms=None,
        ms_anchor_mode=cold_ms, plain_ms_anchor_mode=cold_plain_ms,
        bound_ms_anchor_mode=scan_bound(sxs, splan.tables, 4, k_prod)["bound_ms"],
        ms_count_mode=count_ms,
        ms_entry_mode=entry_ms, plain_ms_entry_mode=entry_plain_ms,
        bound_ms_entry_mode=scan_bound(xs2, splan.tables, 1, k_prod)["bound_ms"],
        ms_pad_mode=pad_ms, plain_ms_pad_mode=pad_plain_ms,
        bound_ms_pad_mode=scan_bound(bxs, bplan.tables, 1, k_prod)["bound_ms"],
        ms_420_chunk=sub_ms, plain_ms_420_chunk_1024_lanes=sub_plain_ms,
        bound_ms_420_chunk=scan_bound(xs420, plan420.tables, 1, k_prod)["bound_ms"],
        **{f"{k}_steps_{b}_{s}": r[k] if k != "ms" else r[k][0]
           for (b, s), r in multi.items()
           for k in ("ms", "plain_ms", "bound_ms", "bound_bytes")},
        plain_lanes_multi_byte=n_mb, plain_device_multi_byte="cpu",
    ))
    def scatter_call(events_t, rows_out, valid):
        """One PyTorch call for events -> dense: a zero fill and one
        index_put_ with the targets, lanes and values prepared outside."""
        e = events_t[valid].to(torch.int64)
        tgt = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63)
        lanes = torch.arange(events_t.shape[1], device=dev) \
            .expand(events_t.shape)[valid]
        keep = tgt < rows_out
        idx = (tgt[keep], lanes[keep])
        vals = ((e & 0xFFF) - 2048).to(torch.int16)[keep]
        out = torch.empty((rows_out, events_t.shape[1]), dtype=torch.int16,
                          device=dev)

        def call():
            out.zero_()
            return out.index_put_(idx, vals)

        return call

    def place_readings(what: str, events_t, rows_out) -> dict:
        """place_events on events_t beside its zero fill alone (a launch
        on no event rows), one index_put_ call (held equal to the kernel)
        and its two bounds; prints them on one line."""
        valid = events_t >= 0
        call = scatter_call(events_t, rows_out, valid)
        got = materialize.place_events(events_t, rows_out)
        check(torch.equal(call(), got), f"index_put_ != place_events {what}")
        n_valid = int(valid.sum())
        by_bytes = bound(nbytes(events_t, got), 8 * events_t.numel())
        r = dict(
            ms=cuda_ms(lambda: materialize.place_events(events_t, rows_out)),
            fill_ms=cuda_ms(
                lambda: materialize.place_events(events_t[:0], rows_out)),
            library_ms=cuda_ms(call), bound_ms=by_bytes["bound_ms"],
            sector_bound_ms=(nbytes(events_t, got) + 64 * n_valid)
            / HBM_BYTES_PER_S * 1e3)
        print(f"phase 7: place_events {what} {list(events_t.shape)} -> "
              f"{list(got.shape)}, {n_valid} valid events: zero fill alone "
              f"{r['fill_ms']:.4f} ms; the kernel with its fill "
              f"{r['ms']:.4f} ms; index_put_ {r['library_ms']:.4f} ms; byte "
              f"bound {r['bound_ms']:.4f}, sector bound "
              f"{r['sector_bound_ms']:.4f} ms [{card}]")
        return r

    M420 = plan420.max_blk * 64
    place420 = place_readings("4:2:0 restart chunk", ev420, M420)
    check(torch.equal(materialize.place_events(ev420, M420),
                      materialize.place_events_plain(ev420, M420)),
          "place_events 4:2:0 kernel != plain")
    # a target past the last row latches its lane and nothing else; the
    # event that packs to 0 (blk 0, z 0, value -2048) is placed
    ev420[:, 1:3] = -1
    ev420[0, 1] = 0
    ev420[-1, 2] = plan420.max_blk << 18 | 2048
    errs420 = [torch.zeros(L420, dtype=torch.bool, device=dev)
               for _ in range(2)]
    got = materialize.place_events(ev420, M420, errs420[0])
    equal_all((got, errs420[0]),
              (materialize.place_events_plain(ev420, M420, errs420[1]),
               errs420[1]), "place_events 4:2:0 with a latch")
    check(int(errs420[0].sum()) == 1 and bool(errs420[0][2])
          and int(got[0, 1]) == -2048, "place_events latch or zero event")
    print(f"phase 7: place_events on the 4:2:0 chunk's events equal, with "
          f"an out-of-range target (latched) and the event that packs to 0 "
          f"too")
    del ev420, got, errs420

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

    place444 = place_readings("restart chunk", ev, M)
    rows.append(dict(
        name="place_events", route="cuda",
        source="tpujpeg_torch/csrc/materialize.cu",
        replaces="tpujpeg/ops/materialize.py:205,314",
        launches=totals["place_events"],
        launches_per_chunk=per_chunk("place_events"), max_abs_err=pe_err,
        ms=place444["ms"],
        plain_ms=cuda_ms(lambda: materialize.place_events_plain(ev, M)),
        **bound(nbytes(ev, got), 8 * ev.numel()),
        library_ms=place444["library_ms"],
        fill_ms=place444["fill_ms"],
        sector_bound_ms=place444["sector_bound_ms"],
        ms_420_chunk=place420["ms"], fill_ms_420_chunk=place420["fill_ms"],
        library_ms_420_chunk=place420["library_ms"],
        bound_ms_420_chunk=place420["bound_ms"],
        sector_bound_ms_420_chunk=place420["sector_bound_ms"],
    ))
    restart_dense = got
    del want

    # the slot kernels on the spec chunk's merged events and on the
    # restart chunk's events (phase 8 runs both chains through slots)
    sev, _ = fsm._spec_sync_merge(
        pending.ev1, pending.anchors, pending.ablk, pending.recm,
        pending.ev2, pending.end2, pending.b1, pending.blk2,
        torch.as_tensor(quotas).to(dev))
    SM = cap_w * 64
    G = materialize.SLOT_G

    def expand_readings(what: str, o2, p, rows_out: int, C: int) -> dict:
        """slot_expand on (o2, p) beside its zero fill alone (a launch on
        no rows), one zero fill + index_put_ call on the same targets
        (held equal to the kernel) and its byte and sector bounds; prints
        them on one line, and on another how far apart in slot groups the
        live lanes of a 32-lane tile lie at one compacted row (what a
        write-once expand from a shared-memory tile would have to hold)."""
        Np_, L_ = o2.shape
        valid = o2 >= 0
        row = torch.arange(Np_, device=dev)[:, None]
        e = p.to(torch.int64)
        grp = (row + o2) >> (C.bit_length() - 1)
        tgt = grp * (64 * G) + ((e >> 18) & (G - 1)) * 64 + ((e >> 12) & 63)
        keep = valid & (tgt < rows_out)
        idx = (tgt[keep],
               torch.arange(L_, device=dev).expand(Np_, L_)[keep])
        vals = ((e & 0xFFF) - 2048).to(torch.int16)[keep]
        del row, e, tgt, keep
        T = L_ // 32 * 32
        g = grp[:, :T].reshape(Np_, -1, 32)
        lv = valid[:, :T].reshape(Np_, -1, 32)
        span = (torch.where(lv, g, -1).amax(dim=2)
                - torch.where(lv, g, torch.iinfo(torch.int64).max).amin(dim=2)
                )[lv.sum(dim=2) >= 2].double()
        q = torch.quantile(span[:: max(1, span.numel() // 1_000_000)],
                           torch.tensor([0.5, 0.9, 0.99], device=dev,
                                        dtype=torch.float64)).tolist()
        print(f"phase 7: slot_expand {what} C={C}: largest minus smallest "
              f"slot group of a 32-lane tile's live lanes at one compacted "
              f"row: median {q[0]:.0f}, p90 {q[1]:.0f}, p99 {q[2]:.0f}, max "
              f"{int(span.max())}")
        del grp, g, lv, span
        out = torch.empty((rows_out, L_), dtype=torch.int16, device=dev)

        def call():
            out.zero_()
            return out.index_put_(idx, vals)

        got = materialize.slot_expand(o2, p, rows_out, C, G)
        check(torch.equal(call(), got), f"index_put_ != slot_expand {what}")
        # o2 read in full, p only on live rows, dense written once; the
        # sector bound adds 32 bytes read and written per live row
        n_live = int(valid.sum())
        moved = nbytes(o2, got) + 4 * n_live
        r = dict(
            ms=cuda_ms(lambda: materialize.slot_expand(o2, p, rows_out, C, G)),
            fill_ms=cuda_ms(lambda: materialize.slot_expand(
                o2[:0], p[:0], rows_out, C, G)),
            library_ms=cuda_ms(call),
            **bound(moved, 8 * o2.numel()),
            sector_bound_ms=(moved + 64 * n_live) / HBM_BYTES_PER_S * 1e3)
        print(f"phase 7: slot_expand {what} C={C} {list(o2.shape)} -> "
              f"{list(got.shape)}, {n_live} live rows: zero fill alone "
              f"{r['fill_ms']:.4f} ms; the kernel with its fill "
              f"{r['ms']:.4f} ms; zero fill + index_put_ "
              f"{r['library_ms']:.4f} ms; byte bound {r['bound_ms']:.4f}, "
              f"sector bound {r['sector_bound_ms']:.4f} ms [{card}]")
        return r

    def unpack_bound(o, o2) -> dict:
        # unpack reads each lane's event prefix (and the row after it)
        n_ev = int((o >= 0).sum())
        L_ = o.shape[1]
        return bound((n_ev + L_) * 6 + nbytes(o2) + L_, 10 * n_ev)

    slot_err = {k: 0 for k in SLOT_KERNELS}
    overflowed = {}
    slot_bound = {}
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
            slot_bound = {
                "compact": bound(nbytes(sev, p, o), 4 * sev.numel()),
                "slot_unpack": unpack_bound(o, o2),
            }
            del dense
            spec_expand = expand_readings("spec chunk", o2, p, SM, C)
            slot_ms = {
                "compact": (cuda_ms(lambda: materialize.compact_to_rank(sev)),
                            cuda_ms(lambda: materialize.compact_to_rank_plain(
                                sev))),
                "slot_unpack": (
                    cuda_ms(lambda: materialize.slot_unpack(p, o, C, G)),
                    cuda_ms(lambda: materialize.slot_unpack_plain(p, o, C, G))),
                "slot_expand": (
                    spec_expand["ms"],
                    cuda_ms(lambda: materialize.slot_expand_plain(
                        o2, p, SM, C, G))),
            }
        del p, o, o2, ovf
    check(overflowed[64] > 0, "capacity 64 did not overflow the spec chunk")
    spec_classic_ms = cuda_ms(lambda: materialize.place_events(sev, SM))
    print(f"phase 7: classic scatter on the same merged events "
          f"{spec_classic_ms:.4f} ms [{card}]")
    # compact_full on the same events: the two entries of one body
    scp = materialize.compact_full(sev)
    cf_spec_err = equal_all((scp,), (materialize.compact_full_plain(sev),),
                            "compact_full spec")
    cf_spec = dict(ms=cuda_ms(lambda: materialize.compact_full(sev)),
                   **bound(nbytes(sev, scp), 4 * sev.numel()))
    del scp, sev

    # the restart chunk's events at the capacity phase 8 runs it (256, or
    # 512 where 256 overflows) and at 64, which overflows
    rp, ro = materialize.compact_to_rank(ev)
    slot_err["compact"] = max(slot_err["compact"], equal_all(
        (rp, ro), materialize.compact_to_rank_plain(ev), "compact restart"))
    rst_compact = dict(ms=cuda_ms(lambda: materialize.compact_to_rank(ev)),
                       **bound(nbytes(ev, rp, ro), 4 * ev.numel()))
    rst_c = None
    for C in (256, 512, 64):
        ro2, rovf = materialize.slot_unpack(rp, ro, C, G)
        slot_err["slot_unpack"] = max(slot_err["slot_unpack"], equal_all(
            (ro2, rovf), materialize.slot_unpack_plain(rp, ro, C, G),
            f"slot_unpack restart C={C}"))
        slot_err["slot_expand"] = max(slot_err["slot_expand"], equal_all(
            (materialize.slot_expand(ro2, rp, M, C, G),),
            (materialize.slot_expand_plain(ro2, rp, M, C, G),),
            f"slot_expand restart C={C}"))
        n_ovf = int(rovf.sum())
        print(f"phase 7: slot route C={C} on the restart chunk's events "
              f"[{ev.shape[0]}, {L}] -> [{M}, {L}]: compact, unpack, expand "
              f"equal; overflow lanes {n_ovf}")
        if C == 64:
            check(n_ovf > 0, "capacity 64 did not overflow the restart chunk")
        elif rst_c is None and (n_ovf == 0 or C == 512):
            rst_c = C
            rst_unpack = dict(
                ms=cuda_ms(lambda: materialize.slot_unpack(rp, ro, C, G)),
                **unpack_bound(ro, ro2))
            rst_expand = expand_readings("restart chunk", ro2, rp, M, C)
        del ro2, rovf
    del rp, ro
    replaces = {"compact": "tpujpeg/ops/materialize.py:205",
                "slot_unpack": "tpujpeg/ops/materialize.py:728",
                "slot_expand": "tpujpeg/ops/materialize.py:773"}
    extra = {
        "compact": dict(ms_restart_chunk=rst_compact["ms"],
                        bound_ms_restart_chunk=rst_compact["bound_ms"]),
        "slot_unpack": dict(ms_restart_chunk=rst_unpack["ms"],
                            bound_ms_restart_chunk=rst_unpack["bound_ms"],
                            c_restart_chunk=rst_c),
        "slot_expand": dict(
            fill_ms=spec_expand["fill_ms"],
            sector_bound_ms=spec_expand["sector_bound_ms"],
            ms_restart_chunk=rst_expand["ms"],
            fill_ms_restart_chunk=rst_expand["fill_ms"],
            library_ms_restart_chunk=rst_expand["library_ms"],
            bound_ms_restart_chunk=rst_expand["bound_ms"],
            sector_bound_ms_restart_chunk=rst_expand["sector_bound_ms"],
            c_restart_chunk=rst_c),
    }
    for k in SLOT_KERNELS:
        if k == "slot_expand":
            kb = {b: spec_expand[b] for b in ("bound_ms", "bound_by",
                                              "bound_bytes", "bound_ops")}
        else:
            kb = slot_bound[k]
        rows.append(dict(
            name=k, route="cuda", source="tpujpeg_torch/csrc/slots.cu",
            replaces=replaces[k], launches=totals[k],
            launches_per_chunk=per_chunk(k),
            max_abs_err=slot_err[k], ms=slot_ms[k][0],
            plain_ms=slot_ms[k][1], **kb,
            library_ms=spec_expand["library_ms"] if k == "slot_expand"
            else None,
            **extra[k],
        ))

    # the two other routes' kernels on the mixed chunk's events
    BM = bplan.max_blk * 64
    BN = mev.shape[0]
    p0, o0 = materialize.compact_to_rank(mev, rank_kernel=False,
                                         stop_after="init")
    cpo = materialize.compact_offsets(p0, o0)
    co_err = equal_all(cpo, materialize.compact_offsets_plain(p0, o0),
                       "compact_offsets")
    check(all(torch.equal(a, b) for a, b in
              zip(cpo, materialize.compact_to_rank(mev))),
          "compact_offsets != compact")
    cpf = materialize.compact_full(mev)
    cf_err = equal_all((cpf,), (materialize.compact_full_plain(mev),),
                       "compact_full")
    errs = [torch.zeros(BL, dtype=torch.bool, device=dev) for _ in range(4)]
    d_full = materialize.spread_full(cpf, BM, err_mal=errs[0])
    sf_err = equal_all(
        (d_full, errs[0]),
        (materialize.spread_full_plain(cpf, BM, err_mal=errs[1]), errs[1]),
        "spread_full")
    d_rank = materialize.spread_full(cpo[0], BM, o=cpo[1], err_mal=errs[2])
    sf_err = max(sf_err, equal_all(
        (d_rank, errs[2]),
        (materialize.spread_full_plain(cpo[0], BM, o=cpo[1],
                                       err_mal=errs[3]), errs[3]),
        "spread_full with offsets"))
    d_scatter = materialize.place_events(mev, BM)
    check(torch.equal(d_full, d_scatter) and torch.equal(d_rank, d_scatter),
          "the three routes' dense tensors differ")
    print(f"phase 7: compact_offsets, compact_full, spread_full on the "
          f"mixed chunk's events [{BN}, {BL}] -> [{BM}, {BL}] equal; the "
          f"three routes' dense tensors equal")
    lib_call = scatter_call(cpf, BM, cpf >= 0)
    check(torch.equal(lib_call(), d_full), "index_put_ != spread_full")
    spread_lib_ms = cuda_ms(lib_call)

    def offsets_bytes(o, *outs) -> int:
        """The bytes a function of an offsets pair (p, o) must move: o
        read whole, p only where o >= 0 (a row with o < 0 is neither
        stored nor latched, so its p is not needed), each output written
        once."""
        return nbytes(o, *outs) + 4 * int((o >= 0).sum())

    def sectors_ms(moved: int, n_stored: int) -> float:
        """The sector bound of a scatter, as place_events': its bytes
        plus 32 bytes read and written per stored event."""
        return (moved + 64 * n_stored) / HBM_BYTES_PER_S * 1e3

    n_mixed = int((mev >= 0).sum())
    spread_sectors = sectors_ms(nbytes(cpf, d_full), n_mixed)
    spread_o_ms = cuda_ms(
        lambda: materialize.spread_full(cpo[0], BM, o=cpo[1]))
    spread_o_bytes = offsets_bytes(cpo[1], d_rank)
    spread_o_sectors = sectors_ms(spread_o_bytes, n_mixed)
    del lib_call, d_rank, d_scatter, errs
    init_ms = cuda_ms(lambda: materialize.compact_to_rank(
        mev, rank_kernel=False, stop_after="init"))
    route_rows = [
        ("compact_offsets", "tpujpeg/ops/materialize.py:271", co_err,
         lambda: materialize.compact_offsets(p0, o0),
         lambda: materialize.compact_offsets_plain(p0, o0),
         bound(offsets_bytes(o0, *cpo), 4 * p0.numel()), None, {}),
        ("compact_full", "tpujpeg/ops/materialize.py:102",
         max(cf_err, cf_spec_err),
         lambda: materialize.compact_full(mev),
         lambda: materialize.compact_full_plain(mev),
         bound(nbytes(mev, cpf), 4 * mev.numel()), None,
         dict(ms_spec_chunk=cf_spec["ms"],
              bound_ms_spec_chunk=cf_spec["bound_ms"])),
        ("spread_full", "tpujpeg/ops/materialize.py:130", sf_err,
         lambda: materialize.spread_full(cpf, BM),
         lambda: materialize.spread_full_plain(cpf, BM),
         bound(nbytes(cpf, d_full), 8 * cpf.numel()), spread_lib_ms,
         dict(sector_bound_ms=spread_sectors, ms_with_offsets=spread_o_ms,
              bound_ms_with_offsets=spread_o_bytes / HBM_BYTES_PER_S * 1e3,
              sector_bound_ms_with_offsets=spread_o_sectors)),
    ]
    for name, replaces_at, err, fn, plain_fn, bnd, lib_ms, more in route_rows:
        rows.append(dict(
            name=name, route="cuda", source="tpujpeg_torch/csrc/routes.cu",
            replaces=replaces_at, launches=totals[name],
            launches_per_chunk=per_chunk(name), max_abs_err=err,
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain_fn), **bnd,
            library_ms=lib_ms, **more,
        ))
    # the three entries of csrc/compact.cuh on each input they were timed
    # on, beside their byte bounds (no memset: each element written once)
    by_name = {r["name"]: r for r in rows}
    readings = [
        ("compact", "spec", by_name["compact"]["ms"],
         by_name["compact"]["bound_ms"]),
        ("compact", "restart", rst_compact["ms"], rst_compact["bound_ms"]),
        ("compact_full", "spec", cf_spec["ms"], cf_spec["bound_ms"]),
        ("compact_full", "mixed", by_name["compact_full"]["ms"],
         by_name["compact_full"]["bound_ms"]),
        ("compact_offsets", "mixed", by_name["compact_offsets"]["ms"],
         by_name["compact_offsets"]["bound_ms"]),
    ]
    print("phase 7: compact.cuh (ms, byte bound ms, share): " + "; ".join(
        f"{k} on the {c} chunk's events {ms:.4f}, {b:.4f}, {b / ms:.3f}"
        for k, c, ms, b in readings) + f" [{card}]")
    sf = by_name["spread_full"]
    print(f"phase 7: place.cuh on the mixed chunk (ms, byte bound ms, "
          f"sector bound ms): spread_full {sf['ms']:.4f}, "
          f"{sf['bound_ms']:.4f}, {spread_sectors:.4f}; "
          f"with offsets {spread_o_ms:.4f}, "
          f"{sf['bound_ms_with_offsets']:.4f}, {spread_o_sectors:.4f}; "
          f"index_put_ {spread_lib_ms:.4f} [{card}]")
    route_ms = {r: cuda_ms(lambda: fsm.materialize_events(mev, BM, r))
                for r in ROUTE_KERNELS}
    compact_mixed_ms = cuda_ms(lambda: materialize.compact_to_rank(mev))
    print(f"phase 7: materialize on the mixed chunk by route: "
          + ", ".join(f"{r} {t:.4f} ms" for r, t in route_ms.items())
          + f"; ranked = cumsum init {init_ms:.4f} + compact_offsets + "
          f"spread_full with offsets {spread_o_ms:.4f}; compact on the "
          f"same events {compact_mixed_ms:.4f} ms [{card}]")
    # the probe kernels: the three stage probes on the mixed chunk's
    # offsets, the lookups at the tools' shapes
    W = probes.FINE_W
    fine = probes.compact_fine(p0, o0, W)
    fine_err = equal_all(fine, probes.compact_fine_plain(p0, o0, W),
                         "compact_fine")
    check(not torch.equal(fine[1], cpo[1]) and bool(
        ((fine[1].to(torch.int32) & (W - 1))[fine[1] >= 0] == 0).all()),
        "compact_fine left low offset bits or did the whole compact")
    # the walk on offsets that are not the column cumsum's: the residual
    # multiples of W that compact_fine leaves
    rest = materialize.compact_offsets(*fine)
    equal_all(rest, materialize.compact_offsets_plain(*fine),
              "compact_offsets on compact_fine's offsets")
    check(all(torch.equal(a, b) for a, b in zip(rest, cpo)),
          "compact_offsets after compact_fine != one full compact_offsets")
    del rest
    staged = probes.compact_staged(p0, o0, W)
    staged_err = equal_all(staged, probes.compact_staged_plain(p0, o0, W),
                           "compact_staged")
    check(all(torch.equal(a, b) for a, b in zip(staged, cpo)),
          "compact_staged != one full compact_offsets")
    d_probe = probes.spread_ranked(*staged, BM)
    spread_err = equal_all((d_probe,),
                           (probes.spread_ranked_plain(*staged, BM),),
                           "spread_ranked")
    check(torch.equal(d_probe, d_full), "spread_ranked != spread_full")
    lib_call = scatter_call(staged[0], BM, staged[1] >= 0)
    check(torch.equal(lib_call(), d_probe), "index_put_ != spread_ranked")
    ranked_lib_ms = cuda_ms(lib_call)
    del lib_call
    print(f"phase 7: compact_fine (window {W}), compact_staged, "
          f"spread_ranked on the mixed chunk's offsets [{BN}, {BL}] equal "
          f"to their plain versions; staged == one full compact")
    offs_bound = bound(offsets_bytes(o0, *cpo), 4 * p0.numel())
    # a scatter of (p, o) stores 4 bytes into p and 2 into o per event,
    # each a lone 32-byte sector read and written back: 2 x 64 bytes
    offs_sectors = (offs_bound["bound_bytes"] + 2 * 64 * n_mixed) \
        / HBM_BYTES_PER_S * 1e3
    # the masked walk's lanes behind its window store directly
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    materialize.compact_offsets(p0, o0, mask=W - 1, direct=direct)
    fine_direct = int(direct[0]) / n_mixed
    # the PyTorch yardstick: fills and two index_put_ (staged == whole)
    fine_call = bench_torch_materialize.compact_index_put_call(p0, o0, W - 1)
    whole_call = bench_torch_materialize.compact_index_put_call(p0, o0)
    for call, want, what in ((fine_call, fine, "compact_fine"),
                             (whole_call, cpo, "compact_offsets")):
        check(all(torch.equal(a, b) for a, b in zip(call(), want)),
              f"fills + index_put_ != {what}")
    fine_lib_ms, whole_lib_ms = cuda_ms(fine_call), cuda_ms(whole_call)
    del fine_call, whole_call
    by_name["compact_offsets"]["library_ms"] = whole_lib_ms
    probe_rows = [
        ("compact_fine", "tools/bench_materialize2.py:141", fine_err,
         lambda: probes.compact_fine(p0, o0, W),
         lambda: probes.compact_fine_plain(p0, o0, W), offs_bound,
         fine_lib_ms, dict(sector_bound_ms=offs_sectors,
                           direct_store_share=fine_direct),
         "tpujpeg_torch/csrc/compact.cuh"),
        ("compact_staged", "tools/bench_materialize2.py:98", staged_err,
         lambda: probes.compact_staged(p0, o0, W),
         lambda: probes.compact_staged_plain(p0, o0, W), offs_bound,
         whole_lib_ms, dict(sector_bound_ms=offs_sectors),
         "tpujpeg_torch/csrc/compact.cuh"),
        ("spread_ranked", "tools/bench_materialize2.py:172", spread_err,
         lambda: probes.spread_ranked(*staged, BM),
         lambda: probes.spread_ranked_plain(*staged, BM),
         bound(offsets_bytes(staged[1], d_probe), 8 * p0.numel()),
         ranked_lib_ms, None, "tpujpeg_torch/csrc/routes.cu"),
    ]
    ranked_sectors = sectors_ms(offsets_bytes(staged[1], d_probe), n_mixed)
    for name, replaces_at, err, fn, plain_fn, bnd, lib_ms, more, src \
            in probe_rows:
        rows.append(dict(
            name=name, route="cuda", source=src,
            replaces=replaces_at, launches=totals[name],
            launches_per_chunk=per_chunk(name), max_abs_err=err,
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain_fn), **bnd,
            library_ms=lib_ms,
            **(more or dict(sector_bound_ms=ranked_sectors)),
        ))
    by_name = {r["name"]: r for r in rows}
    print("phase 7: the two outputs' masked compaction on the mixed "
          f"chunk's offsets (ms; byte bound {offs_bound['bound_ms']:.4f} "
          f"ms, sector bound {offs_sectors:.4f} ms counting 2 x 64 bytes "
          f"for each of {n_mixed} events): "
          + "; ".join(f"{k} {by_name[k]['ms']:.4f}, share "
                      f"{by_name[k]['bound_ms'] / by_name[k]['ms']:.3f}, "
                      f"fills + index_put_ {by_name[k]['library_ms']:.4f}"
                      for k in ("compact_fine", "compact_staged",
                                "compact_offsets"))
          + f"; the masked walk (window {W}) stores {int(direct[0])} "
          f"events directly, a share of {fine_direct:.4f} [{card}]")
    del fine, staged, d_probe, direct

    # the two gathers at the tool's shape and past L2 (device ms from a
    # CUDA graph, call ms, host us; tools/bench_torch_gather.py): ms,
    # plain_ms, library_ms and the bound are the shape past L2's
    gathers = bench_torch_gather.gather_readings(dev)
    for name, replaces_at in (("gather_rows", "tools/bench_gather.py:115"),
                              ("gather_table", "tools/bench_gather.py:137")):
        big, small = gathers[name, "bytes"], gathers[name, "tool"]
        rows.append(dict(
            name=name, route="cuda", source="tpujpeg_torch/csrc/probes.cu",
            replaces=replaces_at, launches=totals[name],
            launches_per_chunk=per_chunk(name),
            max_abs_err=max(big["max_abs_err"], small["max_abs_err"]),
            ms=big["kernel"]["device_ms"], plain_ms=big["plain_device_ms"],
            **bound(big["bytes"], big["lookups"]),
            library_ms=big["library"]["device_ms"],
            **{f"{k}_{part}": r[part][k] for k in ("call_ms", "host_us")
               for part, r in (("kernel", big), ("library", big))},
            shape=big["shape"], tool_shape=small["shape"],
            **{f"tool_shape_{k}_{part}": small[part][k]
               for k in ("device_ms", "call_ms", "host_us")
               for part in ("kernel", "library")},
            tool_shape_plain_ms=small["plain_device_ms"],
        ))
        for shape_name, r in (("tool", small), ("past L2", big)):
            k, lib = r["kernel"], r["library"]
            print(f"phase 7: {name} {r['shape']} ({shape_name}): equal to "
                  f"the plain version"
                  + (f" and on index views {r['offset_views_equal']} bytes "
                     f"into their storage" if r["offset_views_equal"] else "")
                  + f"; kernel device {k['device_ms']:.4f} ms, call "
                  f"{k['call_ms']:.4f} ms, host {k['host_us']:.2f} us; "
                  f"PyTorch call device {lib['device_ms']:.4f} ms, call "
                  f"{lib['call_ms']:.4f} ms, host {lib['host_us']:.2f} us; "
                  f"plain device {r['plain_device_ms']:.4f} ms; "
                  f"{r['bytes']} bytes, bound {r['bound_ms']:.4f} ms"
                  + (f", share {r['bound_ms'] / k['device_ms']:.3f}"
                     if r is big else "") + f" [{card}]")
    rng = np.random.default_rng(0)
    n_short, n_long = 4096, 65536
    # the tool's table (T 4,096: the step masks) and one of 4,093 entries
    # (the step multiplies by the reciprocal)
    c_tabs = {T: torch.as_tensor(
        rng.integers(0, T, (T, 1)).astype(np.int32)).to(dev)
        for T in (4096, 4093)}
    c_t = c_tabs[4096]
    c_seed = torch.tensor([3], dtype=torch.int32, device=dev)
    _, chain_plain_ms = timed_once(
        lambda: probes.chain_plain(c_t, c_seed, n_short))
    chain_err = 0
    for T, tab in c_tabs.items():
        want = (probes.chain_plain(tab, c_seed, n_short),
                probes.chain_plain(tab, c_seed, n_long),
                probes.chain_plain(tab, c_seed, 0))
        for source in probes.CHAIN_SOURCES:
            chain_err = max(chain_err, equal_all(
                tuple(probes.chain(tab, c_seed, n, source)
                      for n in (n_short, n_long, 0)),
                want, f"chain T={T} from {source}"))
    # device ns per step from a CUDA graph, beside the latency floor (the
    # walk with the step taken out); outside the counted runs
    chain_r = bench_torch_gather.chain_readings(dev)
    chain_ms = {k: v[f"ns_{n_short}"] * n_short / 1e6
                for k, v in chain_r.items()}
    rows.append(dict(
        name="chain", route="cuda", source="tpujpeg_torch/csrc/probes.cu",
        replaces="tools/bench_gather.py:163", launches=totals["chain"],
        launches_per_chunk=per_chunk("chain"), max_abs_err=chain_err,
        ms=chain_ms["l2"], plain_ms=chain_plain_ms,
        # its bytes and operations bound it far below the latency that
        # sets its time: the latency floor (floor_ms) is its bound
        **bound(nbytes(c_t, c_seed) + 4, 4 * n_short), library_ms=None,
        floor_ms=chain_r["l2"][f"floor_ns_{n_short}"] * n_short / 1e6,
        ms_shared=chain_ms["shared"], ms_readonly=chain_ms["readonly"],
        device_ns_per_step=chain_r,
    ))
    bench_torch_gather.print_chain_readings(card, chain_r)
    print(f"phase 7: chain equal to its plain version on every source at "
          f"T 4,096 (mask) and 4,093 (reciprocal), 0, {n_short} and "
          f"{n_long} steps; the restart scan takes "
          f"{scan_ms / (stride + 6) * 1e3:.1f} us per byte column of "
          f"{k_prod} symbol steps at {L} lanes and "
          f"{sub_ms / (stride420 + 6) * 1e3:.1f} us at {L420} lanes [{card}]")
    del p0, o0, cpo, cpf

    # the pixel kernel on the restart chunk: its dense lane matrix read in
    # place (the engine's input), and the same coefficients as [B,
    # n_blocks, 64] (the speculative, Jacobi and host routes' layout);
    # and on the mixed chunk's bucket-raster lane matrix with its padded
    # rows and the DC masked outside each image's extent in the kernel
    # (the bucketed chain's input); each in both colour modes
    geom = Geometry.of(imgs[0])
    quant = quant_of(imgs)
    mquant = quant_of(mimgs)
    per_lane = restart_dense.T.reshape(L, plan.max_blk, 64)
    dc_lane = fsm._dc_cumsum(per_lane[:, :, 0], plan.tables, plan.max_blk)
    bdc_lane = fsm._dc_cumsum(d_full.T.reshape(BL, bplan.max_blk, 64)[:, :, 0],
                              bplan.tables, bplan.max_blk)
    bext = torch.as_tensor(bplan.extents.astype(np.int32)).to(dev)
    px_inputs = {
        "lane matrix": (geom, restart_dense, fused.restart_lanes(
            plan.layout, L, CHUNK, geom.mcus_y, geom.mcus_x, dev),
            quant, dc_lane, None),
        "blocks": (geom, fused._assemble_rows(per_lane, plan.layout, CHUNK),
                   pixels.block_lanes(CHUNK, geom.mcus_y, geom.mcus_x, dev),
                   quant, fused._assemble_rows(dc_lane, plan.layout, CHUNK),
                   None),
        "bucket lane matrix": (bucket, d_full, fused.bucket_lanes(
            BL, CHUNK, bplan.lanes_per_img, bplan.k, bucket.mcus_y,
            bucket.mcus_x, dev), mquant, bdc_lane, bext),
    }
    px_err = 0
    px = {}
    for layout, (g, c_in, lanes_in, q_in, dc_in, ext_in) \
            in px_inputs.items():
        for exact in (True, False):
            args = (g, c_in, lanes_in, q_in, dc_in, ext_in, exact)
            got = pixels.rgb_444(*args)
            px_err = max(px_err, equal_all(
                got, pixels.rgb_444_plain(*args),
                f"pixels {layout} exact={exact}"))
            # ~1,200 32-bit operations per 8x8 block (dequant, two IDCT
            # passes, f32 colour and flags); exact colour adds ~12 f64
            # operations per pixel at half the 32-bit rate
            n_px = CHUNK * 64 * g.n_mcus
            ops = 1200 * 3 * CHUNK * g.n_mcus + (24 * n_px if exact else 0)
            px[layout, exact] = dict(
                ms=cuda_ms(lambda: pixels.rgb_444(*args)),
                plain_ms=cuda_ms(lambda: pixels.rgb_444_plain(*args), reps=3),
                **bound(nbytes(c_in, q_in, dc_in, lanes_in.table, ext_in,
                               *got), ops))
            r = px[layout, exact]
            print(f"phase 7: pixels from the {layout} {list(c_in.shape)} "
                  f"to {g.width}x{g.height}, exact={exact}: equal to the "
                  f"plain version in every bit; "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"{r['bound_bytes']} bytes, bound {r['bound_ms']:.4f} ms "
                  f"by {r['bound_by']}, share "
                  f"{r['bound_ms'] / r['ms']:.3f} [{card}]")
            del got
    main_px = px["lane matrix", True]
    short = {"lane matrix": "lanes", "blocks": "blocks",
             "bucket lane matrix": "bucket"}
    rows.append(dict(
        name="pixels", route="cuda", source="tpujpeg_torch/csrc/pixels.cu",
        replaces="tpujpeg/ops/pixels_pallas.py:84",
        launches=totals["pixels"], launches_per_chunk=per_chunk("pixels"),
        max_abs_err=px_err, ms=main_px["ms"], plain_ms=main_px["plain_ms"],
        **{k: main_px[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                   "bound_ops")},
        library_ms=None,
        **{f"{k}_{short[lay]}_{'exact' if ex else 'f32'}": v
           for (lay, ex), r in px.items() for k, v in r.items()
           if k in ("ms", "plain_ms", "bound_ms")},
    ))
    del px_inputs, d_full, bdc_lane
    # the segment decoder on each chunk's segment plan (phase 6g), one
    # launch a chunk at the main path's shape (32 lanes a block on the
    # restart chunk, 1 on the spec chunk): its output against the host
    # reference decoder's coefficients, image by image, and against the
    # plain version on the host CPU (one vector op a step pays a launch on
    # the card) on a slice of its lanes: the restart chunk's first 1,024,
    # the spec chunk's shallowest lane whole; the deepest lane's symbol
    # steps, counted on the host from the decoded coefficients, beside the
    # kernel and its latency floor (those steps x the chain probe's
    # shared-memory floor a dependent step)
    shared_floor_ns = chain_r["shared"][
        f"floor_ns_{bench_torch_gather.CHAIN_LONG}"]
    seg_rows = {}
    seg_err = 0
    for name, ref_coef, geom in (("restart", rcoef, rgeom),
                                 ("spec", pcoef, Geometry.of(pimgs[0]))):
        gplan, gup, k_ms = gather_kernel[name]
        coeffs, gerr = entropy.decode_plan(gplan, dev, uploaded=gup)
        check(not bool(gerr.any()), f"decode_segments {name}: lanes failed")
        nnz = int((coeffs[:, 1:] != 0).sum())
        n_lanes = gplan.seg_n_blocks.shape[0]
        ctab, roff = entropy.device_segment_tables(
            entropy.device_luts(gplan.luts, dev))
        nbytes_seg = (gplan.scan.nbytes + 12 * n_lanes + gplan.rows.nbytes
                      + (ctab.numel() + roff.numel()) * 4
                      + gplan.pattern.nbytes + coeffs.numel() * 4 + n_lanes)
        fill_ms = cuda_times(lambda: torch.zeros(
            (gplan.n_blocks_total, 64), dtype=torch.int32, device=dev))
        host_c = coeffs.cpu().numpy()
        host_err = gerr.cpu()
        del coeffs, gerr
        per_img = host_c.reshape(-1, geom.n_blocks, 64)
        for i in range(per_img.shape[0]):
            check(np.array_equal(per_img[i], ref_coef[i % 16]),
                  f"decode_segments {name} chunk image {i} differs from "
                  f"{host.backend_name()}")
        lane_steps = segment_steps(host_c, gplan)
        # the plain version on a slice of the launch's lanes [lo, hi), its
        # blocks re-based to 0
        if name == "restart":
            lo, hi = 0, 1024
        else:
            lo = int(np.flatnonzero(gplan.seg_n_blocks > 0)[
                lane_steps.argmin()])
            hi = lo + 1
        b0 = int(gplan.seg_block_base[lo])
        b1 = b0 + int(gplan.seg_n_blocks[lo:hi].sum())
        cpu_in = [a.cpu() for a in gup]
        cpu_in[1:5] = [a[lo:hi] for a in cpu_in[1:5]]
        cpu_in[2] = cpu_in[2] - b0
        t0 = time.perf_counter()
        want = entropy.decode_segments_plain(
            *cpu_in[:5], torch.as_tensor(gplan.luts), cpu_in[5],
            cap=gplan.cap, n_blocks_total=b1 - b0)
        plain_s = time.perf_counter() - t0
        seg_err = max(seg_err, equal_all(
            (torch.as_tensor(host_c[b0:b1]), host_err[lo:hi]), want,
            f"decode_segments {name} lanes {lo}..{hi - 1}"))
        check(int((want[0] != 0).sum()) > 0, "decode_segments: no output")
        del host_c, per_img, want, cpu_in
        deep = int(lane_steps.max())
        floor_ms = deep * shared_floor_ns / 1e6
        # ~40 32-bit operations a symbol: every nonzero AC coefficient is
        # one, each block a DC and at most one EOB
        seg_rows[name] = dict(
            ms=k_ms, nnz=nnz, fill_ms=fill_ms, deepest_steps=deep,
            plain_lanes=(lo, hi), plain_s=plain_s,
            mean_steps=float(lane_steps.mean()),
            ns_per_step=(k_ms[0] - fill_ms[0]) / deep * 1e6,
            latency_floor_ms=floor_ms,
            **bound(nbytes_seg, 40 * (nnz + 2 * gplan.n_blocks_total)))
    for name, r in seg_rows.items():
        ms, lo, hi = r["ms"]
        a, b = r["plain_lanes"]
        held = (f"; on lanes {a}..{b - 1} to the plain version on the host "
                f"CPU, {r['plain_s']:.1f} s")
        print(f"phase 7: decode_segments on the {name} chunk's segment plan "
              f"(equal to {host.backend_name()} on every image{held}; "
              f"{r['nnz']} nonzero AC coefficients): {ms:.4f} ms (min "
              f"{lo:.4f}, max {hi:.4f}) with its zero fill (the fill alone "
              f"{r['fill_ms'][0]:.4f} ms, min {r['fill_ms'][1]:.4f}, max "
              f"{r['fill_ms'][2]:.4f}), {r['bound_bytes']} bytes, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, share "
              f"{r['bound_ms'] / ms:.4f}; deepest lane {r['deepest_steps']} "
              f"symbol steps (mean {r['mean_steps']:.1f}), "
              f"{r['ns_per_step']:.2f} ns a deepest-lane step (kernel less "
              f"fill); latency floor {r['deepest_steps']} x "
              f"{shared_floor_ns:.2f} ns = {r['latency_floor_ms']:.4f} ms, "
              f"share floor / kernel {r['latency_floor_ms'] / ms:.4f} "
              f"[{card}]")
    main_seg, spec_seg = seg_rows["restart"], seg_rows["spec"]
    rows.append(dict(
        name="decode_segments", route="cuda",
        source="tpujpeg_torch/csrc/segments.cu",
        replaces="tpujpeg/ops/entropy.py:315",
        launches=totals["decode_segments"],
        launches_per_chunk=per_chunk("decode_segments"),
        max_abs_err=seg_err, ms=main_seg["ms"][0],
        plain_ms=main_seg["plain_s"] * 1e3,
        **{k: main_seg[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                    "bound_ops")},
        library_ms=None, plain_lanes=1024, plain_device="cpu",
        plain_lanes_spec_chunk=1,
        plain_ms_spec_chunk=spec_seg["plain_s"] * 1e3,
        **{f"{k}_{n}": r[k] for n, r in seg_rows.items()
           for k in ("deepest_steps", "mean_steps", "ns_per_step",
                     "latency_floor_ms")},
        fill_ms=main_seg["fill_ms"][0],
        ms_spec_chunk=spec_seg["ms"][0], fill_ms_spec_chunk=spec_seg[
            "fill_ms"][0],
        bound_ms_spec_chunk=spec_seg["bound_ms"],
    ))
    del gather_kernel
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"phase 7: {r['name']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bound_bytes']} bytes; share "
              f"{r['bound_ms'] / r['ms']:.3f}), plain {r['plain_ms']:.4f} "
              f"ms, one PyTorch call {lib} ms; launches per chunk "
              f"{json.dumps(r['launches_per_chunk'])} [{card}]")
    scan = rows[0]
    print(f"phase 7: fsm_scan anchor mode {cold_ms:.4f} ms (bound "
          f"{scan['bound_ms_anchor_mode']:.4f}, plain {cold_plain_ms:.4f}), "
          f"speculative entry {entry_ms:.4f} ms (bound "
          f"{scan['bound_ms_entry_mode']:.4f}, plain {entry_plain_ms:.4f}), "
          f"pad_info {pad_ms:.4f} ms (bound "
          f"{scan['bound_ms_pad_mode']:.4f}, plain {pad_plain_ms:.4f}), "
          f"4:2:0 restart chunk {sub_ms:.4f} ms (bound "
          f"{scan['bound_ms_420_chunk']:.4f}, plain on 1024 lanes "
          f"{sub_plain_ms:.4f}) [{card}]")
    del events, ev, per_lane, dc_lane, restart_dense
    torch.cuda.empty_cache()

    # ---- phase 7b: exact colour over every triple of [-256, 255]^3
    t0 = time.perf_counter()
    bad_kernel, bad_torch = pixels.exact_colour_mismatches(dev)
    check(bad_kernel == 0 and bad_torch == 0,
          f"exact colour: {bad_kernel} kernel and {bad_torch} color_exact "
          f"triples differ from the oracle")
    print(f"phase 7b: exact colour of all {512 ** 3} triples of "
          f"[-256, 255]^3 on the card equals the oracle's "
          f"ycbcr_to_rgb_exact: the pixel kernel's exact mode and "
          f"color_exact (float64) 0 mismatches "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 8: throughput
    # (each decoder is warm: its phase decoded the same chunk once)
    e2e = [("restart", dec, datas), ("spec", sdec, pdatas),
           ("bucketed scatter", mdecs["scatter"], mdatas)]
    e2e += [(f"4:2:0 {name} fancy={fancy}", d, sub[name][1])
            for (name, fancy), d in decs420.items()]
    for name, d, data in e2e:
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            d.decode(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t = min(times)
        mb = d.stats.compressed_bytes / 1e6
        print(f"phase 8: {name} chunk end to end (parse, plan, upload, "
              f"device, fetch) {CHUNK} images in "
              f"{times[0] * 1e3:.1f} and {times[1] * 1e3:.1f} ms (two warm "
              f"runs); the faster: {CHUNK / t:.1f} images/s, {mb / t:.2f} "
              f"compressed MB/s, backend {d.stats.backend} [{card}]")
    for d in [x[1] for x in e2e] + list(mdecs.values()):
        d.close()

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

    # the chains as the strict engine runs them: exact colour, no
    # coefficients kept
    def spec_chain(slots):
        p = fsm.spec_sync_start(pimgs, plan=splan, xs_dev=sxs)
        return fused.decode_spec_sync_fused(p, sgeom, squant, CHUNK, CHUNK,
                                            slots=slots, want_coeffs=False,
                                            exact=True)

    def restart_chain(slots):
        return fused.decode_chunk_fused(plan, quant, geom, CHUNK,
                                        uploaded=(xs, sn), slots=slots,
                                        want_coeffs=False, exact=True)

    spec_stages = "cold + stitch scan, resolve read, merge, materialize, " \
        "gather + DC, pixels"
    rst_stages = "scan, materialize, DC, pixels from the lane matrix"
    chains = [
        ("spec", spec_chain, c_spec, pdatas, spec_stages),
        ("spec", spec_chain, False, pdatas, spec_stages),
        ("restart", restart_chain, c_rst, datas, rst_stages),
        ("restart", restart_chain, False, datas, rst_stages),
    ]
    for name, fn, slots, data, stages in chains:
        check(not bool(fn(slots)[-1].any()), f"{name}: slot overflow")
        ms, lo, hi = cuda_times(lambda: fn(slots))
        mb = sum(len(x) for x in data) / 1e6
        print(f"phase 8: device chain {name} slots={slots} (plan and bytes "
              f"resident; {stages}) {ms:.2f} ms (min {lo:.2f}, max "
              f"{hi:.2f}): "
              f"{CHUNK / ms * 1e3:.1f} images/s, "
              f"{mb / ms * 1e3:.2f} compressed MB/s [{card}]")

    # the restart chain cut after each stage (decode_chunk_fused's
    # stop_after): cumulative times, then the whole chain
    def cut(stop, want_coeffs=False):
        return fused.decode_chunk_fused(plan, quant, geom, CHUNK,
                                        uploaded=(xs, sn), exact=True,
                                        want_coeffs=want_coeffs,
                                        stop_after=stop)

    check(torch.equal(cut("scan")[0], fused._sum32(
        fsm.fsm_scan(xs, sn, plan.tables)[0])), "scan cut checksum")
    check(torch.equal(cut("assemble")[0], fused._sum32(
        *cut(None, want_coeffs=True)[2:4])), "assemble cut checksum")
    cuts = {stop: cuda_times(lambda: cut(stop))
            for stop in fused.STOPS + (None,)}
    # each cut's checksum alone, on that stage's output
    ev8 = fsm.fsm_scan(xs, sn, plan.tables)[0]
    dense8 = fsm.materialize_checked(
        ev8.reshape(-1, ev8.shape[-1]), plan.max_blk * 64,
        torch.zeros(ev8.shape[-1], dtype=torch.bool, device=dev))[0]
    asm8 = cut(None, want_coeffs=True)[2:4]
    sums = {"scan": cuda_times(lambda: fused._sum32(ev8)),
            "materialize": cuda_times(lambda: fused._sum32(dense8)),
            "assemble": cuda_times(lambda: fused._sum32(*asm8))}
    del ev8, dense8, asm8
    print("phase 8: restart chain cut after each stage (decode_chunk_fused "
          "stop_after; cumulative, plan and bytes resident, exact colour; "
          "the cut's checksum alone in brackets): "
          + "; ".join(f"{stop or 'whole chain'} {ms:.3f} ms (min {lo:.3f}, "
                      f"max {hi:.3f})" + (f" [checksum {sums[stop][0]:.3f}]"
                                          if stop else "")
                      for stop, (ms, lo, hi) in cuts.items())
          + f" [{card}]")

    mb = sum(len(x) for x in mdatas) / 1e6
    for route in ROUTE_KERNELS:
        def bucket_chain():
            return fused.decode_chunk_bucketed(
                bplan, mquant, bucket, CHUNK, uploaded=bup, route=route,
                want_coeffs=False, exact=True)

        out = bucket_chain()
        check(not bool(out[4].any() | out[5].any()),
              f"bucketed {route}: latched lanes")
        del out
        ms, lo, hi = cuda_times(bucket_chain)
        print(f"phase 8: device chain bucketed route={route} (plan and "
              f"bytes resident; pad scan, materialize, DC, pixels from the "
              f"lane matrix at {bucket.width}x{bucket.height}, DC masked "
              f"there) {ms:.2f} ms (min {lo:.2f}, max {hi:.2f}): "
              f"{CHUNK / ms * 1e3:.1f} "
              f"images/s, {mb / ms * 1e3:.2f} compressed MB/s [{card}]")

    # the 4:2:0 chunks' device chains (plans and bytes resident)
    simgs420 = sub["spec"][2]
    splan420 = fsm.build_spec_plan_batch(simgs420, 1024)
    sxs420 = torch.as_tensor(splan420.xs).to(dev)
    jplan420 = fsm.build_spec_plan_batch(simgs420, 2048)
    jxs420 = torch.as_tensor(jplan420.xs).to(dev)
    squant420 = quant_of(simgs420)
    mixed_parts = []
    for b, ims in in_bucket.items():
        bp = fsm.build_plan_bucketed(ims, b)
        mixed_parts.append((b, bp, tuple(
            torch.as_tensor(a).to(dev)
            for a in (bp.xs, bp.seg_n, bp.wrap_at, bp.skip)),
            quant_of(ims), len(ims)))
    print(f"phase 8: 4:2:0 shapes: restart lane matrix "
          f"{list(plan420.xs.shape)}, max_blk {plan420.max_blk}; spec lane matrix "
          f"{list(splan420.xs.shape)} ({splan420.n_lanes} lanes; Jacobi plan "
          f"{list(jplan420.xs.shape)}, {jplan420.n_lanes} lanes); mixed "
          + "; ".join(f"{n} images in bucket {b.mcus_x} x {b.mcus_y}: lane "
                      f"matrix {list(bp.xs.shape)}, max_blk {bp.max_blk}"
                      for b, bp, _, _, n in mixed_parts))

    def restart420(fancy, want_coeffs=False):
        return fused.decode_chunk_fused(plan420, quant420, geom420, CHUNK,
                                        uploaded=up420, fancy=fancy,
                                        want_coeffs=want_coeffs, exact=True)

    def spec420(fancy):
        # what the engine does: the single-pass attempt, and after its
        # resolve miss the Jacobi decode, then the pixel stage
        try:
            pend = fsm.spec_sync_start(simgs420, plan=splan420,
                                       xs_dev=sxs420)
            return fused.decode_spec_sync_fused(
                pend, geom420, squant420, CHUNK, CHUNK, fancy=fancy,
                want_coeffs=False, exact=True)[:2]
        except fsm.SpecSyncMiss:
            coeffs, _ = fsm.decode_speculative_batch(
                simgs420, device_out=True, pad_to=CHUNK, plan=jplan420,
                xs_dev=jxs420)
            return pipeline.device_decode_fn(geom420, coeffs, squant420,
                                             fancy=fancy, exact=True)

    def mixed420(fancy):
        return [fused.decode_chunk_bucketed(bp, q, b, n, uploaded=up,
                                            fancy=fancy, want_coeffs=False,
                                            exact=True)[:2]
                for b, bp, up, q, n in mixed_parts]

    chains420 = [
        ("restart", restart420, "scan, materialize, DC, assemble, plane "
         "path"),
        ("spec", spec420, "cold + stitch scan, resolve read (miss), Jacobi "
         "count passes, write pass, materialize, gather, plane path"),
        ("mixed", mixed420, f"{len(mixed_parts)} bucket chunks: pad scan, "
         "materialize, DC, static assemble + DC mask, plane path at the "
         "bucket's size"),
    ]
    for name, fn, stages in chains420:
        mb = sum(len(x) for x in sub[name][1]) / 1e6
        for fancy in (False, True):
            ms, lo, hi = cuda_times(lambda: fn(fancy), reps=7)
            print(f"phase 8: device chain 4:2:0 {name} fancy={fancy} (plans "
                  f"and bytes resident; {stages}) {ms:.2f} ms (min {lo:.2f}, "
                  f"max {hi:.2f}): "
                  f"{CHUNK / ms * 1e3:.1f} images/s, "
                  f"{mb / ms * 1e3:.2f} compressed MB/s [{card}]")

    # the Jacobi fixed point runs on the host (fsm._spec_converge: one
    # count scan a round, one flag read after each; the JAX package runs
    # the loop on the device).  Its rounds on the 4:2:0 spec chunk, and
    # what the reads cost: the chain against the same launches for the
    # same rounds with no read between them.  `unread` is a copy of
    # _spec_converge's loop without the read; the launch counts hold it
    # to the same kernels
    converge = fsm._spec_converge
    seen = []

    def counting(*a, **k):
        res = converge(*a, **k)
        seen.append(res)
        return res

    def unread(xs, chunk_bits, inherit, max_iters, tables, blk_cap,
               steps=fsm.STEPS_PRODUCTION):
        L = chunk_bits.shape[0]
        stride = xs.shape[1]
        caps = torch.full((L,), blk_cap, dtype=torch.int32, device=xs.device)
        sb = torch.zeros(L, dtype=torch.int32, device=xs.device)
        sm = torch.zeros_like(sb)
        for _ in range(rounds):
            st = fsm.fsm_scan_spec(xs, caps, tables, steps, start_bits=sb,
                                   start_bim=sm, chunk_bits=chunk_bits,
                                   emit=False)
            nb, nm = fsm._handoff(st.end_bits, st.end_bim, inherit,
                                  stride - fsm.SPEC_OVERLAP,
                                  max_start=stride * 8 - 1)
            ((nb != sb) | (nm != sm)).any()      # launched, not read
            sb, sm = nb, nm
        return sb, sm, st.blk, st.err_mal, st.err_env, False, rounds

    def launched(fn):
        before = dict(kernels.LAUNCHES)
        out = fn()
        return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}

    fsm._spec_converge = counting
    try:
        synced, synced_launches = launched(lambda: spec420(False))
    finally:
        fsm._spec_converge = converge
    check(len(seen) == 1 and not seen[0][5], "4:2:0 spec chunk: the Jacobi "
          "path did not run once, or did not converge")
    rounds = seen[0][6]
    fsm._spec_converge = unread
    try:
        got, unread_launches = launched(lambda: spec420(False))
        check(torch.equal(got[0], synced[0]),
              "4:2:0 spec chain without the flag reads != with them")
        check(unread_launches == synced_launches and
              unread_launches.get("fsm_scan", 0) >= rounds,
              f"4:2:0 spec chain without the flag reads launched "
              f"{unread_launches}, with them {synced_launches}")
        free_ms, free_lo, free_hi = cuda_times(lambda: spec420(False), reps=7)
    finally:
        fsm._spec_converge = converge
    sync_ms, sync_lo, sync_hi = cuda_times(lambda: spec420(False), reps=7)
    del synced, got
    print(f"phase 8: Jacobi fixed point of the 4:2:0 spec chunk: {rounds} "
          f"rounds, one flag read after each on the host; the chain "
          f"{sync_ms:.2f} ms (min {sync_lo:.2f}, max {sync_hi:.2f}), the "
          f"same launches with no read {free_ms:.2f} ms (min {free_lo:.2f}, "
          f"max {free_hi:.2f}): the reads cost {sync_ms - free_ms:.2f} ms "
          f"[{card}]")
    del mixed_parts, sxs420, jxs420

    # the plane path's stages on the 4:2:0 restart chunk's coefficients
    coeffs420, dc420 = restart420(False, want_coeffs=True)[2:4]
    pix420 = pipeline._idct_planar(geom420, coeffs420, quant420, dc420)

    def rasters():
        out, base = [], 0
        for h, v, _ in geom420.comps:
            n = geom420.n_mcus * h * v
            out.append(pipeline._plane_from_soa(
                geom420, pix420[:, :, base : base + n], h, v).contiguous())
            base += n
        return out

    planes420 = rasters()
    full420 = {f: pipeline.upsample_planes(geom420, planes420, f)
               for f in (False, True)}
    crop420 = [p[:, : geom420.height, : geom420.width] for p in full420[True]]
    risky420 = color_channels(*crop420)[1]
    plane_stages = [
        ("IDCT (dequant, inverse zigzag, _idct_planar)",
         lambda: pipeline._idct_planar(geom420, coeffs420, quant420, dc420)),
        ("block -> raster (_plane_from_soa x3)", rasters),
        ("upsample, box", lambda: [p.contiguous() for p in
                                   pipeline.upsample_planes(
                                       geom420, planes420, False)]),
        ("upsample, fancy",
         lambda: pipeline.upsample_planes(geom420, planes420, True)),
        ("colour (color_channels + stack)",
         lambda: torch.stack(color_channels(*crop420)[0], dim=1)),
        ("pack (pack_mask)", lambda: pack_mask(risky420)),
        ("colour, exact (color_exact + stack, float64)",
         lambda: torch.stack(color_exact(*crop420), dim=1)),
        ("whole pixel stage, box (device_decode_fn)",
         lambda: pipeline.device_decode_fn(geom420, coeffs420, quant420,
                                           dc=dc420)),
        ("whole pixel stage, box, exact (device_decode_fn)",
         lambda: pipeline.device_decode_fn(geom420, coeffs420, quant420,
                                           dc=dc420, exact=True)),
        ("whole pixel stage, fancy (device_decode_fn)",
         lambda: pipeline.device_decode_fn(geom420, coeffs420, quant420,
                                           fancy=True, dc=dc420)),
    ]
    for stage, fn in plane_stages:
        print(f"phase 8: plane path stage, 4:2:0 restart chunk "
              f"({CHUNK} x {geom420.width}x{geom420.height}): {stage} "
              f"{cuda_ms(fn, reps=3):.3f} ms [{card}]")
    del pix420, planes420, full420, crop420, risky420, coeffs420, dc420
    torch.cuda.empty_cache()

    # the Jacobi path's entropy decode alone (its own 2048-byte plan, bytes
    # resident): count passes to the fixed point, the write pass, gather
    jplan = fsm.build_spec_plan_batch(pimgs, 2048)
    jxs = torch.as_tensor(jplan.xs).to(dev)
    jac_ms, lo, hi = cuda_times(lambda: fsm.decode_speculative_batch(
        pimgs, device_out=True, pad_to=CHUNK, plan=jplan, xs_dev=jxs))
    print(f"phase 8: Jacobi entropy decode of the spec chunk (plan and bytes "
          f"resident, {jplan.n_lanes} lanes of {jplan.xs.shape[1]} bytes; "
          f"count passes, flag reads, write pass, gather; no pixels) "
          f"{jac_ms:.2f} ms (min {lo:.2f}, max {hi:.2f}) [{card}]")

    print(f"total wall time {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def phase_several_devices(run_path, by_path, card, datas, refs, pdatas,
                          prefs, mdatas, mrefs, rimgs, rgeom, rquant):
    """Phase 6i (module docstring): the batch-sharded pixel stage, the
    engine on a mesh, the stripe-sharded huge image, two processes, and
    distinct cards where there are two.  A mesh of [cuda:0] * k runs its
    shards one after the other on one card: its times say nothing of
    scaling."""
    import numpy as np
    import torch

    from tpujpeg_torch import pipeline
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.parallel import sharding
    from tpujpeg_torch.runtime.batch import BatchDecoder

    dev0 = torch.device("cuda:0")
    mesh2 = sharding.make_mesh(2, devices=[dev0] * 2)
    one_card = "[cuda:0] x 2: one card, shards in turn"

    # the restart chunk's coefficients, DC resolved: [128, 19200, 64]
    splan = fsm.build_plan(rimgs, split=False)
    per_lane, _ = fsm.decode_plan(splan, device=dev0)
    coeffs = fsm.assemble_batched(per_lane, layout=splan.layout,
                                  pad_to=CHUNK)
    del per_lane
    want, _ = pipeline.device_decode_fn(rgeom, coeffs, rquant, exact=True)

    def sharded_restart(mesh, path):
        fn = sharding.compiled_batch_decoder(rgeom, mesh, exact=True)
        sharding.reset_transfers()
        rgb, risk, total = run_path(path, lambda: fn(coeffs, rquant),
                                    need=("pixels",))
        n = mesh.shape["batch"]
        check(by_path[path]["pixels"] == n,
              f"{path}: pixels launched {by_path[path]['pixels']} times, "
              f"not once per shard ({n})")
        check(sharding.TRANSFERS == {"halo": 0, "gather": 0},
              f"{path}: transfers between shards {sharding.TRANSFERS}")
        check(total == CHUNK * rgeom.width * rgeom.height,
              f"{path}: total {total}")
        check(risk is None and len(rgb) == n, f"{path}: outputs")
        per = CHUNK // n
        for i, (shard, d) in enumerate(zip(rgb, mesh.devices[:, 0])):
            check(shard.device == d, f"{path}: shard {i} on {shard.device}")
            check(torch.equal(shard.to(dev0), want[i * per:(i + 1) * per]),
                  f"{path}: shard {i} != the one-device decode")
        return fn

    fn = sharded_restart(mesh2, "phase 6i batch-sharded")
    one_ms = cuda_times(lambda: pipeline.device_decode_fn(
        rgeom, coeffs, rquant, exact=True))
    two_ms = cuda_times(lambda: fn(coeffs, rquant))
    print(f"phase 6i: batch-sharded pixel stage of the 128-image restart "
          f"chunk over 2 shards == device_decode_fn on one device, pixels "
          f"launched once a shard, 0 transfers between shards, total "
          f"{CHUNK * rgeom.width * rgeom.height} pixels; exact colour from "
          f"[128, 19200, 64]: one device {one_ms[0]:.3f} ms (min "
          f"{one_ms[1]:.3f}, max {one_ms[2]:.3f}), 2 shards "
          f"{two_ms[0]:.3f} ms (min {two_ms[1]:.3f}, max {two_ms[2]:.3f}) "
          f"({one_card}) [{card}]")

    # the engine on the two-shard mesh: the JAX engine's routes for a mesh
    engine = [
        ("restart", datas, refs, {}, "fsm",
         dict(need=("fsm_scan", "place_events", "pixels"))),
        ("gather", datas, refs, {"backend": "gather"}, "gather",
         dict(need=("decode_segments", "pixels"), never=("fsm_scan",))),
        ("spec", pdatas, prefs, {}, "fsm-spec-sync",
         dict(need=("fsm_scan", "place_events", "pixels"),
              never=SLOT_KERNELS)),
        ("mixed", mdatas, mrefs, {"size_buckets": True}, "host-bucketed",
         dict(need=("pixels",), never=("fsm_scan",))),
    ]
    for name, data, want_h, kw, backend, kernels_of in engine:
        path = f"phase 6i mesh {name}"
        mdec = BatchDecoder(**{"backend": "fsm", **kw}, chunk_size=CHUNK,
                            strict=True, mesh=mesh2)
        out = run_path(path, lambda: mdec.decode(data), **kernels_of)
        st = mdec.stats
        mdec.decode(data)      # warm: the link probe and slot sample done
        warm_s = mdec.stats.total_s
        mdec.close()
        check(by_path[path]["pixels"] == 2,
              f"{path}: pixels launched {by_path[path]['pixels']} times")
        check(st.backend == backend, f"{path}: backend {st.backend}")
        check(st.chunks == 1 and st.fsm_malformed_fallbacks == 0
              and st.fsm_envelope_fallbacks == 0, f"{path}: {st.as_dict()}")
        for i, got in enumerate(out):
            check(got is not None and np.array_equal(got, want_h[i % 16]),
                  f"{path}: output {i} differs from the host reference")
        print(f"phase 6i: BatchDecoder(mesh=2 shards) on the {name} chunk: "
              f"backend {st.backend}, {CHUNK} outputs == the one-device "
              f"phase's reference, launches {json.dumps(by_path[path])}; "
              f"end to end {st.total_s * 1e3:.1f} ms, warm "
              f"{warm_s * 1e3:.1f} ms ({one_card}) [{card}]")

    # the stripe-sharded huge image (tools/validate_torch_huge.py)
    import validate_torch_huge

    rec = validate_torch_huge.validate(stripes=8, repeats=1)
    check(rec["exact"], f"striped decode differs: {json.dumps(rec)}")
    check(rec["box_transfers"] == {"halo": 0, "gather": 8}
          and rec["fancy_transfers"] == {"halo": 2 * 2 * 7, "gather": 8},
          f"striped transfers {rec['box_transfers']}, "
          f"{rec['fancy_transfers']}")
    where = "distinct cards" if rec["distinct_cards"] \
        else "cuda:0 x 8: one card, stripes in turn"
    print(f"phase 6i: decode_striped of the 8192 x 8192 4:2:0 stream on 8 "
          f"stripes ({where}) == host.decode_cpu, box and fancy: "
          f"{json.dumps(rec)}")

    # two processes over gloo on localhost, both on cuda:0
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         f"127.0.0.1:{port}"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    lines = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"dist worker {r} failed "
              f"(exit {p.returncode}):\n{out[-4000:]}")
        lines.append(json.loads([ln for ln in out.splitlines()
                                 if ln.startswith('{"rank"')][-1]))
    stream_bytes = sum(len(d) for d in read_streams(RST))
    for r, w in enumerate(lines):
        check(w["rank"] == r and w["world"] == 2 and w["exact"],
              f"dist worker {r}: {w}")
        check(w["totals"] == {"bytes": float(stream_bytes), "images": 16.0},
              f"dist worker {r}: totals {w['totals']}")
    check(sorted(lines[0]["mine"] + lines[1]["mine"]) == list(range(16))
          and not set(lines[0]["mine"]) & set(lines[1]["mine"]),
          "dist workers' shards are not disjoint and covering")
    print(f"phase 6i: two processes (gloo, localhost, both on cuda:0): "
          f"shards {lines[0]['mine']} and {lines[1]['mine']} of the 16 "
          f"rst640 streams, each == the host reference, summed metrics "
          f"{json.dumps(lines[0]['totals'])}; decode ms per process "
          f"{[w['decode_ms'] for w in lines]} [{card}]")

    if torch.cuda.device_count() >= 2:
        mesh_d = sharding.make_mesh(2, devices=["cuda:0", "cuda:1"])
        sharded_restart(mesh_d, "phase 6i distinct cards")
        print(f"phase 6i: batch-sharded restart chunk on cuda:0 and cuda:1 "
              f"== one device, pixels once a shard [{card}]")
    else:
        print(f"phase 6i: distinct cards skipped: "
              f"{torch.cuda.device_count()} card on this machine (the "
              f"batch-sharded decode on cuda:0 and cuda:1 needs two)")


def dist_worker(rank: int, addr: str) -> int:
    """One of phase 6i's two processes: join the gloo group at `addr`,
    decode this rank's round-robin shard of the 16 rst640 streams on
    cuda:0, hold it == the host reference, sum the metrics; print one
    JSON line."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.distributed

    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.parallel import distributed as dist
    from tpujpeg_torch.runtime import host
    from tpujpeg_torch.runtime.batch import BatchDecoder

    dist.initialize(coordinator_address=addr, num_processes=2,
                    process_id=rank, initialization_timeout=120)
    streams = read_streams(RST)
    mine = dist.shard_list(list(range(16)))
    datas = [streams[i] for i in mine]
    dec = BatchDecoder(backend="fsm", chunk_size=len(datas), device="cuda:0")
    t0 = time.perf_counter()
    out = dec.decode(datas)
    ms = (time.perf_counter() - t0) * 1e3
    dec.close()
    exact = all(np.array_equal(g, host.decode_cpu(parse(d)))
                for g, d in zip(out, datas))
    totals = dist.allreduce_metrics(
        {"images": len(datas), "bytes": float(sum(map(len, datas)))})
    rank_world = dist.process_info()
    dist.barrier()
    torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank_world[0], "world": rank_world[1],
                      "mine": mine, "exact": exact, "totals": totals,
                      "decode_ms": ms}))
    return 0 if exact else 1


def fsm_chunk_stub(imgs):
    """The two fields BatchDecoder._slot_capacity reads of a chunk."""
    from types import SimpleNamespace

    return SimpleNamespace(slots_off=False, imgs=imgs[:1])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
