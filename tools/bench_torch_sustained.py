"""Sustained batch decode of tpujpeg_torch over thousands of images in
windows: the counterpart of tools/bench_sustained.py.

--images streams (tests/fixtures/rst640 repeated in order: 16 distinct
640x640 q90 4:4:4 restart streams, where the JAX tool encoded 3,000
distinct 500x500 ones; the tool prints the count) are decoded by one
BatchDecoder(strict=False) in --windows windows, decode(fetch=False) as
the reference's throughput harness leaves its outputs unwritten
(benchmark_thoughput/benchmark.cu:80-84).  Per window, one JSON line:

  * MBps: compressed MB/s end to end through BatchDecoder.decode;
  * device_MBps (backend fsm, one size): the window's chunks parsed,
    planned and uploaded outside the timed region, then their fused
    chains (fused.decode_chunk_fused(uploaded=), one a --chunk images)
    behind one fence, which also reads every error latch; the
    counterpart of bench.stage_device_chunks / run_device_chunks;
  * rss_MB: host RSS after a gc and malloc_trim (live memory, not
    glibc's fragmentation);
  * card_alloc_MB, card_max_reserved_MB: torch.cuda.memory_allocated
    and max_memory_reserved, so that a leak on the card shows too.

Then a summary: the window metric's mean, min, max and spread, and the
growth of RSS and of the card's memory from the first window to the
last.  --mixed-sizes decodes tests/fixtures/mixed_rst (16 sizes,
624-800 px) with size_buckets=True, end to end only; --passes decodes
the corpus that many times in one process; --device-only skips the end
to end pass.

    python tools/bench_torch_sustained.py [--images 3000] [--windows 10]
        [--chunk 64] [--out FILE.jsonl] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_common as tc  # noqa: E402


def stage_chunks(datas: list[bytes], chunk: int, dev) -> list:
    """Parse, plan and upload `datas` in chunks of `chunk` images (one
    geometry, restart streams): a list of (plan, quant, geom, uploaded)."""
    import torch

    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.pipeline import Geometry

    out = []
    for j in range(0, len(datas), chunk):
        imgs = [parse(d) for d in datas[j : j + chunk]]
        plan = fsm.build_plan(imgs, split=False)
        out.append((plan, tc.quant(imgs, dev), Geometry.of(imgs[0]),
                    (torch.as_tensor(plan.xs).to(dev),
                     torch.as_tensor(plan.seg_n_blocks).to(dev))))
    tc.sync(dev)
    return out


def run_chunks(staged: list) -> int:
    """Every staged chunk's fused chain (f32 colour, no coefficients
    kept), then ONE read, which waits for every chain: a nonzero result
    means an error lane latched."""
    import torch

    from tpujpeg_torch.runtime import fused

    bad = None
    for plan, quant, geom, up in staged:
        _, _, _, _, mal, env, slot = fused.decode_chunk_fused(
            plan, quant, geom, quant.shape[0], uploaded=up,
            want_coeffs=False)
        b = (mal | env | slot).any()
        bad = b if bad is None else bad | b
    return int(torch.as_tensor(bad).item())


def card_mb(dev) -> tuple:
    import torch

    if dev.type != "cuda":
        return None, None
    return (round(torch.cuda.memory_allocated(dev) / 1e6, 1),
            round(torch.cuda.max_memory_reserved(dev) / 1e6, 1))


def sustained(datas: list[bytes], dev, windows: int = 10, chunk: int = 64,
              backend: str = "fsm", mixed: bool = False, passes: int = 1,
              device_only: bool = False, log=print) -> list[dict]:
    """The window records, then the summary record."""
    import numpy as np

    from tpujpeg_torch.runtime.batch import BatchDecoder

    dec = BatchDecoder(backend=backend, chunk_size=chunk, strict=False,
                       size_buckets=mixed, device=dev)
    records = []
    try:
        dec.decode(datas[:chunk], fetch=False)   # warm: link probe, sample
        device_windows = backend == "fsm" and not mixed
        win = -(-len(datas) // windows)
        for p in range(passes):
            for w in range(windows):
                part = datas[w * win : (w + 1) * win]
                if not part:
                    break
                nbytes = sum(map(len, part))
                dev_mbps = None
                if device_windows:
                    staged = stage_chunks(part, chunk, dev)
                    if p == 0 and w == 0:
                        run_chunks(staged)   # warm
                    t0 = time.perf_counter()
                    bad = run_chunks(staged)
                    dt = time.perf_counter() - t0
                    if bad:
                        raise RuntimeError(f"window {w}: an error lane "
                                           "latched in the fused chains")
                    dev_mbps = nbytes / dt / 1e6
                    del staged
                mbps = None
                if not device_only:
                    t0 = time.perf_counter()
                    dec.decode(part, fetch=False)
                    mbps = nbytes / (time.perf_counter() - t0) / 1e6
                tc.trim()
                alloc, reserved = card_mb(dev)
                rec = {"window": w, "pass": p, "images": len(part),
                       "compressed_MB": round(nbytes / 1e6, 2),
                       "device_MBps": dev_mbps, "MBps": mbps,
                       "rss_MB": round(tc.rss_mb(), 1),
                       "card_alloc_MB": alloc,
                       "card_max_reserved_MB": reserved,
                       "backend": "fsm-device-only" if device_only
                       else dec.stats.backend,
                       "chunks": None if device_only else dec.stats.chunks}
                records.append(rec)
                if log:
                    log(json.dumps(rec))
    finally:
        dec.close()

    last = [r for r in records if r["pass"] == passes - 1]
    metric = "MBps" if records[-1]["device_MBps"] is None else "device_MBps"
    mbps = [r[metric] or 0.0 for r in last]
    rss = [r["rss_MB"] for r in records]
    alloc = [r["card_alloc_MB"] for r in records]
    reserved = [r["card_max_reserved_MB"] for r in records]
    records.append({
        "metric": "sustained_batch",
        "images": len(datas),
        "distinct": tc.distinct(datas),
        "windows": len(last),
        "passes": passes,
        "window_metric": metric,
        "MBps_mean": float(np.mean(mbps)),
        "MBps_min": float(np.min(mbps)),
        "MBps_max": float(np.max(mbps)),
        "window_spread_pct": 100 * (float(np.max(mbps)) - float(np.min(mbps)))
        / max(float(np.mean(mbps)), 1e-9),
        "rss_first_MB": rss[0],
        "rss_last_MB": rss[-1],
        "rss_growth_MB": round(rss[-1] - rss[0], 1),
        "card_alloc_first_MB": alloc[0],
        "card_alloc_last_MB": alloc[-1],
        "card_alloc_growth_MB": None if alloc[0] is None
        else round(alloc[-1] - alloc[0], 1),
        "card_max_reserved_last_MB": reserved[-1],
        "config": f"strict=False chunk={chunk} backend="
                  f"{records[-1]['backend']} size_buckets={mixed}; "
                  "fetch=False (the reference's no-output-write method)",
        "card": tc.card(dev),
    })
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=3000)
    ap.add_argument("--images-dir", default=None,
                    help="repeat the streams of this directory in place of "
                         "the committed corpus")
    ap.add_argument("--backend", default="fsm",
                    choices=["fsm", "gather", "host", "oracle", "cpu",
                             "auto"])
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--device-only", action="store_true",
                    help="skip the end to end pass of each window")
    ap.add_argument("--mixed-sizes", action="store_true",
                    help="tests/fixtures/mixed_rst with size_buckets=True")
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--out", default=None)
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)
    if args.device_only and (args.backend != "fsm" or args.mixed_sizes):
        ap.error("--device-only needs --backend fsm and one size")

    if args.images_dir:
        datas = tc.repeat([d for _, d in tc.read_dir(args.images_dir)],
                          args.images)
    else:
        datas = tc.corpus("mixed_rst" if args.mixed_sizes else "rst640",
                          args.images)
    print(f"{len(datas)} streams, {tc.distinct(datas)} distinct, "
          f"{sum(map(len, datas)) / 1e6:.1f} MB compressed "
          f"[{tc.card(dev)}]", flush=True)
    records = sustained(datas, dev, args.windows, args.chunk, args.backend,
                        args.mixed_sizes, args.passes, args.device_only,
                        log=lambda s: print(s, flush=True))
    print(json.dumps(records[-1]), flush=True)
    if args.out:
        tc.write_jsonl(args.out, records, mode="w")
    return 0


if __name__ == "__main__":
    sys.exit(main())
