"""Batched throughput of tpujpeg_torch against batch size: the
counterpart of benchmarks/bench_throughput.py.

The reference's throughput harness
(cuda-decoder/benchmark_thoughput/benchmark.cu:25-136): a fixed dataset
decoded as one batch, compressed MB/s and images/s, swept over batch
sizes (--batches) as its nvJPEG comparison sweeps them
(nvjpeg-implementation/benchmark_bs.cc:32-37); with --batches 1 10 100
1000 3000 at a fixed --chunk it is the image-count sweep of
benchmark_is.cc:31-38.  --chunks and --workers sweep the chunk size and
the host pool (the reference's thread sweep); each record keeps the
per-iteration MB/s for boxplots.

Corpus (--corpus): tests/fixtures/rst640 (640x640 q90 4:4:4, a restart
marker every MCU row), photo640 (the same pictures without restart
markers) or mixed_rst (16 sizes of 624-800 px, decoded with
size_buckets=True), 16 distinct streams repeated in order to the largest
batch (the tool prints the count); or every .jpg of --images-dir.

Each batch: BatchDecoder(strict=False).decode(batch, fetch=False),
--iters times after one warm decode of a chunk, each timed on the host
clock to a synchronize; the median gives the record's rates.

    python benchmarks/bench_torch_throughput.py --batches 8 32 96
    python benchmarks/bench_torch_throughput.py --batches 1 10 100 1000 \
        3000 --chunk 128 --backend fsm
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))

import torch_common as tc  # noqa: E402

CORPORA = ("rst640", "photo640", "mixed_rst")


def sweep(datas: list[bytes], dev, batches, chunks, workers_list,
          backend: str = "host", iters: int = 3, size_buckets: bool = False,
          size=None, log=print) -> list[dict]:
    """One record per (chunk, workers, batch)."""
    import numpy as np

    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.runtime.batch import BatchDecoder

    area = {}
    for d in datas:
        if d not in area:
            im = parse(d)
            area[d] = im.width * im.height
    pixels = np.cumsum([0] + [area[d] for d in datas])
    records = []
    for chunk in chunks:
        for workers in workers_list:
            dec = BatchDecoder(backend=backend, chunk_size=chunk,
                               workers=workers, strict=False,
                               size_buckets=size_buckets, device=dev)
            try:
                dec.decode(datas[:chunk], fetch=False)   # warm
                for b in batches:
                    batch = datas[:b]
                    b = len(batch)
                    nbytes = sum(map(len, batch))
                    times = []
                    for _ in range(iters):
                        t0 = time.perf_counter()
                        dec.decode(batch, fetch=False)
                        tc.sync(dev)
                        times.append(time.perf_counter() - t0)
                    dt = float(np.median(times))
                    rec = {
                        "batch": b,
                        "chunk": chunk,
                        "workers": workers,
                        "size": size,
                        "mb_per_s": round(nbytes / dt / 1e6, 2),
                        "images_per_s": round(b / dt, 2),
                        "mpix_per_s": round(int(pixels[b]) / dt / 1e6, 2),
                        "mb_per_s_samples": [round(nbytes / t / 1e6, 2)
                                             for t in times],
                        "backend": dec.stats.backend,
                        "chunks": dec.stats.chunks,
                        "distinct": tc.distinct(batch),
                    }
                    records.append(rec)
                    if log:
                        wtag = f" workers={workers}" if workers else ""
                        log(f"batch {b:4d} chunk {chunk:3d}{wtag}: "
                            f"{rec['mb_per_s']:7.1f} MB/s  "
                            f"{rec['images_per_s']:7.1f} img/s  "
                            f"{rec['mpix_per_s']:7.1f} MPix/s "
                            f"({rec['backend']}, {rec['chunks']} chunks)")
            finally:
                dec.close()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32, 96])
    ap.add_argument("--corpus", default="rst640", choices=CORPORA)
    ap.add_argument("--images-dir", default=None,
                    help="repeat the streams of this directory in place of "
                         "--corpus")
    ap.add_argument("--backend", default="host",
                    choices=["auto", "host", "fsm", "gather", "oracle",
                             "cpu"])
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--chunks", type=int, nargs="+", default=None,
                    help="sweep chunk sizes (device batch granularity)")
    ap.add_argument("--workers", type=int, nargs="+", default=None,
                    help="sweep host thread-pool sizes (reference: "
                         "Threads sweep)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--jsonl", default=None)
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)

    n = max(args.batches)
    if args.images_dir:
        datas = tc.repeat([d for _, d in tc.read_dir(args.images_dir)], n)
        size = None
    else:
        datas = tc.corpus(args.corpus, n)
        size = None if args.corpus == "mixed_rst" else 640
    mixed = args.corpus == "mixed_rst" and not args.images_dir
    print(f"{len(datas)} streams, {tc.distinct(datas)} distinct, backend "
          f"{args.backend} [{tc.card(dev)}]", flush=True)
    records = sweep(datas, dev, args.batches, args.chunks or [args.chunk],
                    args.workers or [None], args.backend, args.iters, mixed,
                    size, log=lambda s: print(s, flush=True))
    for r in records:
        print(json.dumps(r))
    if args.jsonl:
        tc.write_jsonl(args.jsonl, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
