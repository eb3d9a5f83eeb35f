"""Per-image runtime of tpujpeg_torch against image size: the counterpart
of benchmarks/bench_runtime.py.

The reference's runtime harness (cuda-decoder/benchmark/benchmark.cu:
27-111): sizes 200..2000 step 200, several timed decodes an image,
"path ms" lines (the format benchmarks/plot_results.py parses) and one
JSONL record a size.  The series is the committed
tests/fixtures/runtime_sizes/S.jpg (bench.py's synthetic _make_image(S,
S), q90, a restart marker every MCU row; tools/make_torch_corpus.py),
or every .jpg of --images-dir.

Each image: BatchDecoder(chunk_size=1, strict=False), one warm decode,
then --iters decodes with fetch=False, each fenced with
torch.cuda.synchronize() and timed on the host clock: parse, entropy
decode and the device pixel stage, no output fetched (the reference's
cudaH row of BASELINE.md with --backend host, the default: host Huffman,
pixels on the card).  --backend fsm or gather decodes the entropy on the
card too.  The record keeps which backend the engine took
(stats.backend): a size past a route's envelope takes another.

    python benchmarks/bench_torch_runtime.py --out runtime_results.txt \
        [--sizes 200 2000 200] [--iters 5] [--backend host] [--jsonl F]
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

SERIES = os.path.join(tc.FIXTURES, "runtime_sizes")

# Reference per-image runtime means @ WxW (BASELINE.md, ms).
REFERENCE_MS = {
    "cudaH": {200: 3.48, 400: 12.4, 600: 30.2, 800: 52.2, 1000: 82.8,
              1200: 114, 1400: 159, 1600: 195, 1800: 218, 2000: 243},
    "jpeglib": {200: 2.68, 400: 5.49, 600: 10.3, 800: 17.2, 1000: 25.3,
                1200: 35.1, 1400: 47.2, 1600: 60.2, 1800: 70.0, 2000: 78.2},
}


def cases(sizes, images_dir=None) -> list[tuple[str, bytes]]:
    """(path, bytes): the committed series at `sizes`, or a directory."""
    if images_dir:
        return [(os.path.join(images_dir, n), d)
                for n, d in tc.read_dir(images_dir)]
    out = []
    for s in sizes:
        with open(os.path.join(SERIES, f"{s}.jpg"), "rb") as f:
            out.append((f"synthetic/{s}x{s}.jpg", f.read()))
    return out


def run(cases_, dev, backend: str = "host", iters: int = 5,
        out=None, jsonl=None, log=print) -> list[dict]:
    """Time each case; write "path ms" lines to `out` and records to
    `jsonl` (open files or None)."""
    import numpy as np

    from tpujpeg_torch.runtime.batch import BatchDecoder

    dec = BatchDecoder(backend=backend, chunk_size=1, strict=False,
                       device=dev)
    records = []
    try:
        for path, data in cases_:
            dec.decode([data], fetch=False)   # warm
            tc.sync(dev)
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                dec.decode([data], fetch=False)
                tc.sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.mean(times))
            if out is not None:
                out.write(f"{path} {ms:.4f}\n")
            rec = {
                "path": path,
                "bytes": len(data),
                "ms_mean": round(ms, 3),
                "ms_min": round(min(times), 3),
                "ms_max": round(max(times), 3),
                "backend": dec.stats.backend,
                "stage_s": {
                    "parse": round(dec.stats.parse_s, 4),
                    "entropy": round(dec.stats.entropy_s, 4),
                    "device": round(dec.stats.device_s, 4),
                },
            }
            records.append(rec)
            if jsonl is not None:
                jsonl.write(json.dumps(rec) + "\n")
            if log:
                log(f"{path}: {ms:.1f} ms  (min {min(times):.1f}, max "
                    f"{max(times):.1f}) backend {rec['backend']}")
    finally:
        dec.close()
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs=3, default=[200, 2000, 200],
                    metavar=("LO", "HI", "STEP"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--backend", default="host",
                    choices=["auto", "host", "fsm", "gather", "oracle",
                             "cpu"])
    ap.add_argument("--out", default="benchmark_results.txt")
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--images-dir", default=None,
                    help="benchmark the files of this directory instead "
                         "of the committed series")
    tc.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = tc.device(args.device)

    lo, hi, step = args.sizes
    todo = cases(range(lo, hi + 1, step), args.images_dir)
    print(f"{len(todo)} images, backend {args.backend} [{tc.card(dev)}]",
          flush=True)
    jsonl = open(args.jsonl, "a") if args.jsonl else None
    try:
        with open(args.out, "a") as out:
            run(todo, dev, args.backend, args.iters, out, jsonl,
                log=lambda s: print(s, flush=True))
    finally:
        if jsonl:
            jsonl.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
