"""Times of the segment decoder (`decode_segments`, csrc/segments.cu) on a
CUDA card, for any checkout of tpujpeg_torch.

    python tools/bench_torch_segments.py --root CHECKOUT [--iters 9]
        [--repeat 8] [OUT.json]

Imports `tpujpeg_torch` from CHECKOUT (its own kernels, built there at
first use), so the same tool times a parent unpacked with `git archive`
and the change in one call, in turns (P C C P).  It builds the segment
plans of the two 128-image chunks of chip_smoke.py phase 6g from this
tool's repo's corpora, 16 streams x `--repeat`: the restart chunk
(tests/fixtures/rst640, a lane a restart segment) and the chunk without
restart markers (tests/fixtures/photo640, a lane an image), uploads them
once, and reads with CUDA events, median, min and max of `--iters` warm
runs:

  call   `decode_segments` on the plan's arrays and `device_luts`'
         tensor, all resident (its zero fill, the kernel)
  fill   the zero fill alone (torch.zeros of the same output)

and on the host's clock, median, min and max of `--iters` runs:

  lookup `device_luts` finding the chunk's table set in its cache (the
         key: the tables' bytes and their hash)
  warm   `decode_plan` through to a synchronize, the tables cached
  cold   the same with `entropy._lut_cache` emptied first: the call
         uploads the chunk's table set (and derives what its kernel
         reads from it)

A third chunk, restart_opt (tests/fixtures/rst640_opt: tables optimised
per image, 46 distinct tables), reads the cold call where the table set
is new for every chunk.

Each chunk's output is checked (no failed lane) and printed as a SHA-256
of its coefficients, so two checkouts' outputs compare by eye.  Prints
one line per chunk with the card's name and power limit; writes the
readings as JSON to OUT.json when given.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = (("restart", "rst640"), ("spec", "photo640"),
          ("restart_opt", "rst640_opt"))


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, iters: int) -> list:
    """Milliseconds of fn() over `iters` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def wall_times(fn, iters: int, before=None) -> list:
    """Milliseconds on the host's clock of fn() through to a synchronize,
    over `iters` runs after one; `before()` runs ahead of each, untimed."""
    import time

    import torch

    times = []
    for i in range(iters + 1):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def spread(times: list) -> dict:
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def read_chunk(folder: str, repeat: int) -> list:
    names = sorted(f for f in os.listdir(folder) if f.endswith(".jpg"))
    datas = []
    for n in names:
        with open(os.path.join(folder, n), "rb") as f:
            datas.append(f.read())
    return datas * repeat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tpujpeg_torch is timed")
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_segments: needs a CUDA card", file=sys.stderr)
        return 1
    import tpujpeg_torch
    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.ops import entropy

    if not os.path.abspath(tpujpeg_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"tpujpeg_torch came from {tpujpeg_torch.__file__}"
                           f", not from {root}")
    smi = card()
    dev = torch.device("cuda")
    res = {"root": root, "card": smi, "iters": args.iters}
    for name, corpus in CHUNKS:
        imgs = [parse(d) for d in read_chunk(
            os.path.join(ROOT, "tests", "fixtures", corpus), args.repeat)]
        plan = entropy.build_segment_plan(imgs)
        up = tuple(torch.as_tensor(a).to(dev)
                   for a in entropy.plan_arrays(plan))
        luts = entropy.device_luts(plan.luts, dev)

        def call():
            return entropy.decode_segments(
                *up[:5], luts, up[5], cap=plan.cap,
                n_blocks_total=plan.n_blocks_total)

        def through_plan():
            return entropy.decode_plan(plan, dev, uploaded=up)

        coeffs, err = call()
        if bool(err.any()):
            raise RuntimeError(f"{name}: lanes failed")
        digest = hashlib.sha256(coeffs.cpu().numpy().tobytes()).hexdigest()
        del coeffs, err
        call_t = cuda_times(call, args.iters)
        fill_t = cuda_times(lambda: torch.zeros(
            (plan.n_blocks_total, 64), dtype=torch.int32, device=dev),
            args.iters)
        lookup_t = wall_times(lambda: entropy.device_luts(plan.luts, dev),
                              args.iters)
        warm_t = wall_times(through_plan, args.iters)
        cold_t = wall_times(through_plan, args.iters,
                            entropy._lut_cache.clear)
        lanes = int((plan.seg_n_blocks > 0).sum())
        r = {"lanes": lanes, "cap": plan.cap, "sha256": digest,
             "tables": plan.luts.shape[0],
             "call_ms": spread(call_t), "fill_ms": spread(fill_t),
             "lookup_ms": spread(lookup_t), "warm_wall_ms": spread(warm_t),
             "cold_wall_ms": spread(cold_t),
             "call_times": call_t}
        res[name] = r
        c, f = r["call_ms"], r["fill_ms"]
        u, w, k = r["lookup_ms"], r["warm_wall_ms"], r["cold_wall_ms"]
        print(f"bench_torch_segments {name} chunk ({lanes} lanes, cap "
              f"{plan.cap}, {r['tables']} tables) from {root}: "
              f"decode_segments {c['median']:.4f} ms (min {c['min']:.4f}, "
              f"max {c['max']:.4f}) with its fill; fill alone "
              f"{f['median']:.4f} ms (min {f['min']:.4f}, max "
              f"{f['max']:.4f}); host clock: device_luts lookup "
              f"{u['median']:.4f} ms (min {u['min']:.4f}, max "
              f"{u['max']:.4f}), decode_plan warm {w['median']:.4f} ms (min "
              f"{w['min']:.4f}, max {w['max']:.4f}), tables cold "
              f"{k['median']:.4f} ms (min {k['min']:.4f}, max "
              f"{k['max']:.4f}); sha256 {digest[:16]} [{smi}]", flush=True)
        del up
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
