"""Batches of several 128-image chunks through tpujpeg_torch's BatchDecoder.

chip_smoke.py phase 6f's three batches, from the committed corpora:

  R: tests/fixtures/rst640 x 64 (1,024 restart streams, 8 chunks);
  M: runs of 128 rst640 and 128 photo640 streams in turns (1,024
     streams, 8 chunks, "fsm" and "fsm-spec-sync");
  B: tests/fixtures/mixed_rst x 32 with size_buckets=True (512 streams,
     4 bucketed chunks).

Each batch is decoded once and every output held `==` the native host
decoder's; then three ways, each timed over --runs warm runs (host clock
to a synchronize; median, min and max):

  decode         one BatchDecoder.decode call over the batch (fetch=True);
  decode_parsed  the same on streams parsed beforehand, so no parse is
                 in the timed window;
  serial         one decode call per 128-image run.

For decode and decode_parsed the host split of the median run is printed
too (BatchStats: parse_s, entropy_s, device_s and the rest of total_s,
which is the fetch and crop), and for decode_parsed where the plan
builders' time goes: summed over every call of fsm.build_plan,
build_plan_bucketed and build_spec_plan_batch (on the calling thread in
a serial engine, on the prep pool in a pipelined one) the wall time, the
thread's user and system CPU time and its minor page faults
(getrusage(RUSAGE_THREAD)), and the calling thread's CPU time over the
run.  A builder whose wall time runs far past its CPU time waited for
the GIL or a core.  The last line is one JSON object of every reading.

--switch-interval S sets the interpreter's thread switch interval
(sys.setswitchinterval; 0.005 s by default) before anything is decoded:
the threads that parse, prepare and dispatch take turns at the GIL, and
a thread that gives it up for a device read or a copy waits up to one
interval to take it back.

It decodes with the tpujpeg_torch beside it: to read another checkout
(a parent unpacked with git archive), copy this file into that
checkout's tools/ and run it there.  Needs a CUDA card:

    python tools/bench_torch_batches.py [--runs 3] [--switch-interval S]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CHUNK = 128


def read_streams(name: str) -> list[bytes]:
    folder = os.path.join(FIXTURES, name)
    out = []
    for n in sorted(f for f in os.listdir(folder) if f.endswith(".jpg")):
        with open(os.path.join(folder, n), "rb") as f:
            out.append(f.read())
    return out


def batches() -> tuple[list, dict]:
    """The unique streams, and name -> (the batch's streams, each one's
    index into the unique streams, the decoder's arguments)."""
    rst, photo, mixed = (read_streams(n)
                         for n in ("rst640", "photo640", "mixed_rst"))
    uniq = rst + photo + mixed
    r = list(range(len(rst)))
    p = [len(rst) + i for i in range(len(photo))]
    m = [len(rst) + len(photo) + i for i in range(len(mixed))]
    runs = CHUNK // len(rst)
    spec = {
        "R": ([i for _ in range(runs * 8) for i in r], {}),
        "M": ([i for k in range(8) for _ in range(runs)
               for i in (r if k % 2 == 0 else p)], {}),
        "B": ([i for _ in range(CHUNK // len(mixed) * 4) for i in m],
              {"size_buckets": True}),
    }
    return uniq, {k: ([uniq[i] for i in idx], idx, args)
                  for k, (idx, args) in spec.items()}


BUILDERS = ("build_plan", "build_plan_bucketed", "build_spec_plan_batch")


def _thread_usage() -> tuple:
    r = resource.getrusage(resource.RUSAGE_THREAD)
    return time.perf_counter(), r.ru_utime, r.ru_stime, r.ru_minflt


def time_builders(fsm, log: list):
    """Wrap fsm's plan builders so that each call appends to log its wall,
    user and system seconds and minor faults on its thread; returns the
    function that unwraps them."""
    real = {n: getattr(fsm, n) for n in BUILDERS}

    def wrap(fn):
        def timed_call(*a, **k):
            before = _thread_usage()
            try:
                return fn(*a, **k)
            finally:
                log.append([y - x for x, y in zip(before, _thread_usage())])
        return timed_call

    for n, fn in real.items():
        setattr(fsm, n, wrap(fn))
    return lambda: [setattr(fsm, n, fn) for n, fn in real.items()]


def timed(fn, runs: int, stats=None, builders=None):
    import torch

    times, splits = [], []
    for _ in range(runs):
        if builders is not None:
            builders.clear()
        t0, c0 = time.perf_counter(), time.thread_time()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        cpu = (time.thread_time() - c0) * 1e3
        del out
        if stats is not None:
            st = stats()
            splits.append({k: getattr(st, f"{k}_s") * 1e3 for k in
                           ("parse", "entropy", "device", "total")})
        if builders is not None:
            wall, user, system, faults = map(sum, zip(*builders))
            splits[-1].update(
                builders_wall=wall * 1e3, builders_user=user * 1e3,
                builders_sys=system * 1e3, builders_minflt=faults,
                builder_calls=len(builders), caller_cpu=cpu)
    res = {"median_ms": statistics.median(times), "min_ms": min(times),
           "max_ms": max(times)}
    if splits:
        split = splits[sorted(range(runs), key=times.__getitem__)[runs // 2]]
        split["rest"] = split["total"] - split["parse"] - split["entropy"] \
            - split["device"]
        res["split_ms"] = split
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--switch-interval", type=float, default=None)
    args = ap.parse_args(argv)
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)

    import numpy as np
    import torch

    from tpujpeg_torch.io.parser import parse
    from tpujpeg_torch.ops import fsm
    from tpujpeg_torch.runtime import host
    from tpujpeg_torch.runtime.batch import BatchDecoder

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; tpujpeg_torch from {ROOT}; switch interval "
          f"{sys.getswitchinterval()} s")
    uniq, todo = batches()
    want = [host.decode_cpu(parse(d)) for d in uniq]
    readings = {}
    for name, (datas, idx, dargs) in todo.items():
        dec = BatchDecoder(backend="fsm", chunk_size=CHUNK, device="cuda",
                           **dargs)
        out = dec.decode(datas)
        torch.cuda.synchronize()
        bad = [j for j, (g, i) in enumerate(zip(out, idx))
               if g is None or not np.array_equal(g, want[i])]
        if bad or len(out) != len(idx):
            print(f"{name}: outputs {bad[:8]} differ from "
                  f"{host.backend_name()}", file=sys.stderr)
            return 1
        del out
        parsed = [parse(d) for d in datas]

        def serial():
            return [r for j in range(0, len(datas), CHUNK)
                    for r in dec.decode(datas[j : j + CHUNK])]

        got = {"images": len(datas), "chunks": dec.stats.chunks,
               "backend": dec.stats.backend}
        got["decode"] = timed(lambda: dec.decode(datas), args.runs,
                              lambda: dec.stats)
        log: list = []
        unwrap = time_builders(fsm, log)
        got["decode_parsed"] = timed(lambda: dec.decode_parsed(parsed),
                                     args.runs, lambda: dec.stats, log)
        unwrap()
        got["serial"] = timed(serial, args.runs)
        dec.close()
        readings[name] = got
        print(f"{name}: {got['images']} images in {got['chunks']} chunks, "
              f"backend {got['backend']}, bit-exact vs "
              f"{host.backend_name()} [{card}]")
        for way in ("decode", "decode_parsed", "serial"):
            r = got[way]
            split = "".join(f", {k} {v:.1f}" for k, v in
                            r.get("split_ms", {}).items())
            print(f"{name} {way}: {r['median_ms']:.1f} ms (min "
                  f"{r['min_ms']:.1f}, max {r['max_ms']:.1f}){split} "
                  f"[{card}]")
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "switch_interval_s":
                      sys.getswitchinterval(), "batches": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
