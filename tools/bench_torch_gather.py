"""Time table-lookup strategies on a CUDA card (tpujpeg_torch).

The port of tools/bench_gather.py.  Prints the card's name and power
limit, then milliseconds and nanoseconds per lookup for:

  1. torch index_select: 1M random indices into a 64Ki-entry table (the
     16-bit peek decode shape);
  2. the same into a 256-entry table (the symbol-map shape);
  3. a one-hot matrix product "gather" for the 256-entry table
     (torch.matmul; the arithmetic alternative to a lookup);
  4. whole-row gathers: 2,560 rows of 64 KiB (a lane permutation) and 1M
     rows of 256 B (the speculative assemble shape);
  5. torch.gather over [1024, 256] per-row tables, 1M lookups;
  6. kernel "gather_rows" and torch.gather (int64 indices made before
     the timed region) at the tool shape, t [1024, 256], i [1024, 1024],
     and at a shape of the same layout past the 50 MB L2, t [16384, 256],
     i [16384, 1024]: three readings each (below), and at the second
     shape the bytes a gather must move, its bound and its share;
  7. kernel "gather_table" and index_select the same way, t [256] with
     i [2^18] and i [2^25];
  8. the host's cost of one warm `gather_rows` call, split into its
     parts (the two tensor checks, the geometry, torch.empty_like, the
     current stream, kernels.library(), the lookup of the C entry, the
     whole kernels.launch), the whole call, torch.gather on the same
     inputs, and the whole `gather_table` call and index_select at the
     tool shape of item 7, microseconds per call over 1,000 calls each;
  9. kernel "chain": 4,096 DEPENDENT lookups idx = (t[idx] * 7 + 1) %
     4096, one thread, the table read from L2, from shared memory and
     through the read-only cache path (the load the scan kernel uses),
     held equal to its plain version at 4,096 and 65,536 steps and at a
     table of 4,093 entries (the step's reciprocal, not its mask).  Call
     ms per walk, and the time per dependent step from the difference
     between a 65,536-step and a 4,096-step walk, so that the launch and
     the staging of the table cancel (`print_chains`); then the device
     time from a CUDA graph (`chain_readings`, `print_chain_readings`):
     ns per step at 4,096 and 65,536 steps for each source, the same for
     the chain's latency floor (entry tpj_chain_floor: the walk with the
     step taken out, idx = t[idx], over a table that is one permutation
     cycle, so every step loads a new entry), and the share floor /
     chain at 65,536 steps;
 10. last, torch.profiler's kernel times of both gathers and their
     PyTorch calls at the second shape, a cross-check of items 6-7's
     device times (printed, gating nothing).  It comes last because
     after a profiler session every launch in the process costs the host
     more.

With --chains, item 9 alone:
    python tools/bench_torch_gather.py --chains

The three readings of items 6-7:
  device ms  one CUDA graph that captures DEVICE_CALLS calls, replayed
             once warm between two CUDA events, over DEVICE_CALLS: the
             card's time, free of the host's launch path;
  call ms    one call between two CUDA events (median of 5 warm runs):
             the card waits while the host runs the call's launch path;
  host us    the host clock over HOST_CALLS warm calls, stopped before
             the one synchronize at the end: the launch path's cost.
Items 1-5 and 9 are call ms.  Each kernel is checked against its plain
version first (the gathers at both shapes and on index views that start
4, 8 and 12 bytes into their storage).  Needs a CUDA card.  Run from the
repo root:
    python tools/bench_torch_gather.py

chip_smoke.py runs items 8 and 9 (`print_split`, `print_chains`) on its
counted probe path and takes items 6-7's readings (`gather_readings`)
apart from it: a graph's launches run at its replays, not where the
wrappers count them.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHAIN = 4096
CHAIN_LONG = 65536
CHAIN_ODD = 4093     # a table whose step takes the reciprocal
DEVICE_CALLS = 20
HOST_CALLS = 1000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
# kernel -> shape name -> (R, T, K) or (T, N): the tool's shape (it fits
# in L2, so a warm replay reads it from there) and one of the same layout
# past L2, where a gather is bound by device memory
GATHER_SHAPES = {
    "gather_rows": {"tool": (1024, 256, 1024), "bytes": (16384, 256, 1024)},
    "gather_table": {"tool": (256, 1 << 18), "bytes": (256, 1 << 25)},
}


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = DEVICE_CALLS) -> float:
    """Milliseconds of one fn() on the card: a CUDA graph of `calls`
    calls, replayed once warm between two events, over `calls`.  A
    capture that fails raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / calls


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Microseconds of the host's clock per warm fn(), over `calls`
    calls, stopped before the one synchronize at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def readings(fn) -> dict:
    """device ms, call ms and host us of fn (module docstring)."""
    return {"device_ms": device_ms(fn), "call_ms": cuda_ms(fn),
            "host_us": host_us(fn)}


def _offset_view(t, elements: int):
    """A contiguous copy of t that starts `elements` int32 past the start
    of its storage."""
    import torch

    flat = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    flat[elements:] = t.reshape(-1)
    return flat[elements:].view(t.shape)


def gather_readings(dev) -> dict:
    """For each gather and shape of GATHER_SHAPES: the kernel checked
    equal to its plain version (at the tool shape also on index views
    4, 8 and 12 bytes into their storage), and the readings of the
    kernel, of its plain version (device ms) and of its PyTorch call;
    the bytes a gather must move and their bound at the memory rate."""
    import numpy as np
    import torch

    from tpujpeg_torch.ops import probes

    rng = np.random.default_rng(1)
    out = {}
    for name, shapes in GATHER_SHAPES.items():
        for shape_name, shape in shapes.items():
            if name == "gather_rows":
                R, T, K = shape
                t = torch.as_tensor(
                    rng.integers(-9, 255, (R, T)).astype(np.int32)).to(dev)
                i = torch.as_tensor(
                    rng.integers(0, T, (R, K)).astype(np.int32)).to(dev)
                il = i.long()
                kernel, plain = probes.gather_rows, probes.gather_rows_plain

                def library():
                    return torch.gather(t, 1, il)
            else:
                T, N = shape
                t = torch.as_tensor(
                    rng.integers(-9, 255, T).astype(np.int32)).to(dev)
                i = torch.as_tensor(
                    rng.integers(0, T, N).astype(np.int32)).to(dev)
                il = i.long()
                kernel, plain = probes.gather_table, probes.gather_table_plain

                def library():
                    return t.index_select(0, il)
            got = kernel(t, i)
            want = plain(t, i)
            if not (torch.equal(got, want) and torch.equal(library(), want)):
                raise RuntimeError(f"{name} {list(shape)}: kernel != plain")
            views = (1, 2, 3) if shape_name == "tool" else ()
            for e in views:
                iv = _offset_view(i, e)
                if not torch.equal(kernel(t, iv), want):
                    raise RuntimeError(f"{name} {list(shape)}: kernel != "
                                       f"plain on an index view {4 * e} "
                                       f"bytes into its storage")
            n_bytes = sum(x.numel() * x.element_size() for x in (t, i, got))
            err = (got.long() - want.long()).abs()
            out[name, shape_name] = {
                "shape": list(shape), "lookups": i.numel(),
                "max_abs_err": int(err.max()) if err.numel() else 0,
                "bytes": n_bytes,
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                "kernel": readings(lambda: kernel(t, i)),
                "plain_device_ms": device_ms(lambda: plain(t, i)),
                "library": readings(library),
                "offset_views_equal": [4 * e for e in views],
            }
            del t, i, il, got, want, err
            torch.cuda.empty_cache()
    return out


def launch_path_us(dev) -> dict:
    """Microseconds per warm call of each part of one `gather_rows` call
    at the tool shape, of the whole call, of torch.gather on the same
    inputs, and of one `gather_table` call and index_select at its tool
    shape, over HOST_CALLS calls each (item 8)."""
    import torch

    from tpujpeg_torch.ops import probes
    from tpujpeg_torch.runtime import kernels

    R, T, K = GATHER_SHAPES["gather_rows"]["tool"]
    t = torch.zeros((R, T), dtype=torch.int32, device=dev)
    i = torch.zeros((R, K), dtype=torch.int32, device=dev)
    il = i.long()
    Tt, N = GATHER_SHAPES["gather_table"]["tool"]
    t1 = torch.zeros(Tt, dtype=torch.int32, device=dev)
    i1 = torch.zeros(N, dtype=torch.int32, device=dev)
    i1l = i1.long()
    out = torch.empty_like(i)
    stream = kernels.current_stream(t.device)
    blocks, group = probes.gather_rows_geometry(
        R, T, K, probes.sm_count(t.device.index))
    lib = kernels.library()
    args = (t.data_ptr(), i.data_ptr(), out.data_ptr(), R, T, K, blocks,
            group, stream)

    def checks():
        kernels.check_cuda_tensor("t", t, torch.int32, 2)
        kernels.check_cuda_tensor("idx", i, torch.int32, 2)

    parts = {
        "checks": checks,
        "geometry": lambda: probes.gather_rows_geometry(
            R, T, K, probes.sm_count(t.device.index)),
        "empty_like": lambda: torch.empty_like(i),
        "current_stream": lambda: kernels.current_stream(t.device),
        "library": kernels.library,
        "entry_lookup": lambda: getattr(lib, kernels.KERNELS["gather_rows"]),
        "launch": lambda: kernels.launch("gather_rows", *args),
        "wrapper": lambda: probes.gather_rows(t, i),
        "torch.gather": lambda: torch.gather(t, 1, il),
        "gather_table wrapper": lambda: probes.gather_table(t1, i1),
        "index_select": lambda: t1.index_select(0, i1l),
    }
    return {name: host_us(fn) for name, fn in parts.items()}


def profiler_ms(dev) -> list[str]:
    """torch.profiler's device time per call of every kernel that the two
    gathers and their PyTorch calls launch at the second shape (item
    10): lines to print.  A cross-check that gates nothing: a profiler
    that shows no device time gives a line that says so."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpujpeg_torch.ops import probes

    rng = np.random.default_rng(2)
    R, T, K = GATHER_SHAPES["gather_rows"]["bytes"]
    Tt, N = GATHER_SHAPES["gather_table"]["bytes"]
    t2 = torch.as_tensor(rng.integers(0, 255, (R, T)).astype(np.int32)).to(dev)
    i2 = torch.as_tensor(rng.integers(0, T, (R, K)).astype(np.int32)).to(dev)
    t1 = t2[0].contiguous()
    i1 = torch.as_tensor(rng.integers(0, Tt, N).astype(np.int32)).to(dev)
    i2l, i1l = i2.long(), i1.long()
    calls = {"gather_rows": lambda: probes.gather_rows(t2, i2),
             "torch.gather": lambda: torch.gather(t2, 1, i2l),
             "gather_table": lambda: probes.gather_table(t1, i1),
             "index_select": lambda: t1.index_select(0, i1l)}
    lines = []
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        found = False
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us > 0 and ev.count:
                found = True
                lines.append(f"profiler, {name}: {ev.key[:60]} x{ev.count}: "
                             f"{dev_us / ev.count / 1e3:.4f} ms a launch")
        if not found:
            lines.append(f"profiler, {name}: no device time recorded "
                         f"(not measured)")
    return lines


def report(label: str, ms: float, n_lookups: int, beside: str = "") -> None:
    print(f"{label:<56s} {ms:9.4f} ms  {ms / n_lookups * 1e6:9.3f} ns/lookup"
          f"{beside}")


def print_gathers(smi: str, gathers: dict) -> None:
    """Items 6-7: print the result of gather_readings."""
    lib_names = {"gather_rows": "torch.gather", "gather_table": "index_select"}
    for (name, shape_name), r in gathers.items():
        n = r["lookups"]
        for who, rd in ((f"kernel {name}", r["kernel"]),
                        (lib_names[name], r["library"])):
            print(f"{who} {r['shape']} ({shape_name} shape): device "
                  f"{rd['device_ms']:.4f} ms ({rd['device_ms'] / n * 1e6:.4f}"
                  f" ns/lookup; a graph of {DEVICE_CALLS} calls), call "
                  f"{rd['call_ms']:.4f} ms, host {rd['host_us']:.2f} us a "
                  f"call [{smi}]")
        share = (f", share {r['bound_ms'] / r['kernel']['device_ms']:.3f} "
                 f"(kernel) and "
                 f"{r['bound_ms'] / r['library']['device_ms']:.3f} "
                 f"({lib_names[name]})" if shape_name == "bytes"
                 else " (L2-resident on replay: no share)")
        print(f"  {name} {r['shape']}: equal to the plain version (device "
              f"{r['plain_device_ms']:.4f} ms)"
              + (f" and on index views {r['offset_views_equal']} bytes into"
                 f" their storage" if r["offset_views_equal"] else "")
              + f"; {r['bytes']} bytes, bound {r['bound_ms']:.4f} ms{share}")


def print_split(dev, smi: str) -> None:
    """Item 8: print launch_path_us."""
    print("host us per warm gather call, by part (1,000 calls each): "
          + ", ".join(f"{k} {v:.2f}" for k, v in launch_path_us(dev).items())
          + f" [{smi}]")


def _chain_table(dev, T: int = CHAIN):
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    return torch.as_tensor(
        rng.integers(0, T, (T, 1)).astype(np.int32)).to(dev)


def print_chains(dev) -> None:
    """Item 9, call ms: each chain source checked against its plain
    version (at CHAIN and CHAIN_LONG steps, and on a CHAIN_ODD-entry
    table), then timed at CHAIN and CHAIN_LONG steps."""
    import torch

    from tpujpeg_torch.ops import probes

    tbl = _chain_table(dev)
    odd = _chain_table(dev, CHAIN_ODD)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    want = {n: probes.chain_plain(tbl, seed, n) for n in (CHAIN, CHAIN_LONG)}
    want_odd = probes.chain_plain(odd, seed, CHAIN)
    for source in probes.CHAIN_SOURCES:
        for n in (CHAIN, CHAIN_LONG):
            got = probes.chain(tbl, seed, n, source)
            torch.cuda.synchronize()
            assert torch.equal(got, want[n]), (source, n)
        assert torch.equal(probes.chain(odd, seed, CHAIN, source),
                           want_odd), (source, CHAIN_ODD)
        short = cuda_ms(lambda: probes.chain(tbl, seed, CHAIN, source))
        long = cuda_ms(lambda: probes.chain(tbl, seed, CHAIN_LONG, source))
        step_ns = (long - short) / (CHAIN_LONG - CHAIN) * 1e6
        report(f"kernel chain, table from {source}, {CHAIN} dependent",
               short, CHAIN,
               f"  ({CHAIN_LONG} steps {long:.4f} ms; {step_ns:.2f} ns per "
               f"dependent step net of launch)")


def chain_readings(dev) -> dict:
    """Item 9, device time: for each chain source, ns per dependent step
    from a CUDA graph (`device_ms`) of the chain at CHAIN and CHAIN_LONG
    steps and of its latency floor (tpj_chain_floor over a table that is
    one permutation cycle of CHAIN entries), and the share floor / chain
    at CHAIN_LONG.  Each walk is checked first: the chain against its
    plain version, the floor against the cycle."""
    import numpy as np
    import torch

    from tpujpeg_torch.ops import probes
    from tpujpeg_torch.runtime import kernels

    lib = kernels.library()
    tbl = _chain_table(dev)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    perm = np.random.default_rng(4).permutation(CHAIN)
    cyc = np.empty(CHAIN, np.int32)
    cyc[perm] = np.roll(perm, -1)
    cycle = torch.as_tensor(cyc).to(dev)
    start = torch.tensor([int(perm[0])], dtype=torch.int32, device=dev)
    want = {n: probes.chain_plain(tbl, seed, n) for n in (CHAIN, CHAIN_LONG)}
    out = torch.empty(1, dtype=torch.int32, device=dev)

    def floor(n, src):
        # the current stream: a graph captures on its own
        rc = lib.tpj_chain_floor(cycle.data_ptr(), start.data_ptr(),
                                 out.data_ptr(), CHAIN, n, src,
                                 kernels.current_stream(dev))
        if rc:
            raise RuntimeError(f"tpj_chain_floor failed: error {rc}")

    res = {}
    for source, src in probes.CHAIN_SOURCES.items():
        r = {}
        for n in (CHAIN, CHAIN_LONG):
            if not torch.equal(probes.chain(tbl, seed, n, source), want[n]):
                raise RuntimeError(f"chain from {source}: kernel != plain")
            r[f"ns_{n}"] = device_ms(
                lambda: probes.chain(tbl, seed, n, source)) / n * 1e6
            floor(n, src)
            if int(out[0]) != int(perm[n % CHAIN]):
                raise RuntimeError(f"floor from {source}: off the cycle")
            r[f"floor_ns_{n}"] = device_ms(lambda: floor(n, src)) / n * 1e6
        r["share"] = r[f"floor_ns_{CHAIN_LONG}"] / r[f"ns_{CHAIN_LONG}"]
        res[source] = r
    return res


def print_chain_readings(smi: str, r: dict) -> None:
    """Item 9, device time: print the result of chain_readings."""
    for source, x in r.items():
        print(f"kernel chain, table from {source}, device ns per dependent "
              f"step (a graph of {DEVICE_CALLS} calls): {CHAIN} steps "
              f"{x[f'ns_{CHAIN}']:.2f}, {CHAIN_LONG} steps "
              f"{x[f'ns_{CHAIN_LONG}']:.2f}; latency floor (idx = t[idx], "
              f"one cycle) {x[f'floor_ns_{CHAIN}']:.2f} / "
              f"{x[f'floor_ns_{CHAIN_LONG}']:.2f}; share {x['share']:.3f} "
              f"[{smi}]")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", action="store_true",
                    help="item 9 alone")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from tpujpeg_torch.ops import probes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    if args.chains:
        print_chains(dev)
        print_chain_readings(smi, chain_readings(dev))
        print(f"all times on: {smi}")
        return 0
    rng = np.random.default_rng(0)
    N = 1 << 20

    def on_card(a):
        return torch.as_tensor(a).to(dev)

    lut64k = on_card(rng.integers(0, 255, 1 << 16, np.int32))
    lut256 = on_card(rng.integers(0, 255, 256, np.int32))
    idx64k = on_card(rng.integers(0, 1 << 16, N).astype(np.int32))
    idx256 = on_card(rng.integers(0, 256, N).astype(np.int32))
    idx64k_l, idx256_l = idx64k.long(), idx256.long()

    report("torch index_select, 64Ki table, 1M independent",
           cuda_ms(lambda: lut64k.index_select(0, idx64k_l)), N)
    report("torch index_select, 256 table, 1M independent",
           cuda_ms(lambda: lut256.index_select(0, idx256_l)), N)

    arange = torch.arange(256, device=dev)
    lut256_f = lut256.to(torch.float32)

    def onehot_gather():
        oh = (idx256[:, None] == arange[None, :]).to(torch.float32)
        return torch.matmul(oh, lut256_f).to(torch.int32)

    check = onehot_gather()
    assert torch.equal(check, probes.gather_table_plain(lut256, idx256))
    report("one-hot torch.matmul, 256 table, 1M independent",
           cuda_ms(onehot_gather), N)

    rows = on_card(rng.integers(-1000, 1000, (2560, 256 * 64), np.int32))
    perm = on_card(rng.permutation(2560)).long()
    report("torch index_select, 2560 rows x 64 KiB (lane permutation)",
           cuda_ms(lambda: rows.index_select(0, perm)), 2560)
    del rows
    rows64 = on_card(rng.integers(-1000, 1000, (N, 64), np.int32))
    perm64 = on_card(rng.permutation(N)).long()
    report("torch index_select, 1M rows x 256 B (spec assemble)",
           cuda_ms(lambda: rows64.index_select(0, perm64)), N)
    del rows64, perm64

    R, K = 1024, 1024
    tbl2d = on_card(np.broadcast_to(
        rng.integers(0, 255, 256, np.int32), (R, 256)).copy())
    idx2d = on_card(rng.integers(0, 256, (R, K)).astype(np.int32))
    idx2d_l = idx2d.long()
    report("torch.gather, [1024, 256] tables, 1M",
           cuda_ms(lambda: torch.gather(tbl2d, 1, idx2d_l)), R * K)
    del tbl2d, idx2d, idx2d_l

    print_gathers(smi, gather_readings(dev))
    print_split(dev, smi)
    print_chains(dev)
    print_chain_readings(smi, chain_readings(dev))
    for line in profiler_ms(dev):
        print(line)
    print(f"all times on: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
