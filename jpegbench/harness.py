"""The benchmark of tpujpeg_torch's batch decode: one cell, one run.

    python3 jpegbench/run.py --workload <config>.<traffic> --seed N \\
        --seconds S --trace 0|1

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix.  Everything that belongs to one of them, or to one
per-layer metric, is a file of its own that the harness finds by name:

- jpegbench/configs/<config>.json: the deployment's pictures (sizes,
  sampling, quality, restart policy, content) and the BatchDecoder's
  settings;
- jpegbench/traffic/<traffic>.json: the loop, the images of a call, the
  warm calls and how many answers the reference checks;
- jpegbench/metrics/<metric>.py: `read(ctx)` -> a number, or None where
  the cell gives it nothing to read.

An end-to-end metric named `<reading>.<tag>` is the reading `<reading>`
(one of `images_per_s`, `device_peak_MB`, `setup_s`) under a bound of
its own, for the cells it lists.

A run: the seed's corpus (corpus.py) is encoded on a pool of processes
while torch, CUDA and the program's libraries load; a BatchDecoder is
built from the configuration; warm calls decode one epoch, so every
picture and shape the traffic sends; set-up's objects leave the
collector's view (gc.freeze); then calls run back to back for
`--seconds` (whole calls: the window ends when the last call returns),
with the profiler on under `--trace 1`.  Calls draw their streams as a
shuffling loader does (call_order), and the seed draws the answers
checked.
Once the window has closed and the card's peak memory is read, the
program is closed and a sample of the answers is compared with the plain
reference (check.py).  The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, corpus, devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpujpeg", "bench", "benchmarks",
             "tools")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_metric(name: str):
    """The reader module of one per-layer metric (metrics/<name>.py)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"jpegbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def seed_key(seed: int) -> int:
    """The seed as a non-negative integer for numpy's generators."""
    return seed % (1 << 64)


def call_order(traffic: dict, n_pictures: int, seed: int, call: int):
    """The corpus indices of call `call` (warm calls are negative).

    As a shuffling loader: each epoch is a fresh permutation of the whole
    corpus drawn from the seed, cut into calls of `images_per_call`
    (the warm calls are epoch -1)."""
    per = traffic["images_per_call"]
    epoch, k = divmod(call, n_pictures // per)
    rng = np.random.default_rng([seed, 0xC0A, epoch % (1 << 32)])
    return rng.permutation(n_pictures)[k * per:(k + 1) * per].tolist()


@dataclass
class Window:
    """What the measured window saw."""

    seconds: float = 0.0
    walls: list = field(default_factory=list)      # each call's seconds
    stats: list = field(default_factory=list)      # each call's BatchStats
    calls: list = field(default_factory=list)      # each call's indices
    attempted: int = 0
    returned: int = 0
    failed: int = 0
    wrong_size: int = 0
    peak_bytes: int = 0
    gc_pauses: list = field(default_factory=list)  # full collections, s
    host: list = field(default_factory=list)       # host_reading() a call
    trace: devtrace.Trace | None = None


@dataclass
class Context:
    """What a per-layer metric's reader gets."""

    streams: list
    window: Window
    device_kind: str
    peaks: dict


def host_reading() -> tuple:
    """(this process's CPU seconds, its resident bytes): read after each
    call, so that a slower stretch of the window can be told apart as
    more CPU time spent, more memory held, or the same CPU time taking
    longer."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        rss = 0
    return ru.ru_utime + ru.ru_stime, rss


def host_thirds(win: "Window") -> str:
    """The window's thirds, each as the median call, the median CPU
    seconds of this process a call and the resident memory at its end."""
    walls, rows = np.asarray(win.walls), np.asarray(win.host, dtype=float)
    if walls.size < 3 or len(rows) != walls.size + 1:
        return "too few calls"
    cpu = np.diff(rows[:, 0])
    return " | ".join(
        f"call {np.median(walls[t]) * 1e3:.3f} ms, cpu "
        f"{np.median(cpu[t]) * 1e3:.3f} ms, rss "
        f"{rows[t[-1] + 1, 1] / 1e6:.1f} MB"
        for t in np.array_split(np.arange(walls.size), 3))


class NoCard(Exception):
    """The cell asks for more CUDA cards than this machine has."""


def run_window(dec, streams, traffic, seed, seconds, trace, device_type,
               sample: check.Sample) -> Window:
    """Calls back to back until `seconds` have passed; whole calls."""
    import torch

    win = Window()
    started = [0.0]

    def full_collections(phase, info):
        if info["generation"] == 2:
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                win.gc_pauses.append(time.perf_counter() - started[0])

    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.callbacks.append(full_collections)
    try:
        with (devtrace.Capture(device_type) if trace
              else contextlib.nullcontext()) as cap, \
                devtrace.span(devtrace.WINDOW):
            t_start = time.perf_counter()
            win.host.append(host_reading())
            call = 0
            while True:
                idx = call_order(traffic, len(streams), seed, call)
                batch = [streams[i].data for i in idx]
                with devtrace.span(devtrace.SPANS[0]):
                    t0 = time.perf_counter()
                    outs = dec.decode(batch, fetch=traffic["fetch"],
                                      on_error=traffic["on_error"])
                    wall = time.perf_counter() - t0
                with devtrace.span(devtrace.SPANS[1]):
                    win.walls.append(wall)
                    win.stats.append(dec.stats.as_dict())
                    win.calls.append(idx)
                    win.attempted += len(idx)
                    missing = 0
                    for i, out in zip(idx, outs):
                        if out is None:
                            missing += 1
                        elif not check.size_ok(out, streams[i].width,
                                               streams[i].height):
                            win.wrong_size += 1
                    win.failed += max(missing, len(dec.stats.failures))
                    win.returned += len(idx) - missing
                    sample.offer(idx, outs)
                    del outs
                    win.host.append(host_reading())
                call += 1
                if time.perf_counter() - t_start >= seconds:
                    break
            win.seconds = time.perf_counter() - t_start
            t_stop = time.perf_counter()
    finally:
        gc.callbacks.remove(full_collections)
    if device_type == "cuda":
        win.peak_bytes = int(torch.cuda.max_memory_allocated())
    if cap is not None:
        t1 = time.perf_counter()
        events = cap.events()
        t2 = time.perf_counter()
        win.trace = devtrace.Trace.of(events)
        log(f"trace: {len(events)} events; profiler stop "
            f"{t1 - t_stop:.3f} s, events {t2 - t1:.3f} s, reduction "
            f"{time.perf_counter() - t2:.3f} s")
    return win


def card_power() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: dict, config: dict, traffic: dict, spec: dict, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             workers: int | None = None, wrap_decoder=None) -> dict:
    """One run of a cell.  Returns the result line (a dict) with the
    numbers compared under its last key, "checks".  Raises NoCard where
    device is "cuda" and the machine has fewer cards than the cell asks.

    wrap_decoder (tests only) wraps the BatchDecoder the window drives."""
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError(f"traffic {traffic['name']}: the harness drives a "
                         "closed loop of one caller")
    seed = seed_key(seed)
    split = {}
    n_workers = corpus.worker_count() if workers is None else workers
    pending = corpus.start(config, seed, n_workers)
    try:
        t0 = time.perf_counter()
        import torch

        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < cell["chips"]:
                raise NoCard(
                    f"needs {cell['chips']} CUDA card(s): is_available "
                    f"{torch.cuda.is_available()}, count "
                    f"{torch.cuda.device_count()}")
            torch.cuda.init()
            torch.zeros(1, device=dev)
        from tpujpeg_torch.runtime.batch import BatchDecoder

        split["import_and_cuda_init_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        from tpujpeg_torch.runtime import host, kernels

        if dev.type == "cuda":
            kernels.library()
        host._load_native()
        split["library_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        streams = pending.result()
        split["corpus_wait_s"] = time.perf_counter() - t0
    finally:
        pending.close()

    t0 = time.perf_counter()
    dec = BatchDecoder(device=device, **config["decoder"])
    if wrap_decoder is not None:
        dec = wrap_decoder(dec)
    for w in range(traffic["warm_calls"]):
        idx = call_order(traffic, len(streams), seed, -1 - w)
        dec.decode([streams[i].data for i in idx], fetch=traffic["fetch"],
                   on_error=traffic["on_error"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # what set-up made (torch's modules, the corpus, the warm calls'
    # survivors) leaves the collector's view, so that a full collection
    # in the window walks only what the window made
    gc.collect()
    gc.freeze()
    split["warm_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    sample = check.Sample(seed, traffic["check_images"])
    win = run_window(dec, streams, traffic, seed, seconds, trace, dev.type,
                     sample)
    backends = sorted({s["backend"] for s in win.stats})
    dec.close()
    del dec
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n_pic = len(streams)
    bits = sum(len(s.data) for s in streams) * 8
    pix = sum(s.width * s.height for s in streams)
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    log(f"corpus {n_pic} pictures, {pix / n_pic:.0f} px and "
        f"{sum(len(s.data) for s in streams) / n_pic / 1e3:.1f} KB each, "
        f"{bits / pix:.3f} bits/px")
    log(f"window {win.seconds:.3f} s, {len(win.walls)} calls, "
        f"{win.attempted} images, backends {'+'.join(backends)}")
    counts = {k: sum(s[k] for s in win.stats) for k in (
        "chunks", "fsm_k_retries", "fsm_slot_retries", "spec_sync_misses",
        "fsm_envelope_fallbacks", "fsm_malformed_fallbacks")}
    log("the program's counts over the window: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    pauses = win.gc_pauses
    log(f"gc: {len(pauses)} full collections in the window, "
        f"{sum(pauses):.3f} s in all, longest "
        f"{max(pauses, default=0.0):.3f} s")

    walls = np.asarray(win.walls)
    metrics = {}
    card = card_power() if dev.type == "cuda" else "cpu"
    log(f"card: {card}")
    if trace:
        ctx = Context(streams, win, kind, load_json(BENCH / "peaks.json"))
        for m in spec["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                log(f"{m['name']} {value} {m['unit']} ({card})")
    else:
        readings = {"images_per_s": win.returned / win.seconds,
                    "device_peak_MB": win.peak_bytes / 1e6,
                    "setup_s": setup_s}
        for m in spec["end_to_end"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = readings[m["name"].split(".", 1)[0]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"calls: median {np.median(walls) * 1e3:.3f} ms, p95 "
        f"{np.percentile(walls, 95) * 1e3:.3f} ms, max "
        f"{walls.max() * 1e3:.3f} ms over {walls.size} calls")
    log(f"the window's thirds: {host_thirds(win)}")

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": win.peak_bytes}
    if win.trace is not None:
        device_info["busy_s"] = win.trace.busy_s
        device_info["window_s"] = win.trace.window_s

    t0 = time.perf_counter()
    checks = check.compare(config, seed, sample, win.failed,
                           win.wrong_size)
    log(f"reference: {len(sample.kept)} answers compared in "
        f"{time.perf_counter() - t0:.3f} s")
    result = {"correct": check.passed(checks), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(spec, args.workload)
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")

    try:
        result = run_cell(cell, config, traffic, spec, args.seed,
                          args.seconds, bool(args.trace), "cuda", t_start)
    except NoCard as e:
        log(str(e))
        return 2
    found = forbidden_modules()
    if found:
        log(f"modules this benchmark may not load: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
