"""Profiling helpers (counterpart of tpujpeg/utils/profiling.py).

`device_trace` records a torch.profiler trace (the card's kernels and
copies unless the caller names the CPU) and writes it as a Chrome trace
that Perfetto opens; `scope` labels a host span in it
(torch.profiler.record_function); `device_busy` reads a written trace
back: the union of the device's kernel and copy intervals inside one
labelled span.  `StageTimer` writes wall-clock stage records as JSONL,
the JAX package's records.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.profiler import record_function

TRACE_FILE = "trace.json"

# the trace categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Record a profiler trace of the block into log_dir/trace.json (open
    with Perfetto).  Yields the torch.profiler.profile.

        with device_trace("/tmp/tpujpeg-trace"):
            decoder.decode(batch, fetch=False)

    device="cpu" records host activity only."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


scope = record_function  # a labelled span in the trace


def device_busy(trace_path: str, span: str) -> dict:
    """The device's busy time inside the host span named `span` (its
    first occurrence) of a written trace: the union of kernel, copy and
    memset intervals clipped to the span, in microseconds, with the span's
    length and the number of device events counted."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    window = next((e for e in events
                   if e.get("name") == span and e.get("ph") == "X"), None)
    if window is None:
        raise ValueError(f"no span {span!r} in {trace_path}")
    lo = float(window["ts"])
    hi = lo + float(window["dur"])
    spans = sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    busy, end, n = 0.0, lo, 0
    for a, b in spans:
        if b <= a:
            continue
        n += 1
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"busy_us": busy, "window_us": hi - lo, "events": n}


class StageTimer:
    """Wall-clock stage timing emitted as JSONL (append-only)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {"stage": name, "s": round(time.perf_counter() - t0, 6),
                   **meta}
            self.records.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
