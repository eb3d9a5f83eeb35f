"""Profiling: the program's spans and counters, and the device trace.

`span(name, **attrs)` marks one stage of the decode on whatever thread
runs it.  Its duration is always added to the current call's record
(`Call`: summed seconds by span name, and counters, `count`), which
`BatchDecoder` turns into its `BatchStats`.  Only while a torch profiler
is recording is a span also logged, stamped on the clock of the
profiler's own events (`time.time_ns()`'s, `_Clock`), with its thread,
its parent span and the call's and chunk's ids; on the thread the
profiler records it also opens the profiler's own event
"tpujpeg.<name>" (`_RECORD`).  With no profiler recording, a span is two
`perf_counter_ns` reads and one locked sum, and nothing of the profiler
is entered.

`bind` carries the call (and the span that submitted the work) onto a
pool thread, with an optional queue span from submit to start.

`device_trace` is the one exporter: it records a torch.profiler trace
(the card's kernels and copies unless the caller names the CPU) and
writes it as a Chrome trace that Perfetto opens, with every span logged
inside it, on every thread, once.  `device_busy` reads the device's busy
time inside one span of a written trace, and `idle_gaps` the device's
longest idle gaps, each named by the spans open when it happened.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"

PREFIX = "tpujpeg."          # a span's name in the trace
SPAN_CAT = "tpujpeg_span"    # the trace category of a logged span

# the trace categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_ids = itertools.count(1)    # call and span ids (next() holds the GIL)

# The profiler's event of a span on the thread it records: the fast form
# of record_function, which keeps the GIL.  record_function's operator
# releases it on entry and on exit, so with the pools busy in Python each
# span would wait up to two switch intervals outside its own time, and
# the wait would leave the span it belongs to.
_RECORD = torch._C._profiler._RecordFunctionFast


class SpanRecord(NamedTuple):
    """One logged span.  start_ns / end_ns are on time.time_ns()'s clock,
    thread the native thread id, parent the enclosing span's id (0 for
    none), chunk the chunk's id within its call (-1 for none), attrs
    ((key, value), ...)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int
    call: int
    chunk: int
    attrs: tuple


class Call:
    """One decode call's record: seconds summed by span name over every
    thread, the call's counters, and the spans logged while a profiler
    recorded.  Pool threads add to it under its lock (a logged span is
    one list append, which the GIL keeps whole)."""

    def __init__(self):
        self.id = next(_ids)
        self.seconds: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.spans: list[SpanRecord] = []
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n


class _Thread(threading.local):
    """A thread's place in the program: its call, the span it works for
    (bound from the submitting thread), its chunk, its open logged spans
    and its native id."""

    call: Call | None = None
    parent: int = 0
    chunk: int = -1

    def __init__(self):
        self.stack: list = []
        self.tid = threading.get_native_id()


_here = _Thread()
_sinks: tuple = ()           # the span logs of the open device_trace blocks
_sinks_lock = threading.Lock()


class _Clock:
    """perf_counter_ns -> the profiler's clock (time.time_ns, the epoch):
    spans read only the monotonic clock, and a logged one is moved by the
    offset taken at its call's start (`call`, `device_trace`), so logging
    reads no other clock."""

    offset = time.time_ns() - time.perf_counter_ns()

    @classmethod
    def anchor(cls) -> None:
        cls.offset = time.time_ns() - time.perf_counter_ns()


def _emit(name: str, t0: int, t1: int, sid: int, parent: int,
          call: Call | None, chunk: int, attrs: tuple) -> None:
    off = _Clock.offset
    rec = SpanRecord(name, t0 + off, t1 + off, _here.tid, sid, parent,
                     0 if call is None else call.id, chunk, attrs)
    if call is not None:
        call.spans.append(rec)
    for sink in _sinks:
        sink.append(rec)


class span:
    """A stage of the program (module docstring).  chunk= names the
    chunk the stage works on (children inherit it in the log); `set`
    adds attributes known only at the end (a route, an outcome)."""

    __slots__ = ("name", "chunk", "attrs", "_call", "_t0", "_logged", "_id",
                 "_rf")

    def __init__(self, name: str, chunk: int | None = None, **attrs):
        self.name = name
        self.chunk = chunk
        self.attrs = attrs
        self._logged = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "span":
        self._call = _here.call
        if _autograd_profiler._is_profiler_enabled:
            self._open_logged()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._call is not None:
            self._call.add(self.name, (t1 - self._t0) * 1e-9)
        if self._logged:
            self._close_logged(t1)
        return False

    def _open_logged(self) -> None:
        stack = _here.stack
        if self.chunk is None:
            self.chunk = stack[-1].chunk if stack else _here.chunk
        self._id = next(_ids)
        self._rf = None
        if torch.autograd._profiler_enabled():
            # the profiler records this thread: its own event too
            self._rf = _RECORD(PREFIX + self.name)
            self._rf.__enter__()
        stack.append(self)
        self._logged = True

    def _close_logged(self, t1: int) -> None:
        stack = _here.stack
        stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _emit(self.name, self._t0, t1, self._id,
              stack[-1]._id if stack else _here.parent, self._call,
              self.chunk, tuple(self.attrs.items()))


def count(name: str, n: int = 1) -> None:
    """Add n to the current call's counter `name` (no call: nothing)."""
    call = _here.call
    if call is not None:
        call.count(name, n)


@contextlib.contextmanager
def call():
    """One call of the program on this thread: a fresh `Call` record,
    current until the block ends, under its root span "decode"."""
    rec = Call()
    prev = _here.call
    _here.call = rec
    if _autograd_profiler._is_profiler_enabled:
        _Clock.anchor()
    try:
        with span("decode"):
            yield rec
    finally:
        _here.call = prev


def bind(fn, queue: str | None = None, chunk: int | None = None):
    """fn, to run on a pool thread as part of the current call: its spans
    add to the call's record, their parent is the span open here at
    submit, and chunk= (if given) is theirs.  queue= names a span from
    now (the submit) to the moment fn starts."""
    call_ = _here.call
    stack = _here.stack
    parent = stack[-1]._id if stack else _here.parent
    if chunk is None:
        chunk = stack[-1].chunk if stack else _here.chunk
    t_submit = time.perf_counter_ns()
    logged = _autograd_profiler._is_profiler_enabled

    def run(*args, **kwargs):
        here = _here
        prev = here.call, here.parent, here.chunk
        here.call, here.parent, here.chunk = call_, parent, chunk
        try:
            if queue is not None:
                t_start = time.perf_counter_ns()
                if call_ is not None:
                    call_.add(queue, (t_start - t_submit) * 1e-9)
                if logged:
                    _emit(queue, t_submit, t_start, next(_ids), parent,
                          call_, chunk, ())
            return fn(*args, **kwargs)
        finally:
            here.call, here.parent, here.chunk = prev

    return run


# -- the trace ---------------------------------------------------------------


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Record a profiler trace of the block into log_dir/trace.json (open
    with Perfetto), with every span logged in the block.  Yields the
    torch.profiler.profile.

        with device_trace("/tmp/tpujpeg-trace"):
            decoder.decode(batch, fetch=False)

    device="cpu" records host activity only."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    sink: list[SpanRecord] = []
    _add_sink(sink)
    _Clock.anchor()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _add_sink(sink, remove=True)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        _merge_spans(path, sink)


def _add_sink(sink: list, remove: bool = False) -> None:
    """Open or close a span log: `_sinks` is replaced, never changed in
    place, so a span reads it without a lock."""
    global _sinks
    with _sinks_lock:
        _sinks = tuple(x for x in _sinks if x is not sink) + (
            () if remove else (sink,))


def _merge_spans(path: str, spans: list[SpanRecord]) -> None:
    """Write the logged spans into a Chrome trace, each once: the
    profiler's own event of a span (on the thread it records) makes way
    for the logged one, which carries the ids and attributes.  Times on
    the trace's clock: microseconds after its baseTimeNanoseconds."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [e for e in trace["traceEvents"]
              if not (e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(PREFIX))]
    for s in spans:
        events.append({
            "ph": "X", "cat": SPAN_CAT, "name": PREFIX + s.name,
            "pid": pid, "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "call": s.call,
                     "chunk": s.chunk, **dict(s.attrs)}})
    trace["traceEvents"] = events
    with open(path, "w") as f:
        json.dump(trace, f)


def _events(trace_path: str) -> list:
    with open(trace_path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _busy(events, lo: float, hi: float):
    """The union of the device's kernel, copy and memset intervals
    clipped to [lo, hi): sorted by start, each interval counts only past
    the end reached so far.  Returns (busy, merged intervals, events
    counted)."""
    spans = sorted(
        (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    busy, end, n = 0.0, lo, 0
    merged: list = []
    for a, b in spans:
        if b <= a:
            continue
        n += 1
        if b > end:
            busy += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            end = b
    return busy, merged, n


def device_busy(trace_path: str, span: str) -> dict:
    """The device's busy time inside the host span named `span` (its
    first occurrence) of a written trace: the union of kernel, copy and
    memset intervals clipped to the span, in microseconds, with the span's
    length and the number of device events counted."""
    events = _events(trace_path)
    window = next((e for e in events
                   if e.get("name") == span and e.get("ph") == "X"), None)
    if window is None:
        raise ValueError(f"no span {span!r} in {trace_path}")
    lo = float(window["ts"])
    hi = lo + float(window["dur"])
    busy, _, n = _busy(events, lo, hi)
    return {"busy_us": busy, "window_us": hi - lo, "events": n}


def idle_gaps(trace_path: str, top: int = 10) -> list[dict]:
    """The device's `top` longest idle gaps in a trace written by
    device_trace, from the first program span to the end of the last:
    gaps in `device_busy`'s union of kernel, copy and memset intervals.
    Each gap (longest first): its start and length in microseconds, the
    innermost span open at its middle on the dispatching thread (the
    thread of the `decode` spans; "-" for none), and the innermost span
    each other thread had open then."""
    events = _events(trace_path)
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]
    if not spans:
        raise ValueError(f"no program span in {trace_path}")
    roots = [e for e in spans if e["name"] == PREFIX + "decode"]
    main = (roots or sorted(spans, key=lambda e: -float(e["dur"])))[0]["tid"]
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    _, merged, _ = _busy(events, lo, hi)
    gaps, at = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > at:
            gaps.append((a - at, at))
        at = max(at, b)
    gaps.sort(reverse=True)

    def innermost(t, tid):
        open_ = [e for e in spans if e["tid"] == tid
                 and float(e["ts"]) <= t < float(e["ts"]) + float(e["dur"])]
        if not open_:
            return None
        return min(open_, key=lambda e: float(e["dur"]))["name"][len(PREFIX):]

    others = sorted({e["tid"] for e in spans} - {main}, key=str)
    out = []
    for dur, start in gaps[:top]:
        t = start + dur / 2
        pool = [n for n in (innermost(t, tid) for tid in others) if n]
        out.append({"start_us": start, "us": dur,
                    "span": innermost(t, main) or "-", "pool": pool})
    return out
