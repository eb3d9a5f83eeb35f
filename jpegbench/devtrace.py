"""The traced window: a torch.profiler capture and its reduction.

`Capture` records the window with CPU and CUDA activity.  The benchmark's
own spans (`span`) mark the window, each `decode` call and the
bookkeeping between calls.  `Trace.of` reads the profiler's events in
memory (nothing is written to disk) and keeps:

- the device's busy time: the union of kernel, copy and memset
  intervals clipped to the window span, the arithmetic of
  `tpujpeg_torch.utils.profiling.device_busy` (copied here, so that a
  change to the program cannot change the yardstick);
- each device operation's summed time, for `kernel_seconds` and the
  breakdown;
- the idle gaps between busy intervals, each named by the benchmark's
  span at the gap's middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "jpegbench."
WINDOW = PREFIX + "window"
SPANS = ("jpegbench.decode", "jpegbench.bookkeeping")
NAME_CHARS = 96


def span(name: str):
    """A labelled host span in the trace (costs next to nothing where
    the profiler is not recording)."""
    from torch.profiler import record_function

    return record_function(name)


class Capture:
    """The profiler over the measured window (CUDA activity on a card)."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        return False

    def events(self):
        return self.prof.profiler.kineto_results.events()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_seconds: dict = field(default_factory=dict)  # device op -> seconds
    gaps: list = field(default_factory=list)        # (seconds, name)

    def kernel_seconds(self, names) -> float:
        """Summed device time of the kernels whose name holds any of
        `names`."""
        return sum(s for op, s in self.op_seconds.items()
                   if any(n in op for n in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:top]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[n, s] for s, n in gaps]}

    @classmethod
    def of(cls, events) -> "Trace":
        """Reduce the profiler's events (KinetoEvent objects)."""
        from torch.autograd import DeviceType

        dev, ours = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev.append(e)
            elif e.name().startswith(PREFIX):
                a = e.start_ns()
                ours.append((a, a + e.duration_ns(), e.name()))
        win = [(a, b) for a, b, n in ours if n == WINDOW]
        if not win:
            raise ValueError(f"no span {WINDOW!r} in the trace")
        lo, hi = win[0]
        op_seconds: dict = {}
        spans = []
        for e in dev:
            if _category(e) not in DEVICE_CATS:
                continue
            a = e.start_ns()
            a, b = max(a, lo), min(a + e.duration_ns(), hi)
            if b <= a:
                continue
            name = e.name()
            op_seconds[name] = op_seconds.get(name, 0.0) + (b - a) * 1e-9
            spans.append((a, b))
        busy, merged = _union(spans, lo)
        gaps = sorted(((b - a, (a, b)) for a, b in _gaps(merged, lo, hi)),
                      reverse=True)[:10]
        return cls(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                   op_seconds=op_seconds,
                   gaps=[(g * 1e-9, _gap_name(ours, (a + b) // 2))
                         for g, (a, b) in gaps])


def _category(e) -> str:
    """The trace category of a device event: "kernel", "gpu_memcpy",
    "gpu_memset" or another (a host span's copy on the device timeline,
    "gpu_user_annotation").  Where the event does not say (older torch),
    a copy or a memset by its name, else a kernel."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if e.name().startswith(PREFIX) or (hasattr(e, "is_user_annotation")
                                       and e.is_user_annotation()):
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(spans, lo):
    """device_busy's union: sorted by start, each interval counts only
    past the end reached so far.  Returns (busy ns, merged intervals)."""
    spans.sort()
    busy, end = 0, lo
    merged: list = []
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = b
            else:
                merged.append([a, b])
            end = b
    return busy, merged


def _gaps(merged, lo, hi):
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def _gap_name(ours, t) -> str:
    """The benchmark's innermost span at time t: "decode",
    "bookkeeping", or "between" (inside the window, outside both)."""
    inside = sorted((b - a, n) for a, b, n in ours
                    if a <= t < b and n != WINDOW)
    return inside[0][1][len(PREFIX):] if inside else "between"
