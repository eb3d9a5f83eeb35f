"""tpujpeg_torch.utils.profiling's trace.

`device_trace` writes a Chrome trace on the CPU (the card's kernels and
copies are recorded only where there is one: chip_smoke.py phase 6f);
`device_busy` reads the device's busy time inside a labelled span back
from a trace.  The spans and counters: tests/test_torch_spans.py.
"""

import json

import pytest

from tpujpeg_torch.utils import profiling as tprof


def test_device_trace_on_the_cpu_writes_a_trace(tmp_path):
    import torch

    with tprof.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        with tprof.span("batch"):
            torch.ones(256).cumsum(0).sum()
    path = tmp_path / "trace" / tprof.TRACE_FILE
    trace = json.loads(path.read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "tpujpeg.batch" in names
    assert any(e.key == "tpujpeg.batch" for e in prof.key_averages())
    busy = tprof.device_busy(str(path), "tpujpeg.batch")
    assert busy["busy_us"] == 0.0 and busy["events"] == 0
    assert busy["window_us"] > 0
    with pytest.raises(ValueError, match="no span"):
        tprof.device_busy(str(path), "no such span")


def test_device_busy_is_the_union_inside_the_span(tmp_path):
    def ev(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        ev("batch", "user_annotation", 100, 100),       # window [100, 200)
        ev("k1", "kernel", 90, 20),                     # clipped: 10
        ev("k2", "kernel", 102, 6),                     # inside k1: 0 more
        ev("c1", "gpu_memcpy", 150, 20),                # 20
        ev("k3", "kernel", 160, 30),                    # overlaps c1: 20 more
        ev("m1", "gpu_memset", 195, 50),                # clipped: 5
        ev("late", "kernel", 300, 10),                  # outside
        ev("cpu", "cpu_op", 100, 100),                  # not the device
        ev("ann", "gpu_user_annotation", 100, 100),     # not work
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tprof.device_busy(str(path), "batch")
    assert got == {"busy_us": 55.0, "window_us": 100.0, "events": 5}
