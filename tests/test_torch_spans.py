"""The spans and counters inside tpujpeg_torch's decode call
(utils/profiling.span, count, bind, device_trace, idle_gaps) and the
benchmark's readers of them (jpegbench/metrics/).

On the CPU, with tiny corpora: the span tree and the chunks by route of
every route and of the retry at STEPS_SAFE; BatchStats' seconds as the
sums of their spans; no record_function and no log with no profiler
recording; the logged spans in device_trace's trace.json on the
profiler's clock, each once; idle_gaps' names on a synthetic trace; the
speculative route's spans and counters (single pass and a forced miss);
each reader on a hand-made context, and spec_scan_roofline on a
hand-made trace.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tpujpeg_torch import JpegError
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime.batch import BatchDecoder
from tpujpeg_torch.utils import profiling

from conftest import make_jpeg, make_jpeg_rst

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rst(n=2, shape=(48, 64), ri=2):
    return [make_jpeg_rst(shape=shape, rst_interval=ri, seed=s)
            for s in range(1, n + 1)]


def _rows(shape, seed):
    # 4:4:4 with a restart marker every MCU row
    return make_jpeg_rst(shape=shape, rst_interval=-(-shape[1] // 8),
                         seed=seed)


def _refuse_plan(monkeypatch):
    def refuse(imgs, split=True):
        raise JpegError("no lane plan")

    monkeypatch.setattr(tfsm, "build_plan", refuse)


# route -> (decoder arguments, streams, set-up)
ROUTES = {
    "host": (dict(backend="host"), lambda: _rst(), None),
    "host-bucketed": (
        dict(backend="fsm", size_buckets=True),
        lambda: [make_jpeg_rst(shape=(64, 80), rst_interval=3, seed=1),
                 make_jpeg_rst(shape=(60, 88), rst_interval=3, seed=2)],
        None),
    "fsm": (dict(backend="fsm"), lambda: _rst(), None),
    "fsm-bucketed": (dict(backend="fsm", size_buckets=True),
                     lambda: [_rows((64, 80), 1), _rows((60, 88), 2)], None),
    "fsm-spec-sync": (
        dict(backend="fsm"),
        lambda: [make_jpeg(shape=(16, 24), seed=s) for s in (1, 2)],
        _refuse_plan),
    "gather": (dict(backend="gather"), lambda: _rst(), None),
}

# the spans each route's dispatch holds (on the dispatching thread)
DISPATCH_CHILDREN = {
    "host": {"host_entropy", "upload", "launch"},
    "host-bucketed": {"prep_wait", "host_entropy", "upload", "launch"},
    "fsm": {"prep_wait", "launch"},
    "fsm-bucketed": {"prep_wait", "launch"},
    "fsm-spec-sync": {"prep_wait", "launch"},
    "gather": {"prep_wait", "launch"},
}


def _profiled(fn):
    """fn() with a CPU profiler recording (the spans are logged)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        return fn()
    finally:
        prof.stop()


def _tree(spans):
    by_id = {s.id: s for s in spans}
    return by_id, {s.id: [c for c in spans if c.parent == s.id]
                   for s in spans}


@pytest.mark.parametrize("route", [*ROUTES, "retry"])
def test_span_tree_and_route_chunks(route, monkeypatch):
    if route == "retry":
        monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
        args, datas, want = dict(backend="fsm"), _rst(), "fsm"
    else:
        args, make, setup = ROUTES[route]
        if setup is not None:
            setup(monkeypatch)
        datas, want = make(), route
    # the spans log as under a profiler, without the profiler's own
    # recording of every CPU op (the plain scans make many)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    dec = BatchDecoder(chunk_size=2, device="cpu", **args)
    try:
        dec.decode(datas)
    finally:
        dec.close()
    st = dec.stats
    assert st.route_chunks == {want: 1}, st.as_dict()
    assert st.backend == want and st.chunks == 1
    by_id, kids = _tree(st.spans)
    assert len(by_id) == len(st.spans)          # each span once
    roots = [s for s in st.spans if s.name == "decode"]
    assert len(roots) == 1 and roots[0].parent == 0
    root = roots[0]
    main = root.thread
    for s in st.spans:
        assert s.call == root.call
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
        if s.name in ("decode", "parse", "huffman", "prep_queue"):
            continue
        # every other span hangs, through its parents, from the root
        p = s
        while p.parent:
            p = by_id[p.parent]
        assert p is root, s
    top = {c.name for c in kids[root.id]}
    assert {"parse_wait", "dispatch", "finish", "fetch", "crop"} <= top
    (disp,) = [s for s in st.spans if s.name == "dispatch"]
    assert dict(disp.attrs)["route"] == want and disp.chunk == 0
    assert disp.thread == main
    got = {c.name for c in kids[disp.id]}
    assert DISPATCH_CHILDREN[want] <= got, got
    parses = [s for s in st.spans if s.name == "parse"]
    assert len(parses) == len(datas)
    assert all(s.parent == root.id and s.thread != main for s in parses)
    if want.startswith("host"):
        (ent,) = [s for s in kids[disp.id] if s.name == "host_entropy"]
        # the pool's decode of each image, and its padding here
        names = sorted(c.name for c in kids[ent.id])
        assert names == ["host_pad"] * len(datas) + ["huffman"] * len(datas)
        assert all(c.thread != main for c in kids[ent.id]
                   if c.name == "huffman")
    preps = [s for s in st.spans if s.name == "prepare"]
    if want == "host":
        assert not preps and st.prep_misses == 0
    else:
        (prep,) = preps
        (queue,) = [s for s in st.spans if s.name == "prep_queue"]
        assert prep.thread != main and prep.chunk == 0
        assert queue.end_ns <= prep.start_ns and queue.parent == prep.parent
        assert {"plan", "stage"} & {c.name for c in kids[prep.id]}
        attrs = dict(prep.attrs)
        if want == "host-bucketed":
            assert attrs == {"route": "bucket", "outcome": "miss"}
            assert st.prep_misses == 1
        else:
            assert attrs["outcome"] == "ok" and st.prep_misses == 0
    (fin,) = [s for s in st.spans if s.name == "finish"]
    retries = [s for s in kids[fin.id] if s.name == "retry"]
    if route == "retry":
        assert [dict(r.attrs) for r in retries] == [{"kind": "steps_safe"}]
        assert st.fsm_k_retries == 1 and st.fsm_envelope_fallbacks == 0
        assert "launch" in {c.name for c in kids[retries[0].id]}
    else:
        assert not retries
    # the device FSM's chunks are fenced here (gather checks its lanes at
    # dispatch, and the host routes have no latch)
    assert want.startswith("fsm") == ("fence" in {c.name
                                                  for c in kids[fin.id]})


@pytest.mark.parametrize("miss", [False, True])
def test_spec_route_spans_and_counters(miss, monkeypatch):
    _refuse_plan(monkeypatch)
    if miss:
        def refuse(pending):
            raise tfsm.SpecSyncMiss("forced")

        monkeypatch.setattr(tfsm, "spec_sync_resolve_host", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    datas = [make_jpeg(shape=(16, 24), seed=s) for s in (1, 2, 3, 4)]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    try:
        dec.decode(datas)
    finally:
        dec.close()
    st = dec.stats
    want = "fsm-spec" if miss else "fsm-spec-sync"
    assert st.route_chunks == {want: 2}, st.as_dict()
    by_id, kids = _tree(st.spans)
    for disp in (s for s in st.spans if s.name == "dispatch"):
        launches = [c for c in kids[disp.id] if c.name == "launch"]
        inner = [g.name for c in launches for g in kids[c.id]]
        # the scans' enqueue, then the host's one read, inside launch
        assert inner[:2] == ["spec_scan", "spec_resolve"], inner
        if miss:
            (jac,) = [g for c in launches for g in kids[c.id]
                      if g.name == "jacobi"]
            assert dict(jac.attrs)["steps"] == tfsm.STEPS_PRODUCTION
        else:
            assert "jacobi" not in inner
    for name in ("spec_scan", "spec_resolve", "jacobi"):
        spans = [s for s in st.spans if s.name == name]
        assert len(spans) == (0 if name == "jacobi" and not miss else 2)
        assert all(by_id[s.parent].name == "launch" for s in spans)
        logged = sum(s.end_ns - s.start_ns for s in spans) * 1e-9
        assert logged == pytest.approx(st.span_s.get(name, 0.0), abs=1e-3)
    # the counters are the call's: one miss a chunk, one slot chunk a
    # chunk that took the single pass with a slot capacity
    assert st.spec_sync_misses == (2 if miss else 0)
    assert st.spec_slot_chunks == (0 if miss else 2 * bool(dec._slot_c))
    assert st.fsm_k_retries == 0 and st.fsm_envelope_fallbacks == 0


@pytest.mark.parametrize("entry", ["decode", "decode_parsed"])
@pytest.mark.parametrize("profiled", [False, True])
def test_stats_are_the_sums_of_their_spans(entry, profiled):
    from tpujpeg_torch.io.parser import parse

    datas = _rst(4)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    try:
        def run():
            if entry == "decode":
                return dec.decode(datas)
            return dec.decode_parsed([parse(d) for d in datas])

        out = _profiled(run) if profiled else run()
    finally:
        dec.close()
    assert len(out) == 4
    st = dec.stats
    sec = st.span_s
    assert st.parse_s == sec.get("parse_wait", 0.0)
    assert st.entropy_s == sec["dispatch"]
    assert st.device_s == sec["finish"]
    assert st.total_s == sec["decode"]
    assert (entry == "decode") == ("parse_wait" in sec)
    inside = (st.parse_s + st.entropy_s + st.device_s + sec["fetch"]
              + sec["crop"])
    assert 0 < inside <= st.total_s
    assert st.route_chunks == {"fsm": 2} and st.chunks == 2
    if profiled:
        # the log's durations on the profiler's clock read the same sums
        for name in ("decode", "dispatch", "finish", "fetch"):
            logged = sum(s.end_ns - s.start_ns for s in st.spans
                         if s.name == name) * 1e-9
            assert abs(logged - sec[name]) <= 2e-3 + 0.05 * sec[name], name
    else:
        assert st.spans == []


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = profiling._RECORD

    class Counted:
        def __init__(self, name):
            self.name, self.rf = name, real(name)

        def __enter__(self):
            entered.append(self.name)
            return self.rf.__enter__()

        def __exit__(self, *exc):
            return self.rf.__exit__(*exc)

    monkeypatch.setattr(profiling, "_RECORD", Counted)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu",
                       size_buckets=True)
    datas = _rst(3) + [make_jpeg_rst(shape=(60, 88), rst_interval=3, seed=4)]
    try:
        dec.decode(datas)
        assert entered == [] and dec.stats.spans == []
        assert dec.stats.span_s["dispatch"] > 0
        # the counting class is the one a profiled span enters
        _profiled(lambda: dec.decode(datas))
    finally:
        dec.close()
    assert "tpujpeg.decode" in entered and dec.stats.spans
    assert "tpujpeg.parse" not in entered      # a pool thread's span


def test_device_trace_holds_every_span_once_on_its_clock(tmp_path):
    datas = _rst(3)
    dec = BatchDecoder(backend="host", chunk_size=2, device="cpu")
    log_dir = str(tmp_path / "trace")
    try:
        with profiling.device_trace(log_dir, device="cpu"):
            with profiling.span("outer"):
                with record_function("inner"):
                    torch.ones(64).cumsum(0).sum()
            dec.decode(datas)
    finally:
        dec.close()
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if str(e.get("name", "")).startswith(
        profiling.PREFIX) and e.get("ph") == "X"]
    assert all(e["cat"] == profiling.SPAN_CAT for e in ours)
    # each span once: the call's logged spans and "outer", nothing more
    assert len(ours) == len(dec.stats.spans) + 1
    assert len({e["args"]["id"] for e in ours}) == len(ours)
    (outer,) = [e for e in ours if e["name"] == "tpujpeg.outer"]
    (inner,) = [e for e in events if e.get("name") == "inner"
                and e.get("ph") == "X"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    (root,) = [e for e in ours if e["name"] == "tpujpeg.decode"]
    parses = [e for e in ours if e["name"] == "tpujpeg.parse"]
    assert len(parses) == 3
    for p in parses:
        assert p["tid"] != root["tid"] and p["args"]["parent"] == \
            root["args"]["id"]
        assert root["ts"] <= p["ts"]
        assert p["ts"] + p["dur"] <= root["ts"] + root["dur"]
    # the profiler's own ops of the call lie inside its root span too
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == root["tid"] and e["ts"] > outer["ts"]
           + outer["dur"]]
    assert ops and all(root["ts"] <= e["ts"] <= root["ts"] + root["dur"]
                       for e in ops)
    gaps = profiling.idle_gaps(os.path.join(log_dir, profiling.TRACE_FILE))
    assert gaps and gaps[0]["us"] > 0       # the CPU trace: no device work


def test_idle_gaps_name_each_gap_by_the_innermost_span(tmp_path):
    def span(name, tid, ts, dur):
        return {"ph": "X", "cat": profiling.SPAN_CAT,
                "name": profiling.PREFIX + name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur}

    def dev(ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "k", "pid": 0, "tid": 7,
                "ts": ts, "dur": dur}

    events = [
        span("decode", 1, 0, 1000), span("dispatch", 1, 100, 400),
        span("host_entropy", 1, 150, 300), span("finish", 1, 700, 280),
        span("parse", 2, 0, 300), span("prepare", 3, 600, 300),
        dev(0, 120), dev(460, 100, "gpu_memcpy"), dev(540, 160),
        dev(950, 50, "gpu_memset"),
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a", "pid": 0,
         "tid": 7, "ts": 0, "dur": 1000},      # not device work
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    gaps = profiling.idle_gaps(str(path))
    assert gaps == [
        {"start_us": 120.0, "us": 340.0, "span": "host_entropy",
         "pool": ["parse"]},
        {"start_us": 700.0, "us": 250.0, "span": "finish",
         "pool": ["prepare"]},
    ]
    assert profiling.idle_gaps(str(path), top=1) == gaps[:1]
    path.write_text(json.dumps({"traceEvents": events[6:]}))
    with pytest.raises(ValueError, match="no program span"):
        profiling.idle_gaps(str(path))


def test_pool_threads_add_to_one_call_under_contention():
    from concurrent.futures import ThreadPoolExecutor

    n_threads, per = 32, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.call() as rec:
            def work():
                for _ in range(per):
                    with profiling.span("leaf"):
                        pass
                    profiling.count("leaves")

            with ThreadPoolExecutor(n_threads) as pool:
                futs = [pool.submit(profiling.bind(work))
                        for _ in range(n_threads)]
                for f in futs:
                    f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert rec.counts == {"leaves": n_threads * per}
    assert set(rec.seconds) == {"decode", "leaf"}


# -- the benchmark's readers -------------------------------------------------

READERS = ("parse_ms_per_image", "prep_wait_share", "host_entropy_share",
           "upload_share", "launch_share", "fetch_share", "host_route_share",
           "spec_resolve_share", "jacobi_share")


def _reader(name):
    path = os.path.join(ROOT, "jpegbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(stats):
    return SimpleNamespace(window=SimpleNamespace(stats=stats))


CALLS = [
    {"n_images": 128, "total_s": 0.5, "chunks": 12, "spec_sync_misses": 0,
     "span_s": {"parse": 0.64, "prep_wait": 0.05, "host_entropy": 0.3,
                "upload": 0.02, "launch": 0.01, "fetch": 0.04},
     "route_chunks": {"host-bucketed": 12}},
    {"n_images": 128, "total_s": 0.5, "chunks": 2, "spec_sync_misses": 1,
     "span_s": {"parse": 0.64, "prep_wait": 0.15, "launch": 0.03,
                "spec_scan": 0.005, "spec_resolve": 0.02, "fetch": 0.16},
     "route_chunks": {"fsm": 1, "host": 1}},
]

WANT = {"parse_ms_per_image": 1280.0 / 256, "prep_wait_share": 20.0,
        "host_entropy_share": 30.0, "upload_share": 2.0,
        "launch_share": 4.0, "fetch_share": 20.0,
        "host_route_share": 100.0 * 13 / 14,
        # Σ spec_resolve over every call's time; the misses over the
        # chunks of the calls that ran the speculative scans
        "spec_resolve_share": 2.0, "jacobi_share": 50.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_made_context(name):
    mod = _reader(name)
    assert mod.read(_ctx(CALLS)) == pytest.approx(WANT[name])
    # a program without the spans (the parent's stats) or no call
    old = [{k: v for k, v in c.items() if k not in ("span_s",
                                                    "route_chunks")}
           for c in CALLS]
    assert mod.read(_ctx(old)) is None
    assert mod.read(_ctx([])) is None


def _trace_ctx(op_seconds, stats):
    from jpegbench.devtrace import Trace

    streams = [SimpleNamespace(scan_bytes=200_000, n_blocks=19_200),
               SimpleNamespace(scan_bytes=300_000, n_blocks=19_200)]
    trace = Trace(window_s=2.0, busy_s=1.0, op_seconds=op_seconds)
    win = SimpleNamespace(trace=trace, stats=stats, calls=[[0, 1], [1, 0]])
    return SimpleNamespace(streams=streams, window=win,
                           device_kind="NVIDIA H100 80GB HBM3",
                           peaks={"cards": {"NVIDIA H100 80GB HBM3":
                                            {"hbm_bytes_per_s": 1e12}}})


def test_spec_scan_roofline_on_a_hand_made_trace():
    mod = _reader("spec_scan_roofline")
    ops = {"void fsm_scan_kernel<true, false, false>": 0.004,
           "void (anonymous namespace)::compact_kernel<4>": 0.001,
           "slot_unpack_kernel": 0.001, "slot_expand_kernel<2>": 0.002,
           "place::scatter_kernel<4>": 0.002,
           # the gather has no kernel of its own name: left out
           "void at::native::index_select_kernel": 0.5,
           "Memcpy DtoH (Device -> Pageable)": 1.0}
    spec = [{"span_s": {"spec_scan": 0.01, "spec_resolve": 0.02}}]
    # need: two calls of both pictures, scan bytes + int16 coefficients
    need = 2 * (500_000 + 2 * 19_200 * 128)
    got = mod.read(_trace_ctx(ops, spec))
    assert got == pytest.approx(100.0 * need / 1e12 / 0.010)
    # the parent's stats (no spec_scan span), an unknown card, no trace,
    # no kernel of the five: nothing to read
    assert mod.read(_trace_ctx(ops, [{"span_s": {"launch": 0.1}}])) is None
    assert mod.read(_trace_ctx(ops, [{}])) is None
    ctx = _trace_ctx(ops, spec)
    ctx.device_kind = "cpu"
    assert mod.read(ctx) is None
    ctx = _trace_ctx(ops, spec)
    ctx.window.trace = None
    assert mod.read(ctx) is None
    assert mod.read(_trace_ctx({"Memcpy DtoH": 1.0}, spec)) is None
