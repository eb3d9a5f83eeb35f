"""The pipelined engine of tpujpeg_torch on the CPU == the JAX engine.

`BatchDecoder.decode` streams: parses run on the pool, a chunk is formed
as soon as chunk_size images of one key have arrived (in arrival order,
as the JAX engine forms them) and goes through the rolling window, which
prepares up to `_PREP_AHEAD` chunks (plan, staged arrays) on the
two-thread prep pool.  `decode_parsed` keeps the stride-sorted chunks and
the same window.  On the CPU there is no copy stream and no pinning, but
the same pool and window run.  Every call of the port's engine here runs
in a thread joined with a bound, so nothing can hang the run.

The JAX side comes in through the `jx` fixture, so the file also loads
where there is no JAX: its GPU case runs on the card with
`TPUJPEG_TEST_TPU=1 python -m pytest tests/test_torch_prep.py -m gpu`
(README).
"""

import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from tpujpeg_torch import JpegError
from tpujpeg_torch.io.parser import parse
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime import batch as tbatch
from tpujpeg_torch.runtime.batch import _PREP_AHEAD, BatchDecoder

from conftest import FIXTURES, make_jpeg, make_jpeg_rst

BOUND_S = 300.0


@pytest.fixture(scope="module")
def jx():
    """The JAX package's engine, parser, FSM and oracle, and the bucket
    helpers of test_torch_buckets."""
    import test_torch_buckets as tb
    from tpujpeg.errors import JpegError as JaxJpegError
    from tpujpeg.io.parser import parse as jparse
    from tpujpeg.ops import fsm as jfsm
    from tpujpeg.oracle import decoder as oracle
    from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder

    return SimpleNamespace(
        BatchDecoder=JaxBatchDecoder, JpegError=JaxJpegError, parse=jparse,
        fsm=jfsm, stats_equal=tb._stats_equal, mesh1=tb._mesh1,
        rst_rows=tb._rst_rows, MIXED=tb.MIXED,
        oracle=lambda datas: [oracle.decode(jparse(d)).astype(np.uint8)
                              for d in datas])


def _bounded(fn, seconds: float = BOUND_S):
    """fn() on a thread joined within `seconds`; its exception re-raised."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


def _host(datas):
    """The port's host reference decoder's outputs."""
    from tpujpeg_torch.runtime import host

    return [host.decode_cpu(parse(d)) for d in datas]


def _refuse_plans(jx, monkeypatch):
    """Neither engine packs a lane plan: every chunk takes the
    speculative path (a real one needs an image past one lane, tens of
    seconds of plain scan here)."""
    def refuse_t(imgs, split=True):
        raise JpegError("forced: no lane plan")

    def refuse_j(imgs, split=True):
        raise jx.JpegError("forced: no lane plan")

    monkeypatch.setattr(tfsm, "build_plan", refuse_t)
    monkeypatch.setattr(jx.fsm, "build_plan", refuse_j)


def _batch(jx, kind: str):
    """(datas, decoder arguments, backend) of a multi-chunk batch."""
    if kind == "restart":
        datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
                 for s in range(1, 6)]
        return datas, {}, "fsm"
    if kind == "no-restart":
        # one lane per image
        datas = [make_jpeg(shape=(32, 48), seed=s) for s in range(1, 6)]
        return datas, {}, "fsm"
    if kind == "spec":
        datas = [make_jpeg(shape=(16, 24), seed=s) for s in range(1, 5)]
        return datas, {}, "fsm-spec-sync"
    datas = [jx.rst_rows(s, seed=i) for i, s in enumerate(jx.MIXED)]
    return datas, {"size_buckets": True}, "fsm-bucketed"


def _jax_decoder(jx, args):
    if args.get("size_buckets"):
        return jx.BatchDecoder(backend="fsm", chunk_size=2, mesh=jx.mesh1(),
                               **args)
    return jx.BatchDecoder(backend="fsm", chunk_size=2, **args)


@pytest.mark.parametrize("entry", ["decode", "decode_parsed"])
@pytest.mark.parametrize("kind", ["restart", "no-restart", "spec",
                                  "bucketed"])
def test_multi_chunk_batches_match_jax_and_oracle(jx, kind, entry,
                                                 monkeypatch):
    if kind == "spec":
        _refuse_plans(jx, monkeypatch)
    datas, args, backend = _batch(jx, kind)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu", **args)
    jdec = _jax_decoder(jx, args)
    if kind == "spec":
        # one slot capacity in both engines: their host samples differ
        # (ROADMAP.md, the reference's slot faults), and the first image
        # sampled is another one in decode than in decode_parsed
        dec._slot_c = 256
        jdec._slot_c = {True: 256, False: 256}
    if entry == "decode":
        got = _bounded(lambda: dec.decode(datas))
        jgot = jdec.decode(datas)
    else:
        got = _bounded(lambda: dec.decode_parsed([parse(d) for d in datas]))
        jgot = jdec.decode_parsed([jx.parse(d) for d in datas])
    _bounded(dec.close)
    assert dec.stats.backend == backend, dec.stats.as_dict()
    assert dec.stats.chunks >= 2
    jx.stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(got, jgot, jx.oracle(datas)):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def _arrival_differs_from_stride():
    """Two noise and two flat streams of one size, interleaved: arrival
    order and stride (longest restart segment) order differ."""
    noisy = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
             for s in (1, 2)]
    rng = np.random.default_rng(0)
    flat = []
    for level in (100, 160):
        import cv2

        arr = np.clip(level + rng.normal(0, 1, (48, 64, 3)), 0, 255)
        ok, enc = cv2.imencode(
            ".jpg", arr.astype(np.uint8),
            [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
        assert ok
        flat.append(enc.tobytes())
    return [noisy[0], flat[0], noisy[1], flat[1]]


def _spy_chunks(dec, monkeypatch):
    seen = []
    dispatch = dec._dispatch_chunk

    def spy(chunk, isolate):
        seen.append(list(chunk.indices))
        return dispatch(chunk, isolate)

    monkeypatch.setattr(dec, "_dispatch_chunk", spy)
    return seen


def test_decode_forms_the_jax_engines_chunks(jx, monkeypatch):
    datas = _arrival_differs_from_stride()
    strides = [tbatch._stride_key(parse(d)) for d in datas]
    assert sorted(range(4), key=strides.__getitem__)[:2] != [0, 1]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    jdec = jx.BatchDecoder(backend="fsm", chunk_size=2)
    got_t = _spy_chunks(dec, monkeypatch)
    got_j = _spy_chunks(jdec, monkeypatch)
    out = _bounded(lambda: dec.decode(datas))
    jout = jdec.decode(datas)
    assert got_t == got_j == [[0, 1], [2, 3]]
    jx.stats_equal(dec.stats, jdec.stats)
    for g, j in zip(out, jout):
        np.testing.assert_array_equal(g, j)
    # decode_parsed keeps its stride sort in both engines
    del got_t[:], got_j[:]
    _bounded(lambda: dec.decode_parsed([parse(d) for d in datas]))
    jdec.decode_parsed([jx.parse(d) for d in datas])
    assert got_t == got_j and got_t != [[0, 1], [2, 3]]


@pytest.mark.parametrize("entry", ["decode", "decode_parsed"])
def test_window_holds_at_most_prep_ahead(entry, monkeypatch):
    datas = [make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=s)
             for s in range(8)]
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    submitted, dispatched, peak = set(), set(), []
    submit = dec.prep_pool.submit
    dispatch = dec._dispatch_chunk

    def spy_submit(fn, chunk):
        submitted.add(id(chunk))
        peak.append(len(submitted - dispatched))
        return submit(fn, chunk)

    def spy_dispatch(chunk, isolate):
        dispatched.add(id(chunk))
        return dispatch(chunk, isolate)

    monkeypatch.setattr(dec.prep_pool, "submit", spy_submit)
    monkeypatch.setattr(dec, "_dispatch_chunk", spy_dispatch)
    if entry == "decode":
        got = _bounded(lambda: dec.decode(datas))
    else:
        got = _bounded(lambda: dec.decode_parsed([parse(d) for d in datas]))
    assert len(peak) == 8 and max(peak) <= _PREP_AHEAD
    assert max(peak) == _PREP_AHEAD
    for g, w in zip(got, _host(datas)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("backend", ["host", "oracle", "cpu"])
def test_no_prepare_off_the_device_fsm(backend, monkeypatch):
    datas = [make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=s)
             for s in range(3)]
    dec = BatchDecoder(backend=backend, chunk_size=1, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a prepare was submitted")

    monkeypatch.setattr(dec.prep_pool, "submit", refuse)
    monkeypatch.setattr(dec, "_upload", refuse)
    got = _bounded(lambda: dec.decode(datas))
    assert _bounded(lambda: dec.decode_parsed(
        [parse(d) for d in datas], fetch=False)) is None
    for g, w in zip(got, _host(datas)):
        np.testing.assert_array_equal(g, w)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_k_retry_reuses_the_prepared_plan(monkeypatch):
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
             for s in (1, 2)]
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
    calls = _count_calls(monkeypatch, tfsm, "build_plan")
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    got = _bounded(lambda: dec.decode(datas))
    assert dec.stats.fsm_k_retries == 2, dec.stats.as_dict()
    assert dec.stats.backend == "fsm"
    assert len(calls) == 2          # one per chunk, none for the retries
    for g, w in zip(got, _host(datas)):
        np.testing.assert_array_equal(g, w)


def test_slot_retry_reuses_the_prepared_plan(monkeypatch):
    def refuse(imgs, split=True):
        raise JpegError("forced: no lane plan")

    monkeypatch.setattr(tfsm, "build_plan", refuse)
    calls = _count_calls(monkeypatch, tfsm, "build_spec_plan_batch")
    datas = [make_jpeg(shape=(16, 24), seed=s, smooth=False, quality=95)
             for s in (1, 2)]
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    dec._slot_c = 64                 # a capacity the content overflows
    got = _bounded(lambda: dec.decode(datas))
    assert dec.stats.fsm_slot_retries >= 1, dec.stats.as_dict()
    assert dec.stats.backend == "fsm-spec-sync"
    assert len(calls) == 2          # one per chunk, none for the retries
    for g, w in zip(got, _host(datas)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("entry", ["decode", "decode_parsed"])
@pytest.mark.parametrize("buckets", [False, True])
def test_prepare_error_reaches_the_caller(entry, buckets, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom in a prepare")

    monkeypatch.setattr(tfsm, "build_plan_bucketed" if buckets
                        else "build_plan", boom)
    # restart every MCU row, so the chunks also pack into buckets
    datas = [make_jpeg_rst(shape=(48, 64), rst_interval=8, seed=s)
             for s in range(3)]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu",
                       size_buckets=buckets)
    run = (lambda: dec.decode(datas, on_error="skip")) if entry == "decode" \
        else (lambda: dec.decode_parsed([parse(d) for d in datas],
                                        on_error="skip"))
    with pytest.raises(RuntimeError, match="boom in a prepare"):
        _bounded(run)
    _bounded(dec.close)


def _bad_scan(data: bytes) -> bytes:
    """The stream with the last third of its entropy-coded bytes replaced
    by stuffed 0xFF: it parses, and its scan is malformed."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2 : sos + 4], "big")
    end = len(data) - 2                       # EOI
    cut = end - (end - start) // 3
    fill = b"\xff\x00" * ((end - cut) // 2)
    return data[:cut] + fill + data[cut + len(fill):]


def test_skip_keys_failures_like_jax(jx):
    good = [make_jpeg(shape=(32, 48), seed=s) for s in range(6)]
    datas = [good[0], b"\xff\xd8 not a jpeg", good[2], good[3],
             _bad_scan(good[4]), good[5]]
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    got = _bounded(lambda: dec.decode(datas, on_error="skip"))
    jdec = jx.BatchDecoder(backend="fsm", chunk_size=2)
    jgot = jdec.decode(datas, on_error="skip")
    assert set(dec.stats.failures) == set(jdec.stats.failures) == {1, 4}
    assert dec.stats.failures == jdec.stats.failures
    assert dec.stats.fsm_malformed_fallbacks == 1
    jx.stats_equal(dec.stats, jdec.stats)
    for i, (g, j) in enumerate(zip(got, jgot)):
        if i in (1, 4):
            assert g is None and j is None
        else:
            np.testing.assert_array_equal(g, j)


def test_close_shuts_both_pools_down():
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    datas = [make_jpeg_rst(shape=(16, 24), rst_interval=1, seed=s)
             for s in range(3)]
    _bounded(lambda: dec.decode(datas))
    _bounded(dec.close)
    for pool in (dec.pool, dec.prep_pool):
        with pytest.raises(RuntimeError):
            pool.submit(int)


def test_threads_under_a_short_switch_interval():
    # more threads than cores, thread switches every microsecond: every
    # chunk's prepared plan still lands in its own chunk
    datas = [make_jpeg_rst(shape=(16 + 8 * (s % 3), 24), rst_interval=1,
                           seed=s) for s in range(12)]
    want = _host(datas)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dec = BatchDecoder(backend="fsm", chunk_size=1, workers=16,
                           device="cpu")
        got = _bounded(lambda: dec.decode(datas))
        _bounded(dec.close)
    finally:
        sys.setswitchinterval(old)
    assert dec.stats.chunks == 12 and dec.stats.backend == "fsm"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream and the kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _fixture_streams(folder: str, n: int) -> list:
    names = sorted(f for f in os.listdir(os.path.join(FIXTURES, folder))
                   if f.endswith(".jpg"))[:n]
    out = []
    for name in names:
        with open(os.path.join(FIXTURES, folder, name), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.gpu
def test_pipelined_equals_serial_on_the_card(cuda):
    # the same bytes as one pipelined call and as one call per chunk:
    # restart chunks and a speculative one (the committed 640 x 640
    # streams), equal outputs, counters and kernel launches
    from tpujpeg_torch.runtime import kernels

    datas = _fixture_streams("rst640", 4) + _fixture_streams("photo640", 2)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device=cuda)
    _bounded(lambda: dec.decode(datas))      # builds the kernels
    kernels.reset_launches()
    got = _bounded(lambda: dec.decode(datas))
    piped = dict(kernels.LAUNCHES)
    stats = dec.stats.as_dict()
    kernels.reset_launches()
    serial = []
    for i in range(0, len(datas), 2):
        serial += _bounded(lambda: dec.decode(datas[i : i + 2]))
    assert dict(kernels.LAUNCHES) == piped
    _bounded(dec.close)
    assert stats["backend"] == "fsm+fsm-spec-sync" and stats["chunks"] == 3
    assert stats["fsm_malformed_fallbacks"] == 0
    assert stats["fsm_envelope_fallbacks"] == 0
    for g, s, w in zip(got, serial, _host(datas)):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)
