"""tpujpeg_torch BatchDecoder on the CPU == the JAX engine == the oracle.

The port's engine runs here with device="cpu", so every kernel wrapper
takes its plain PyTorch version; the retry ladder, the fallbacks and the
strict repair are the same code that drives the CUDA kernels on a card.
Comparisons are exact.  The backends "cpu", "oracle" and "auto",
`workers`, fetch=False and a chunk the JAX engine splits are held against
the JAX engine too (counters through `_stats_equal`).
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpujpeg.io.parser import parse
from tpujpeg.oracle import decoder as oracle
from tpujpeg.runtime.batch import BatchDecoder as JaxBatchDecoder
from tpujpeg_torch.ops import fsm as tfsm
from tpujpeg_torch.runtime.batch import BatchDecoder

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst
from test_torch_buckets import _stats_equal
from test_torch_entry import split_corpus


def _oracle(datas):
    return [oracle.decode(parse(d)).astype(np.uint8) for d in datas]


def test_fsm_batch_matches_jax_engine_and_oracle():
    datas = [
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
        for s in (1, 2, 3, 4)
    ]
    dec = BatchDecoder(backend="fsm", chunk_size=4, device="cpu")
    got = dec.decode(datas)
    assert dec.stats.backend == "fsm", dec.stats.as_dict()
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    jdec = JaxBatchDecoder(backend="fsm", chunk_size=4)
    jgot = jdec.decode(datas)
    assert jdec.stats.backend == "fsm"
    for g, j, o in zip(got, jgot, _oracle(datas)):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, o)


def test_fsm_batch_k_retry(monkeypatch):
    # below the symbol-step envelope the chunk is decoded again on the
    # device at STEPS_SAFE, counted, with no host fallback, bit-exact
    datas = [
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s) for s in (1, 2)
    ]
    monkeypatch.setattr(tfsm, "STEPS_PRODUCTION", 1)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    got = dec.decode(datas)
    assert dec.stats.fsm_k_retries == 1, dec.stats.as_dict()
    assert dec.stats.fsm_envelope_fallbacks == 0
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.backend == "fsm"
    for g, o in zip(got, _oracle(datas)):
        np.testing.assert_array_equal(g, o)


def test_fsm_malformed_falls_back_to_host_and_counts():
    img = parse(
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21, quality=95)
    )
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    good = make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=3)
    dec = BatchDecoder(backend="fsm", chunk_size=2, device="cpu")
    got = dec.decode_parsed([img, parse(good)], on_error="skip")
    assert dec.stats.fsm_malformed_fallbacks >= 1, dec.stats.as_dict()
    assert got[0] is None and set(dec.stats.failures) == {0}
    assert dec.stats.backend == "host"
    # the chunk's good stream still decodes, exactly, on the host route
    np.testing.assert_array_equal(got[1], _oracle([good])[0])


def test_fsm_malformed_raises_without_skip():
    from tpujpeg_torch import JpegError

    img = parse(
        make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21, quality=95)
    )
    img.scan_data = img.scan_data.copy()
    img.scan_data[-img.scan_data.size // 3 :] = 0xFF
    dec = BatchDecoder(backend="fsm", chunk_size=1, device="cpu")
    with pytest.raises(JpegError):
        dec.decode_parsed([img])


def test_fsm_takes_a_small_stream_without_restart_markers_as_one_lane():
    # a small stream without restart markers packs as one lane per image
    # and decodes on the fsm route, exactly
    data = make_jpeg(shape=(32, 48), seed=2)
    dec = BatchDecoder(backend="fsm", device="cpu")
    got = dec.decode([data])
    assert dec.stats.backend == "fsm", dec.stats.as_dict()
    assert dec.stats.fsm_malformed_fallbacks == 0
    assert dec.stats.fsm_envelope_fallbacks == 0
    np.testing.assert_array_equal(got[0], _oracle([data])[0])


def test_host_backend_goldens_and_parse_failures():
    from tpujpeg.io.arrayio import read_array

    datas = []
    for name in GOLDEN[:3]:
        with open(fixture_path(name), "rb") as f:
            datas.append(f.read())
    datas.insert(1, b"\xff\xd8 not a jpeg")
    dec = BatchDecoder(backend="host", device="cpu")
    got = dec.decode(datas, on_error="skip")
    assert got[1] is None and set(dec.stats.failures) == {1}
    for name, g in zip(GOLDEN[:3], got[:1] + got[2:]):
        np.testing.assert_array_equal(
            g, read_array(fixture_path(name, ".array"))
        )


def _run_isolated(code: str) -> str:
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_port_never_imports_jax():
    path = fixture_path(GOLDEN[0])
    out = _run_isolated(f"""
        import sys
        import tpujpeg_torch
        rgb = tpujpeg_torch.decode({path!r}, device="cpu")
        import tpujpeg_torch.convert, tpujpeg_torch.pipeline
        import tpujpeg_torch.ops.fsm, tpujpeg_torch.ops.materialize
        import tpujpeg_torch.ops.pixels, tpujpeg_torch.runtime.batch
        import tpujpeg_torch.runtime.fused, tpujpeg_torch.runtime.kernels
        print(rgb.shape, "jax" in sys.modules)
    """)
    assert out.split()[-1] == "False", out


def test_shared_host_layer_never_imports_jax():
    out = _run_isolated("""
        import sys
        import tpujpeg.io.parser, tpujpeg.oracle.decoder, tpujpeg.runtime.host
        import tpujpeg.constants, tpujpeg.errors, tpujpeg.runtime.native.lib
        print("jax" in sys.modules)
    """)
    assert out.strip() == "False", out


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    # no fallback: a kernel library that cannot be built is an error
    from tpujpeg_torch.runtime import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "LIB_PATH", tmp_path / "libtpjcuda.so")
    monkeypatch.setattr(kernels, "STAMP_PATH", tmp_path / "libtpjcuda.hash")
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setenv("NVCC", str(tmp_path / "no-such-nvcc"))
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.launch("pixels")
    assert kernels.LAUNCHES == before  # nothing launched, nothing counted


# ---------------------------------------------------------------------------
# the engine's whole surface: fetch=False, "cpu", "oracle", "auto", split
# ---------------------------------------------------------------------------


def _rst_datas():
    return [make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=s)
            for s in (1, 2, 3)]


@pytest.mark.parametrize("backend", ["fsm", "host", "cpu"])
def test_fetch_false_returns_none_with_jax_stats(backend):
    datas = _rst_datas()
    dec = BatchDecoder(backend=backend, chunk_size=4, device="cpu")
    assert dec.decode(datas, fetch=False) is None
    jdec = JaxBatchDecoder(backend=backend, chunk_size=4)
    assert jdec.decode(datas, fetch=False) is None
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == backend
    # decode_parsed the same way, and the fetched run counts the same
    stats = dec.stats
    assert dec.decode_parsed([parse(d) for d in datas], fetch=False) is None
    assert dec.stats.backend == stats.backend
    got = dec.decode(datas)
    _stats_equal(dec.stats, jdec.stats)
    for g, o in zip(got, _oracle(datas)):
        np.testing.assert_array_equal(g, o)


def test_on_error_stays_a_keyword():
    # decode passes on_error to decode_parsed by name: "skip" is not fetch
    datas = _rst_datas()[:1] + [b"\xff\xd8 not a jpeg"]
    dec = BatchDecoder(backend="fsm", device="cpu")
    got = dec.decode(datas, on_error="skip")
    assert got[1] is None and set(dec.stats.failures) == {1}
    np.testing.assert_array_equal(got[0], _oracle(datas[:1])[0])
    assert dec.decode(datas, fetch=False, on_error="skip") is None
    assert set(dec.stats.failures) == {1}


def test_cpu_backend_mixed_geometry_skip_and_workers():
    bad = parse(make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=21,
                              quality=95))
    bad.scan_data = bad.scan_data.copy()
    bad.scan_data[-bad.scan_data.size // 3 :] = 0xFF
    datas = [make_jpeg(shape=(40, 56), seed=1),
             make_jpeg(shape=(48, 64), subsampling=2, seed=2),
             make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=3),
             make_jpeg(shape=(40, 56), seed=4)]
    imgs = [parse(d) for d in datas]
    imgs.insert(2, bad)
    dec = BatchDecoder(backend="cpu", workers=2, chunk_size=2, device="cpu")
    assert dec.pool._max_workers == 2
    got = dec.decode_parsed(imgs, on_error="skip")
    jdec = JaxBatchDecoder(backend="cpu", workers=2, chunk_size=2)
    jgot = jdec.decode_parsed(imgs, on_error="skip")
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == "cpu" and set(dec.stats.failures) == {2}
    assert got[2] is None and jgot[2] is None
    want = _oracle(datas)
    for g, j, w in zip(got[:2] + got[3:], jgot[:2] + jgot[3:], want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)
    from tpujpeg_torch import JpegError

    with pytest.raises(JpegError):
        dec.decode_parsed(imgs)
    # one single-threaded decode per core by default
    import os

    assert BatchDecoder(backend="cpu").pool._max_workers == (
        os.cpu_count() or 4)


def test_cpu_backend_touches_no_device(monkeypatch):
    # torch here has no CUDA: a device tensor, a torch.cuda call or a
    # kernel launch would raise.  The decoder is asked for "cuda" and
    # decodes all the same
    import torch

    from tpujpeg_torch.runtime import kernels

    def refuse(*a, **k):
        raise AssertionError("backend cpu touched the device")

    for name in ("synchronize", "current_stream", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(kernels, "launch", refuse)
    before = dict(kernels.LAUNCHES)
    datas = _rst_datas() + [make_jpeg(shape=(32, 48), seed=2)]
    dec = BatchDecoder(backend="cpu", device="cuda")
    got = dec.decode(datas)
    assert dec.decode(datas, fetch=False) is None
    dec.close()
    assert dec.stats.backend == "cpu" and kernels.LAUNCHES == before
    for g, o in zip(got, _oracle(datas)):
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("buckets", [False, True])
def test_oracle_backend_matches_jax(buckets):
    datas = [make_jpeg(shape=(40, 56), seed=1),
             make_jpeg(shape=(44, 60), seed=2),
             make_jpeg_rst(shape=(48, 64), rst_interval=2, seed=3)]
    dec = BatchDecoder(backend="oracle", size_buckets=buckets,
                       chunk_size=4, device="cpu")
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(backend="oracle", size_buckets=buckets,
                           chunk_size=4)
    jgot = jdec.decode(datas)
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == ("oracle-bucketed" if buckets else "oracle")
    for g, j, w in zip(got, jgot, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_backend_arguments_like_jax():
    # "gather" is a backend of both engines, without size buckets
    BatchDecoder(backend="gather", device="cpu")
    with pytest.raises(ValueError, match="size_buckets"):
        BatchDecoder(backend="gather", size_buckets=True, device="cpu")
    with pytest.raises(ValueError, match="size_buckets"):
        JaxBatchDecoder(backend="gather", size_buckets=True)
    with pytest.raises(ValueError):
        BatchDecoder(backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="size_buckets"):
        BatchDecoder(backend="cpu", size_buckets=True, device="cpu")
    with pytest.raises(ValueError, match="size_buckets"):
        JaxBatchDecoder(backend="cpu", size_buckets=True)
    for backend in ("auto", "host", "oracle", "fsm"):
        BatchDecoder(backend=backend, size_buckets=True, device="cpu")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("slow", [True, False])
def test_auto_routes_like_jax(monkeypatch, slow, native):
    # the probe patched to one side of each package's own threshold, with
    # and without the native library: the same routes and counters
    from tpujpeg.runtime import batch as jbatch
    from tpujpeg.runtime import host as jhost
    from tpujpeg_torch.runtime import batch as tbatch
    from tpujpeg_torch.runtime import host as thost

    t_rate = tbatch._LINK_MBPS_FSM_THRESHOLD * (0.5 if slow else 2)
    j_rate = jbatch._LINK_MBPS_FSM_THRESHOLD * (0.5 if slow else 2)
    monkeypatch.setattr(tbatch, "measured_link_mbps", lambda *a: t_rate)
    monkeypatch.setattr(jbatch, "measured_link_mbps", lambda *a: j_rate)
    if not native:
        monkeypatch.setattr(thost, "_load_native", lambda: None)
        monkeypatch.setattr(jhost, "_load_native", lambda: None)
    datas = _rst_datas() + [make_jpeg(shape=(32, 48), seed=2)]
    dec = BatchDecoder(backend="auto", chunk_size=4, device="cpu")
    got = dec.decode(datas)
    jdec = JaxBatchDecoder(backend="auto", chunk_size=4)
    jgot = jdec.decode(datas)
    _stats_equal(dec.stats, jdec.stats)
    assert dec.stats.backend == ("fsm" if slow or not native else "host")
    for g, j, w in zip(got, jgot, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)


def test_split_follows_the_card(monkeypatch):
    # on one card the engine packs a restart chunk into one stride group
    # and runs the fused chain whatever the link: on the H100 build_plan's
    # split paid only below ~1,064 MB/s against a link of ~9,500-10,700.
    # The JAX engine splits below its fsm threshold; the output and the
    # counters equal its split decode
    from tpujpeg.runtime import batch as jbatch

    groups = []
    build = tfsm.build_plan

    def recording(imgs, split=True):
        plan = build(imgs, split=split)
        groups.append(len(plan.groups))
        return plan

    monkeypatch.setattr(tfsm, "build_plan", recording)
    monkeypatch.setattr(jbatch, "measured_link_mbps", lambda *a: 1.0)
    datas = split_corpus()
    jdec = JaxBatchDecoder(backend="fsm", chunk_size=8)
    jgot = jdec.decode(datas)
    from tpujpeg_torch.io.parser import parse as tparse

    assert len(build([tparse(d) for d in datas]).groups) == 2
    dec = BatchDecoder(backend="fsm", chunk_size=8, device="cpu")
    got = dec.decode(datas)
    assert groups == [1]
    _stats_equal(dec.stats, jdec.stats)
    for g, j, w in zip(got, jgot, _oracle(datas)):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)
