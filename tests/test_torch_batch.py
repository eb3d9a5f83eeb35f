"""tpujpeg_torch BatchDecoder on the CPU == the JAX engine == the oracle.

The port's engine runs here with device="cpu", so every kernel wrapper
takes its plain PyTorch version; the retry ladder, the fallbacks and the
strict repair are the same code that drives the CUDA kernels on a card.
Comparisons are exact.
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


def test_fsm_without_restart_markers_is_not_implemented():
    # The name is from when backend="fsm" refused streams without restart
    # markers.  It takes them now: a small one packs as one lane per image
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
