"""tpujpeg_torch stands alone: it imports neither jax nor the tpujpeg
package, and its own copy of the host layer (errors, constants, io/,
oracle/, runtime/host.py, runtime/native/) equals the original field by
field.

The isolation checks run in a subprocess (this process has imported both
packages).  The equality checks hand the same bytes to both packages and
compare with `==`: the parse of the golden fixtures, the Huffman tables,
de-stuffing, the oracle decode, the native decoder, the constants.
"""

import dataclasses
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tpujpeg.constants as jconst
import tpujpeg_torch
import tpujpeg_torch.constants as tconst
from tpujpeg.io import arrayio as jarrayio
from tpujpeg.io import destuff as jdestuff
from tpujpeg.io import parser as jparser
from tpujpeg.oracle import decoder as joracle
from tpujpeg.runtime import host as jhost
from tpujpeg_torch import convert
from tpujpeg_torch.io import arrayio as tarrayio
from tpujpeg_torch.io import destuff as tdestuff
from tpujpeg_torch.io import parser as tparser
from tpujpeg_torch.oracle import decoder as toracle
from tpujpeg_torch.runtime import host as thost

from conftest import GOLDEN, fixture_path, make_jpeg, make_jpeg_rst

ALL_FIXTURES = GOLDEN + ["4_800x600"]


_REPORT = """
import sys
print("FOREIGN", sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tpujpeg")))
"""


def _run_isolated(code: str, cwd=None) -> str:
    """Run `code` in a fresh interpreter, then report the foreign modules
    it loaded."""
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code) + _REPORT],
        capture_output=True, text=True, timeout=300, cwd=cwd,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


def _foreign(out: str) -> str:
    return [ln for ln in out.splitlines() if ln.startswith("FOREIGN")][-1]


def test_port_imports_neither_jax_nor_the_jax_package():
    # every module of the package, and one decode through decode_batch on
    # each device route (backend "fsm": scan, materialize, pixels; backend
    # "gather": the segment decoder, pixels; plain versions on the CPU)
    # and one on the host route
    mods = sorted(
        m.name for m in pkgutil.walk_packages(tpujpeg_torch.__path__,
                                              "tpujpeg_torch."))
    assert "tpujpeg_torch.runtime.ladder" in mods
    assert "tpujpeg_torch.runtime.native.lib" in mods
    assert "tpujpeg_torch.ops.upsample" in mods
    assert "tpujpeg_torch.ops.probes" in mods
    assert "tpujpeg_torch.ops.entropy" in mods
    assert "tpujpeg_torch.cli" in mods
    assert "tpujpeg_torch.utils.profiling" in mods
    assert "tpujpeg_torch.parallel.sharding" in mods
    assert "tpujpeg_torch.parallel.distributed" in mods
    data = make_jpeg_rst(shape=(16, 24), rst_interval=3, seed=3)
    data420 = make_jpeg(shape=(16, 32), subsampling=2, seed=3)
    tall420 = make_jpeg(shape=(32, 16), subsampling=2, seed=3)
    out = _run_isolated(f"""
        import importlib, sys
        import tpujpeg_torch
        for m in {mods!r}:
            importlib.import_module(m)
        data = {data!r}
        for backend in ("fsm", "gather", "host"):
            rgb = tpujpeg_torch.decode_batch([data], backend=backend,
                                             device="cpu")[0]
            print(backend, rgb.shape, rgb.dtype)
            sub = tpujpeg_torch.decode_batch([{data420!r}], backend=backend,
                                             device="cpu", fancy=True)[0]
            print(backend, "420", sub.shape)
        rgb1 = tpujpeg_torch.decode({fixture_path(GOLDEN[2])!r}, device="cpu")
        print(rgb1.shape)
        from tpujpeg_torch import cli
        from tpujpeg_torch.utils import profiling
        cli.main(["info", {fixture_path(GOLDEN[2])!r}])
        with profiling.span("x"):
            pass
        from tpujpeg_torch.parallel import distributed, sharding
        striped = sharding.decode_striped(
            tpujpeg_torch.parse({tall420!r}), fancy=True,
            mesh=sharding.make_mesh(1, 2, devices=["cpu"] * 2))
        print("striped", striped.shape, distributed.process_info())
    """)
    assert _foreign(out) == "FOREIGN []", out
    assert "fsm (16, 24, 3) uint8" in out and "(120, 120, 3)" in out
    assert "fsm 420 (16, 32, 3)" in out and "host 420 (16, 32, 3)" in out
    assert "gather (16, 24, 3) uint8" in out
    assert "gather 420 (16, 32, 3)" in out
    assert "striped (32, 16, 3) (0, 1)" in out


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = _run_isolated("""
        import sys
        import chip_smoke
        print(callable(chip_smoke.main))
    """, cwd=root)
    assert _foreign(out) == "FOREIGN []", out


@pytest.mark.parametrize("tool", ["profile_torch_chunk", "make_torch_corpus",
                                  "bench_torch_gather",
                                  "bench_torch_materialize",
                                  "bench_torch_scan", "bench_torch_batches",
                                  "bench_torch_segments", "diff_torch_sass",
                                  "validate_torch_huge", "torch_common",
                                  "profile_torch_fused",
                                  "check_torch_color_device",
                                  "check_torch_photo_exact",
                                  "check_torch_goldens",
                                  "batch_torch_decode",
                                  "bench_torch_sustained",
                                  "bench_torch_runtime",
                                  "bench_torch_throughput",
                                  "build_torch_dataset",
                                  "display_torch_array"])
def test_tools_import_neither_jax_nor_the_jax_package(tool):
    # tools/ and benchmarks/ on the path: the two benchmark ports live in
    # benchmarks/, beside the JAX harness's bench_runtime.py
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = _run_isolated(f"""
        import sys
        sys.path[:0] = ["tools", "benchmarks"]
        import {tool}
        print("BENCH" if "bench" in sys.modules else "NO_BENCH")
    """, cwd=root)
    assert "NO_BENCH" in out, out
    assert _foreign(out) == "FOREIGN []", out


def test_prep_ahead_equals_jax():
    from tpujpeg.runtime import batch as jbatch
    from tpujpeg_torch.runtime import batch as tbatch

    assert tbatch._PREP_AHEAD == jbatch._PREP_AHEAD == 3


def test_constants_equal():
    names = [n for n in dir(jconst) if n.isupper()]
    assert len(names) > 15 and "ZIGZAG_TO_NATURAL" in names
    for n in names:
        a, b = getattr(jconst, n), getattr(tconst, n)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            assert a == b and type(a) is type(b), n
    assert [n for n in dir(tconst) if n.isupper()] == names


def _images_equal(j, t):
    for f in dataclasses.fields(jparser.JpegImage):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "components":
            assert [dataclasses.astuple(c) for c in a] == \
                [dataclasses.astuple(c) for c in b]
        elif f.name == "quant_tables":
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        elif f.name == "huffman":
            assert a.keys() == b.keys()
            for k in a:
                for g in ("counts", "symbols", "codes", "lengths"):
                    x, y = getattr(a[k], g), getattr(b[k], g)
                    assert x.dtype == y.dtype, (k, g)
                    np.testing.assert_array_equal(x, y, err_msg=f"{k} {g}")
                for x, y in zip(a[k].build_lut(16), b[k].build_lut(16)):
                    np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for prop in ("mcus_x", "mcus_y", "n_mcus", "blocks_per_mcu", "sampling",
                 "is_444", "padded_width", "padded_height"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert list(j.mcu_block_pattern()) == list(t.mcu_block_pattern())


@pytest.mark.parametrize("name", ALL_FIXTURES)
def test_parse_field_equal(name):
    j = jparser.parse_file(fixture_path(name))
    t = tparser.parse_file(fixture_path(name))
    assert type(t) is tparser.JpegImage and type(t) is not type(j)
    _images_equal(j, t)
    # and the converter that hands one parsed stream to both packages
    c = convert.image_from_jax(j)
    assert type(c) is tparser.JpegImage
    _images_equal(j, c)
    assert c.scan_data is j.scan_data   # arrays shared, not copied


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["1_320x240", "rst"])
def test_destuff_equal(name, native, monkeypatch):
    if name == "rst":
        raw = make_jpeg_rst(shape=(40, 56), rst_interval=3, seed=4)
    else:
        with open(fixture_path(name), "rb") as f:
            raw = f.read()
    buf = np.frombuffer(raw, np.uint8)
    # the first entropy-coded byte: past the SOS header
    sos = raw.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(raw[sos + 2 : sos + 4], "big")
    if not native:
        for mod in (jdestuff, tdestuff):
            monkeypatch.setattr(mod, "_native", None)
            monkeypatch.setattr(mod, "_native_checked", True)
    js, jo = jdestuff.destuff_scan(buf, start)
    ts, to = tdestuff.destuff_scan(buf, start)
    assert js.dtype == ts.dtype and jo.dtype == to.dtype
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jo, to)
    assert (name == "rst") == (to.size > 1)


@pytest.mark.parametrize("name", GOLDEN)
def test_oracle_and_host_decode_equal(name):
    j = jparser.parse_file(fixture_path(name))
    t = tparser.parse_file(fixture_path(name))
    want = jarrayio.read_array(fixture_path(name, ".array"))
    np.testing.assert_array_equal(
        tarrayio.read_array(fixture_path(name, ".array")), want)
    np.testing.assert_array_equal(toracle.entropy_decode(t),
                                  joracle.entropy_decode(j))
    got = toracle.decode(t)
    np.testing.assert_array_equal(got, joracle.decode(j))
    np.testing.assert_array_equal(got, want)
    # the host runtime: native where it builds, else the oracle; same bits
    np.testing.assert_array_equal(thost.entropy_decode(t),
                                  jhost.entropy_decode(j))
    np.testing.assert_array_equal(thost.decode_cpu(t), want.astype(np.uint8))


@pytest.mark.parametrize("fancy", [False, True])
@pytest.mark.parametrize("subsampling", [1, 2])
def test_oracle_upsampling_equal(subsampling, fancy):
    # the port's oracle carries its own numpy copy of the box and the
    # triangle upsampling (the JAX package's lives beside jax.numpy)
    data = make_jpeg(shape=(40, 56), seed=7, subsampling=subsampling)
    got = toracle.decode(tparser.parse(data), fancy=fancy)
    want = joracle.decode(jparser.parse(data), fancy=fancy)
    np.testing.assert_array_equal(got, want)


def test_oracle_decode_file_equal():
    path = fixture_path("8_401x363")
    got = toracle.decode_file(path)
    assert got.dtype == np.int32 and got.shape == (363, 401, 3)
    np.testing.assert_array_equal(got, joracle.decode_file(path))


def test_parse_errors_are_the_ports_own():
    with pytest.raises(tpujpeg_torch.JpegError):
        tparser.parse(b"\xff\xd8 not a jpeg")
    assert tpujpeg_torch.JpegError is not jparser.JpegError
    assert issubclass(tpujpeg_torch.JpegError, ValueError)


def test_native_build_without_openmp(tmp_path, monkeypatch):
    # where the OpenMP link fails, the same sources build serially into
    # the port's own build directory and decode the same bits
    from tpujpeg_torch.runtime.native import build, lib

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "LIB_PATH", tmp_path / "_tpjnative.so")
    monkeypatch.setattr(build, "SERIAL_STAMP", tmp_path / "_tpjnative.serial")
    monkeypatch.setattr(build, "_VARIANTS", (
        ["-fopenmp", "-lno_such_openmp_runtime"], build._VARIANTS[1]))
    monkeypatch.setattr(lib, "_runtime", None)
    monkeypatch.setattr(thost, "_native", None)
    monkeypatch.setattr(thost, "_native_checked", False)
    assert thost.backend_name() == "native-cpp-serial"
    assert (tmp_path / "_tpjnative.so").exists()
    t = tparser.parse_file(fixture_path(GOLDEN[2]))
    np.testing.assert_array_equal(thost.entropy_decode(t, threads=0),
                                  toracle.entropy_decode(t))
    np.testing.assert_array_equal(
        thost.decode_cpu(t),
        tarrayio.read_array(fixture_path(GOLDEN[2], ".array")))
