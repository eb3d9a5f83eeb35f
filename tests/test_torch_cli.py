"""python -m tpujpeg_torch.cli against python -m tpujpeg.cli, on the CPU.

`info` prints the JAX CLI's JSON on every golden fixture; `decode` writes
the JAX CLI's `.array` files with the backends oracle, cpu and cuda
(`--device cpu`, against the JAX CLI's tpu on JAX_PLATFORMS=cpu), which
also equal the goldens; `compare` gives the same verdicts and exit codes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpujpeg import cli as jcli
from tpujpeg.io import arrayio as jarrayio
from tpujpeg_torch import cli as tcli
from tpujpeg_torch import pipeline as tpipe
from tpujpeg_torch.io import arrayio as tarrayio

from conftest import GOLDEN, fixture_path

SMALL = ["3_120x120", "5_200x200"]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("name", GOLDEN)
def test_info_equals_jax(name, capsys):
    path = fixture_path(name)
    rc, out = _run(tcli.main, ["info", path], capsys)
    jrc, jout = _run(jcli.main, ["info", path], capsys)
    assert rc == jrc == 0
    assert json.loads(out) == json.loads(jout)
    assert out == jout


@pytest.mark.parametrize("backend", ["oracle", "cpu", "cuda"])
@pytest.mark.parametrize("name", SMALL)
def test_decode_writes_the_jax_clis_array(name, backend, tmp_path, capsys):
    path = fixture_path(name)
    out_t = str(tmp_path / "t.array")
    out_j = str(tmp_path / "j.array")
    argv = ["decode", path, "-o", out_t, "--backend", backend]
    if backend == "cuda":
        argv += ["--device", "cpu"]
    rc, said = _run(tcli.main, argv, capsys)
    jbackend = "tpu" if backend == "cuda" else backend
    jrc, _ = _run(jcli.main, ["decode", path, "-o", out_j, "--backend",
                              jbackend, "-q"], capsys)
    assert rc == jrc == 0
    assert said.startswith(f"{path}: ") and f"-> {out_t} in " in said
    with open(out_t) as f, open(out_j) as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tarrayio.read_array(out_t),
                                  jarrayio.read_array(fixture_path(name,
                                                                   ".array")))


def test_compare_verdicts_and_exit_codes(tmp_path, capsys):
    want = fixture_path(SMALL[0], ".array")
    rgb = tarrayio.read_array(want)
    off = rgb.copy()
    off[0, 0, 0] += 3
    off[5, 7, 2] -= 1
    files = {}
    for tag, arr in (("same", rgb), ("off", off), ("shape", rgb[:-1])):
        files[tag] = str(tmp_path / f"{tag}.array")
        tarrayio.write_array(files[tag], arr)
    cases = [[files["same"], want], [files["off"], want],
             [files["off"], want, "--tolerance", "3"],
             [files["off"], want, "--tolerance", "2"],
             [files["shape"], want]]
    codes = []
    for args in cases:
        rc, out = _run(tcli.main, ["compare", *args], capsys)
        jrc, jout = _run(jcli.main, ["compare", *args], capsys)
        assert (rc, out) == (jrc, jout)
        codes.append(rc)
    assert codes == [0, 1, 0, 1, 1]


def test_write_array_equals_jax(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3))
    tarrayio.write_array(str(tmp_path / "t.array"), rgb)
    jarrayio.write_array(str(tmp_path / "j.array"), rgb)
    assert (tmp_path / "t.array").read_text() == \
        (tmp_path / "j.array").read_text()
    np.testing.assert_array_equal(
        tarrayio.read_array(str(tmp_path / "t.array")), rgb)


def test_decode_file_on_the_cpu():
    name = SMALL[1]
    got = tpipe.decode_file(fixture_path(name), device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, jarrayio.read_array(fixture_path(name, ".array")))


def test_defaults_stay_on_the_card(monkeypatch):
    args = tcli.parser().parse_args(["decode", "x.jpg"])
    assert (args.backend, args.device) == ("cuda", "cuda")
    # the JAX CLI's default would decode one image on the CPU
    seen = []
    monkeypatch.setattr(jcli, "_cmd_decode", lambda a: seen.append(a) or 0)
    assert jcli.main(["decode", "x.jpg"]) == 0
    assert seen[0].backend == "auto"


def test_runs_as_a_module(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "tpujpeg_torch.cli", "info",
         fixture_path(GOLDEN[2])],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["width"] == 120
    res = subprocess.run(
        [sys.executable, "-m", "tpujpeg_torch.cli", "decode",
         fixture_path(GOLDEN[2]), "-o", str(tmp_path / "x.bin"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert res.returncode != 0 and "unsupported output format" in res.stderr
