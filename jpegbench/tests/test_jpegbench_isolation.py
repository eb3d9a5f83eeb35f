"""What the benchmark may load, and where it refuses to run.

Top-level module names are compared whole: the program's package,
`tpujpeg_torch`, begins with the JAX package's name, `tpujpeg`.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

BENCH = ROOT / "jpegbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "tpujpeg", "bench", "benchmarks",
             "tools"}


def _python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    env = dict(os.environ if env is None else env)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_a_run_loads_nothing_forbidden():
    """A whole run of each cell (tiny, on the CPU, traced) and every
    metric reader, in a fresh process: sys.modules afterwards."""
    code = f"""
import sys, json
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH / 'tests')!r}]
from conftest import run_tiny
from jpegbench import harness
for cell in ("rst444.loader128", "ilsvrc420.loader128"):
    run_tiny(cell, seconds=0.3, trace=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "tpujpeg_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_sources_import_nothing_forbidden():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"tpujpeg_torch",
                                                  "torch"}), path
    res = _python(f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
import jpegbench.reference.pixels
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"tpujpeg_torch", "torch"})


def _run(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "jpegbench/run.py", "--workload", "rst444.loader128",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600)


def test_run_refuses_without_a_card():
    res = _run(ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and jpegbench/ in it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "jpegbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
