"""Build the port's native host runtime (_tpjnative.so) with g++.

Own copy of tpujpeg/runtime/native/build.py.  The native layer is a plain
C ABI shared library loaded via ctypes.  It is built on first use into
tpujpeg_torch/_build/ (never next to the sources) and rebuilt when any
source file is newer than the library.  Thread-safe via an exclusive lock
file (batch callers may race to import from many threads/processes).

The first attempt links with -fopenmp.  Where that link fails (a g++
without libgomp), the build is tried again without OpenMP: the same
decoder, one thread per call.  `built_with_openmp()` says which build a
process got (runtime/host.backend_name prints it).
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "src"
BUILD_DIR = _HERE.parent.parent / "_build"
LIB_PATH = BUILD_DIR / "_tpjnative.so"
SERIAL_STAMP = BUILD_DIR / "_tpjnative.serial"

CXX = os.environ.get("CXX", "g++")
CXXFLAGS = [
    "-O3",
    "-std=c++17",
    "-fPIC",
    "-shared",
    "-fno-exceptions",
    "-fno-rtti",
    "-Wall",
    "-Werror",
]
# per build: with OpenMP, then without (the pragmas are then unknown)
_VARIANTS = (["-fopenmp"], ["-Wno-unknown-pragmas"])


def _needs_build() -> bool:
    if not LIB_PATH.exists():
        return True
    lib_mtime = LIB_PATH.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime for src in SRC_DIR.glob("*.cpp")
    )


def built_with_openmp() -> bool:
    """Whether the library on disk is the OpenMP build."""
    return LIB_PATH.exists() and not SERIAL_STAMP.exists()


def _compile(sources: list[str]) -> None:
    tmp = LIB_PATH.with_suffix(".so.tmp")
    march = os.environ.get("TPJ_NATIVE_MARCH", "native")
    errors = []
    for extra in _VARIANTS:
        cmd = [CXX, *CXXFLAGS, *extra, "-o", str(tmp), *sources]
        if march:
            cmd.insert(1, f"-march={march}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            if "-fopenmp" in extra:
                SERIAL_STAMP.unlink(missing_ok=True)
            else:
                SERIAL_STAMP.write_text("built without OpenMP\n")
            os.replace(tmp, LIB_PATH)
            return
        errors.append(" ".join(cmd) + "\n" + proc.stderr)
    raise RuntimeError("native build failed:\n" + "\n".join(errors))


def build(force: bool = False) -> Path:
    """Compile the shared library if stale. Returns its path."""
    if not force and not _needs_build():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if force or _needs_build():
                sources = sorted(str(p) for p in SRC_DIR.glob("*.cpp"))
                if not sources:
                    raise FileNotFoundError(f"no C++ sources in {SRC_DIR}")
                _compile(sources)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return LIB_PATH


if __name__ == "__main__":
    print(build(force=True), "openmp" if built_with_openmp() else "serial")
