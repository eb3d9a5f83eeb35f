"""Build, load and launch the port's hand-written CUDA kernels.

The sources under tpujpeg_torch/csrc/*.cu expose a plain C ABI.  At first
use they are compiled with nvcc for Hopper (sm_90a), one nvcc per source
started together, and linked into one shared library,
tpujpeg_torch/_build/libtpjcuda.so, loaded with ctypes:
pointers travel as c_void_p (tensor.data_ptr()), the stream as the raw
cudaStream_t of torch.cuda.current_stream(), and `launch` makes the
tensors' device current around the call.  Nothing here imports torch's
C++ headers, so a build takes seconds, not minutes.

The library is rebuilt when the hash of the sources and flags changes,
under an exclusive file lock (several processes may race to build).  A
failed build raises; there is no fallback.  Every C entry returns
cudaGetLastError() after its launch and `launch` raises on a non-zero
code, so a refused launch (bad grid, too much shared memory) never passes
silently.

`LAUNCHES` keeps one integer per kernel, bumped by `launch` and nowhere
else, so a run can show that its main path went through each kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libtpjcuda.so"
STAMP_PATH = BUILD_DIR / "libtpjcuda.hash"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # no FMA contraction anywhere: the pixel kernel's colour math must
    # round like the separate multiplies and adds of its plain version
    "-fmad=false",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry -> argtypes (all entries return int: a cudaError_t)
_SIGNATURES = {
    # xs, seg_n, table, table_words, meta(host), events, err_mal, err_env,
    # L, pitch, n_data, steps, bpc, mode, start_bits, start_bim,
    # chunk_bits, anchors, ablk, recm, state, wrap_at, skip, stream
    "tpj_fsm_scan": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # scan, n_bytes, start_bits, block_base, n_blocks, rows, n_comp, ctab,
    # roff, n_rows, pattern, bpm, n_steps, coeffs, n_coeffs, err, L, stream
    "tpj_decode_segments": [_P, _LL, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I,
                            _I, _P, _LL, _P, _I, _P],
    # ev, out, err, N, M, L, stream
    "tpj_place_events": [_P, _P, _P, _I, _I, _I, _P],
    # ev, p, o, N, L, stream
    "tpj_compact": [_P, _P, _P, _I, _I, _P],
    # p, o, o2, ovf, Np, L, C, gshift, stream
    "tpj_slot_unpack": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # o2, p, dense, Np, M, L, cshift, gshift, stream
    "tpj_slot_expand": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # p, o, p_out, o_out, Np, L, mask, direct, stream
    "tpj_compact_offsets": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    # ev, out, N, L, stream
    "tpj_compact_full": [_P, _P, _I, _I, _P],
    # cp, o, dense, err, N, M, L, stream
    "tpj_spread_full": [_P, _P, _P, _P, _I, _I, _I, _P],
    # coef, quant, dc, lanes, ext, rgb, risk, T, max_n, L, dc_lane, H, W,
    # mcus_x, lane_layout, exact, fconsts(host), dconsts(host), stream
    "tpj_pixels": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P, _P, _P],
    # coef, quant, dc, ext, planes, rgb, risk, coef_bytes, B, n_comp,
    # n_blocks, bpm, mcus_x, H, W, fancy, exact, per_image, comps(host),
    # fconsts(host), dconsts(host), stream
    "tpj_planes": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _LL, _P, _P, _P, _P],
    # src, lane_off, lane_len, xs, L, stride, stream
    "tpj_pack_lanes": [_P, _P, _P, _P, _I, _I, _P],
    # t, idx, out, R, T, K, blocks, group, stream
    "tpj_gather_rows": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # t, idx, out, T, N, blocks, stream
    "tpj_gather_table": [_P, _P, _P, _I, _I, _I, _P],
    # t, seed, out, T, steps, source, magic, l, stream
    "tpj_chain": [_P, _P, _P, _I, _I, _I, ctypes.c_uint, _I, _P],
    # t, seed, out, T, steps, source, stream: the chain's latency floor,
    # read by tools/bench_torch_gather.py through library(); no wrapper,
    # not in KERNELS, not counted
    "tpj_chain_floor": [_P, _P, _P, _I, _I, _I, _P],
}

# kernel name (as counted) -> C entry.  The three materialize-stage probes
# (ops/probes.py) run the kernels of csrc/routes.cu under names of their
# own, so a run can tell their launches from the routes'.
KERNELS = {
    "fsm_scan": "tpj_fsm_scan",
    "place_events": "tpj_place_events",
    "compact": "tpj_compact",
    "slot_unpack": "tpj_slot_unpack",
    "slot_expand": "tpj_slot_expand",
    "compact_offsets": "tpj_compact_offsets",
    "compact_full": "tpj_compact_full",
    "spread_full": "tpj_spread_full",
    "pixels": "tpj_pixels",
    "planes": "tpj_planes",
    "pack_lanes": "tpj_pack_lanes",
    "decode_segments": "tpj_decode_segments",
    "gather_rows": "tpj_gather_rows",
    "gather_table": "tpj_gather_table",
    "chain": "tpj_chain",
    "compact_fine": "tpj_compact_offsets",
    "compact_staged": "tpj_compact_offsets",
    "spread_ranked": "tpj_spread_full",
}

LAUNCHES = {name: 0 for name in KERNELS}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into LIB_PATH if the sources changed; return it.

    Raises RuntimeError (with nvcc's output) when the build fails."""
    want = _source_hash()

    def fresh() -> bool:
        return (
            LIB_PATH.exists()
            and STAMP_PATH.exists()
            and STAMP_PATH.read_text() == want
        )

    if fresh():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not fresh():
                _compile_and_link()
                STAMP_PATH.write_text(want)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return LIB_PATH


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run commands side by side; (returncode, output) of each."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
    except OSError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"cannot run nvcc: {e}") from e
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _compile_and_link() -> None:
    """One nvcc per source, all started together, then one link."""
    cu = [p for p in _sources() if p.suffix == ".cu"]
    if not cu:
        raise FileNotFoundError(f"no CUDA sources in {SRC_DIR}")
    objs = [BUILD_DIR / (p.stem + ".o") for p in cu]
    compile_cmds = [
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
        for p, o in zip(cu, objs)
    ]
    tmp = LIB_PATH.with_suffix(".so.tmp")
    link_cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    for cmds in (compile_cmds, [link_cmd]):
        for cmd, (rc, out) in zip(cmds, _run_all(cmds)):
            if rc != 0:
                raise RuntimeError(
                    "nvcc failed (%d): %s\n%s" % (rc, " ".join(cmd), out)
                )
    os.replace(tmp, LIB_PATH)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            dll = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = dll
    return _lib


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, device=None, *args) -> None:
    """Call kernel `name`'s C entry on `device` (None: the current one) with
    `args` and the device's current stream; raise if the launch was
    refused.

    The launch and the entry's cudaFuncSetAttribute act on the current
    device, so the call runs with `device` made current: a tensor on
    cuda:1 is never launched on while cuda:0 is current.  Counts the
    launch in LAUNCHES[name] (the only place counts change)."""
    import torch

    entry = getattr(library(), KERNELS[name])
    with torch.cuda.device(device):
        rc = entry(*args, current_stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


def check_cuda_tensor(name: str, t, dtype, ndim: int | None = None) -> None:
    """Validate a tensor handed to a kernel (device, dtype, contiguity)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
