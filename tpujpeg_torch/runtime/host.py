"""Host entropy-decode runtime dispatch (own copy of tpujpeg/runtime/host.py).

Selects the fastest available host-side Huffman decoder:
  1. the port's native C++ runtime (runtime/native/, built with g++ into
     tpujpeg_torch/_build/ and loaded via ctypes), or
  2. the NumPy oracle decoder where no native build succeeds.

`backend_name()` says which one a process got: "native-cpp" (built with
OpenMP), "native-cpp-serial" (the compiler has no OpenMP runtime; same
decoder, one thread per call) or "numpy-oracle".  All three give the same
bits.  The batch engine uses this decoder for the host route and as the
reference of chip_smoke.py; the device path is ops/fsm.py.
"""

from __future__ import annotations

import numpy as np

from ..io.parser import JpegImage
from ..oracle import decoder as oracle

_native = None
_native_checked = False


def _load_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from .native import lib as native_lib

            _native = native_lib.load()
        except Exception:
            _native = None
    return _native


def entropy_decode(img: JpegImage, threads: int = 0) -> np.ndarray:
    """Huffman-decode the scan -> int32 [n_blocks, 64] zigzag coefficients.

    threads caps the native decoder's OpenMP team (0 = all cores); batch
    callers decoding many images on a pool pass 1."""
    native = _load_native()
    if native is not None:
        return native.entropy_decode(img, threads=threads)
    return oracle.entropy_decode(img)


def backend_name() -> str:
    if _load_native() is None:
        return "numpy-oracle"
    from .native import build

    return "native-cpp" if build.built_with_openmp() else "native-cpp-serial"


def decode_cpu(
    img: JpegImage, fancy: bool = False, threads: int = 0
) -> np.ndarray:
    """Full CPU decode: native entropy + native pixel stage.

    Bit-identical to the oracle on every stream
    (tests/test_torch_imports.py).  Returns uint8 [height, width, 3] RGB.
    """
    native = _load_native()
    if native is None:
        return oracle.decode(img, fancy=fancy).astype(np.uint8)
    from .native.lib import Int16RangeError

    n_blocks = img.n_mcus * img.blocks_per_mcu
    try:
        coeffs = np.empty((n_blocks, 64), np.int16)
        native.entropy_decode(img, out=coeffs, threads=threads)
    except Int16RangeError:
        # corrupt-but-decodable DC walk outside int16: int32 redo keeps
        # "same garbage bit-for-bit" parity with the oracle
        coeffs = native.entropy_decode(img, threads=threads)
    return native.pixels(img, coeffs, fancy=fancy, threads=threads)
