"""Reader/writer for the reference's `.array` text output format (own
copy of tpujpeg/io/arrayio.py).

Format (reference `cuda-decoder/src/parser.cu:736-743`): first line
"height width", then three lines of space-separated integers — the R, G, B
planes flattened row-major, each followed by a trailing space.
"""

from __future__ import annotations

import numpy as np


def write_array(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] RGB to the reference text format."""
    h, w = rgb.shape[:2]
    with open(path, "w") as f:
        f.write(f"{h} {w}\n")
        for ch in range(3):
            plane = np.asarray(rgb[..., ch]).reshape(-1)
            f.write(" ".join(str(int(v)) for v in plane))
            f.write(" \n")


def read_array(path: str) -> np.ndarray:
    """Read the reference text format into an int32 [H, W, 3] array."""
    with open(path) as f:
        h, w = (int(t) for t in f.readline().split())
        planes = []
        for _ in range(3):
            row = np.array(f.readline().split(), dtype=np.int32)
            planes.append(row.reshape(h, w))
    return np.stack(planes, axis=-1)
