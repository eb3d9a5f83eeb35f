"""Write the committed restart-marker corpus for the PyTorch/CUDA port.

Sixteen 640x640 photo-mosaic images (bench.py's `_make_photo_image`,
seeds 0-15), encoded 4:4:4 at quality 90 with a restart marker every MCU
row (`bench._encode(arr, 90, rst_rows=1)`), written to
tests/fixtures/rst640/NN.jpg.  The machine that runs chip_smoke.py has
no JPEG encoder, so the streams ship as files.

Run from the repo root:  python tools/make_torch_corpus.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(ROOT, "tests", "fixtures", "rst640")
SIZE, QUALITY, N_SEEDS = 640, 90, 16


def main() -> None:
    sys.path.insert(0, ROOT)
    import bench

    os.makedirs(OUT, exist_ok=True)
    total = 0
    for seed in range(N_SEEDS):
        data = bench._encode(bench._make_photo_image(SIZE, seed), QUALITY,
                             rst_rows=1)
        with open(os.path.join(OUT, f"{seed:02d}.jpg"), "wb") as f:
            f.write(data)
        total += len(data)
    print(f"wrote {N_SEEDS} streams, {total} bytes, to {OUT}")


if __name__ == "__main__":
    main()
