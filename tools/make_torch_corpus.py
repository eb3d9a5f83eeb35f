"""Write the committed corpora for the PyTorch/CUDA port.

Sixteen 640x640 photo-mosaic images (bench.py's `_make_photo_image`,
seeds 0-15), encoded 4:4:4 at quality 90 twice:

  * tests/fixtures/rst640/NN.jpg: a restart marker every MCU row
    (`bench._encode(arr, 90, rst_rows=1)`, OpenCV);
  * tests/fixtures/photo640/NN.jpg: no restart markers
    (`bench._encode(arr, 90, rst_rows=0)`, PIL, subsampling=0), the
    streams of the speculative path.

And sixteen photo mosaics of mixed sizes for the size-bucketed path:

  * tests/fixtures/mixed_rst/NN_WxH.jpg: widths and heights drawn from
    seed 2024 in 624..800 px (not all multiples of 8, so all fall in the
    101 x 101 MCU size-class bucket), 4:4:4, quality 90, a restart marker
    every MCU row (the row-aligned intervals the bucket plan needs).

The machine that runs chip_smoke.py has no JPEG encoder, so the streams
ship as files.

Run from the repo root:  python tools/make_torch_corpus.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
SIZE, QUALITY, N_SEEDS = 640, 90, 16
CORPORA = {"rst640": 1, "photo640": 0}   # directory -> restart rows
MIXED, MIXED_SEED, MIXED_LO, MIXED_HI = "mixed_rst", 2024, 624, 800


def main() -> None:
    sys.path.insert(0, ROOT)
    import bench

    arrs = [bench._make_photo_image(SIZE, seed) for seed in range(N_SEEDS)]
    for name, rst_rows in CORPORA.items():
        out = os.path.join(FIXTURES, name)
        os.makedirs(out, exist_ok=True)
        total = 0
        for seed, arr in enumerate(arrs):
            data = bench._encode(arr, QUALITY, rst_rows=rst_rows)
            with open(os.path.join(out, f"{seed:02d}.jpg"), "wb") as f:
                f.write(data)
            total += len(data)
        print(f"wrote {N_SEEDS} streams, {total} bytes, to {out}")

    import numpy as np

    rng = np.random.default_rng(MIXED_SEED)
    sizes = rng.integers(MIXED_LO, MIXED_HI + 1, size=(N_SEEDS, 2))
    out = os.path.join(FIXTURES, MIXED)
    os.makedirs(out, exist_ok=True)
    total = 0
    for seed, (w, h) in enumerate(sizes.tolist()):
        arr = bench._make_photo_image(max(w, h), 100 + seed)[:h, :w]
        data = bench._encode(np.ascontiguousarray(arr), QUALITY, rst_rows=1)
        with open(os.path.join(out, f"{seed:02d}_{w}x{h}.jpg"), "wb") as f:
            f.write(data)
        total += len(data)
    print(f"wrote {N_SEEDS} mixed-size streams, {total} bytes, to {out}")


if __name__ == "__main__":
    main()
