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

The restart corpus once more with tables optimised for each image:

  * tests/fixtures/rst640_opt/NN.jpg: the 640x640 images, 4:4:4,
    quality 90, a restart marker every MCU row, Huffman tables optimised
    per image (OpenCV's IMWRITE_JPEG_OPTIMIZE): four tables of its own
    per stream, the traffic on which the gather route derives its
    kernel's tables for every new table set (`write_optimized`).

The same three corpora once more with 4:2:0 chroma (16 x 16 px MCUs):

  * tests/fixtures/rst640_420/NN.jpg: the 640x640 images, a restart
    marker every MCU row (interval = ceil(w / 16) = 40 MCUs), OpenCV;
  * tests/fixtures/photo640_420/NN.jpg: the same images without restart
    markers (PIL, subsampling=2);
  * tests/fixtures/mixed_rst_420/NN_WxH.jpg: the 16 mixed sizes, a
    restart marker every MCU row.

And one small stream (200x152, quality 90, seed 7) per remaining
sampling, for the routes that the 4:2:0 chunks do not reach:

  * tests/fixtures/sampling_small/{422,440,411,gray}_rst.jpg: 4:2:2,
    4:4:0, 4:1:1 and grayscale with a restart marker every MCU row, and
    gray.jpg: grayscale without restart markers.

And one huge stream for the stripe-sharded decode:

  * tests/fixtures/huge8192_420.jpg: tools/validate_huge.py's image (a
    smooth gradient in each channel) at 8192 x 8192, 4:2:0, quality 40
    (PIL, subsampling=2, no restart markers), about 1.07 MB; 512 MCU rows,
    so it splits into 8 stripes of 64 (`write_huge`).  The JAX tool's
    16384 x 16384 default is 7.4 MB even at 4:4:4 and is not committed.

And the runtime-against-size series of benchmarks/bench_runtime.py:

  * tests/fixtures/runtime_sizes/S.jpg for S = 200, 400, ..., 2000:
    bench.py's synthetic `_make_image(S, S)` (seed S), 4:4:4, quality
    90, a restart marker every MCU row (`bench._encode(arr, 90,
    rst_rows=1)`), about 6.5 MB in all: the inputs of
    benchmarks/bench_torch_runtime.py (`write_runtime_sizes`).

The machine that runs chip_smoke.py and the port's tools has no JPEG
encoder, so the streams ship as files.

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
OPTIMIZED = "rst640_opt"
MIXED, MIXED_SEED, MIXED_LO, MIXED_HI = "mixed_rst", 2024, 624, 800
SMALL, SMALL_W, SMALL_H, SMALL_SEED = "sampling_small", 200, 152, 7
HUGE, HUGE_SIZE, HUGE_QUALITY = "huge8192_420.jpg", 8192, 40
RUNTIME, RUNTIME_SIZES = "runtime_sizes", range(200, 2001, 200)


def encode_sampled(arr, quality: int, sampling: str, rst_rows: int) -> bytes:
    """Encode RGB `arr` with chroma `sampling` ("420", "422", "440",
    "411", or "gray" for the first channel alone); rst_rows > 0 puts a
    restart marker every rst_rows MCU rows (OpenCV; the interval counts
    MCUs, which are 8 * h_max px wide), 0 none (PIL for "420")."""
    import cv2

    mcu_w = {"420": 16, "422": 16, "440": 8, "411": 32, "gray": 8}[sampling]
    if not rst_rows and sampling == "420":
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=quality, subsampling=2)
        return buf.getvalue()
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
             cv2.IMWRITE_JPEG_RST_INTERVAL,
             rst_rows * -(-arr.shape[1] // mcu_w)]
    if sampling == "gray":
        src = arr[:, :, 0]
    else:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)]
        src = arr[:, :, ::-1]
    ok, enc = cv2.imencode(".jpg", src, flags)
    assert ok
    return enc.tobytes()


def write_optimized(arrs) -> None:
    """tests/fixtures/rst640_opt: `arrs` with a restart marker every MCU
    row and Huffman tables optimised per image."""
    import cv2

    out = os.path.join(FIXTURES, OPTIMIZED)
    total = 0
    for seed, arr in enumerate(arrs):
        ok, enc = cv2.imencode(".jpg", arr[:, :, ::-1], [
            cv2.IMWRITE_JPEG_QUALITY, QUALITY,
            cv2.IMWRITE_JPEG_RST_INTERVAL, -(-arr.shape[1] // 8),
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            cv2.IMWRITE_JPEG_OPTIMIZE, 1])
        assert ok
        total += _write(out, f"{seed:02d}.jpg", enc.tobytes())
    print(f"wrote {N_SEEDS} streams with optimised tables, {total} bytes, "
          f"to {out}")


def write_huge() -> None:
    """tests/fixtures/huge8192_420.jpg: tools/validate_huge.py's recipe
    (its lines 55-66) at HUGE_SIZE, 4:2:0."""
    import io

    import numpy as np
    from PIL import Image

    n = HUGE_SIZE
    yy = np.linspace(0, 255, n, dtype=np.float32)
    xx = np.linspace(0, 255, n, dtype=np.float32)
    base = (yy[:, None] * 0.5 + xx[None, :] * 0.5).astype(np.uint8)
    arr = np.stack([base, base[::-1], base.T[:, ::-1]], axis=-1)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=HUGE_QUALITY,
                              subsampling=2)
    size = _write(FIXTURES, HUGE, buf.getvalue())
    print(f"wrote {n}x{n} 4:2:0, {size} bytes, to "
          f"{os.path.join(FIXTURES, HUGE)}")


def write_runtime_sizes(bench) -> None:
    """tests/fixtures/runtime_sizes: benchmarks/bench_runtime.py's
    synthetic series (its `_make_image(size, size)`, q90, rst_rows=1)."""
    out = os.path.join(FIXTURES, RUNTIME)
    total = sum(
        _write(out, f"{s}.jpg",
               bench._encode(bench._make_image(s, s), QUALITY, rst_rows=1))
        for s in RUNTIME_SIZES)
    print(f"wrote {len(RUNTIME_SIZES)} runtime-series streams, {total} "
          f"bytes, to {out}")


def _write(folder: str, name: str, data: bytes) -> int:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, name), "wb") as f:
        f.write(data)
    return len(data)


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
    write_optimized(arrs)

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

    # the 4:2:0 corpora: the same images, 16 x 16 px MCUs
    for name, rst_rows in CORPORA.items():
        out = os.path.join(FIXTURES, name + "_420")
        total = sum(
            _write(out, f"{seed:02d}.jpg",
                   encode_sampled(arr, QUALITY, "420", rst_rows))
            for seed, arr in enumerate(arrs))
        print(f"wrote {N_SEEDS} 4:2:0 streams, {total} bytes, to {out}")
    out = os.path.join(FIXTURES, MIXED + "_420")
    total = 0
    for seed, (w, h) in enumerate(sizes.tolist()):
        arr = bench._make_photo_image(max(w, h), 100 + seed)[:h, :w]
        total += _write(out, f"{seed:02d}_{w}x{h}.jpg", encode_sampled(
            np.ascontiguousarray(arr), QUALITY, "420", 1))
    print(f"wrote {N_SEEDS} mixed-size 4:2:0 streams, {total} bytes, to {out}")

    # one small stream per remaining sampling
    small = np.ascontiguousarray(
        bench._make_photo_image(SMALL_W, SMALL_SEED)[:SMALL_H, :SMALL_W])
    out = os.path.join(FIXTURES, SMALL)
    total = 0
    for sampling in ("422", "440", "411", "gray"):
        total += _write(out, f"{sampling}_rst.jpg",
                        encode_sampled(small, QUALITY, sampling, 1))
    total += _write(out, "gray.jpg", encode_sampled(small, QUALITY, "gray", 0))
    print(f"wrote 5 small streams, {total} bytes, to {out}")
    write_huge()
    write_runtime_sizes(bench)


if __name__ == "__main__":
    main()
