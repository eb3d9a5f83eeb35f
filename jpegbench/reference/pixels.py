"""The plain reference decoder's pixel stage, in NumPy.

It starts from quantised coefficients (what the encoder quantised: no
stream is read) and computes the pixel contract that a strict decode of
the program is exact to:

- dequantisation in the zigzag domain, then the inverse zigzag;
- the two-pass fixed-point IDCT (rows >> 8, columns >> 14, clipped to
  [-256, 255]), the arithmetic of the reference project's serial C++
  decoder (debesheedas/GPU-JPEG-Decoder, cpp-decoder/src/idct.cpp);
- chroma upsampling: sample replication (box), or libjpeg's triangle
  filter (jdsample.c "fancy") where asked, over the MCU-padded planes;
- the crop to the picture's true size;
- colour: products in float64, each channel rounded once to float32,
  +128 in float32, a truncating cast, clamped to [0, 255]
  (cpp-decoder/utils/color.cpp).

A frozen copy: it imports nothing of the program, and a later change to
the program's arithmetic has to show up here as a mismatch.
"""

from __future__ import annotations

import numpy as np

# zigzag index z -> natural (row-major) position
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# round(2048 * sqrt(2) * cos(k * pi / 16))
C1, C2, C3, C5, C6, C7 = 2841, 2676, 2408, 1609, 1108, 565

C_RED = 2.0 - 2.0 * 0.299
C_BLUE = 2.0 - 2.0 * 0.114
C_GY_B = 0.114
C_GY_R = 0.299
C_GY_DIV = 0.587

# sampling -> (h, v) of Y, Cb, Cr
SAMPLINGS = {"4:4:4": ((1, 1), (1, 1), (1, 1)),
             "4:2:0": ((2, 2), (1, 1), (1, 1))}


def _rows(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = (x0 << 11) + 128
    x1 = x1 << 11
    x8 = C7 * (x4 + x5)
    x4 = x8 + (C1 - C7) * x4
    x5 = x8 - (C1 + C7) * x5
    x8 = C3 * (x6 + x7)
    x6 = x8 - (C3 - C5) * x6
    x7 = x8 - (C3 + C5) * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C6 * (x3 + x2)
    x2 = x1 - (C2 + C6) * x2
    x3 = x1 + (C2 - C6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    return ((x7 + x1) >> 8, (x3 + x2) >> 8, (x0 + x4) >> 8, (x8 + x6) >> 8,
            (x8 - x6) >> 8, (x0 - x4) >> 8, (x3 - x2) >> 8, (x7 - x1) >> 8)


def _cols(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = (x0 << 8) + 8192
    x1 = x1 << 8
    x8 = C7 * (x4 + x5) + 4
    x4 = (x8 + (C1 - C7) * x4) >> 3
    x5 = (x8 - (C1 + C7) * x5) >> 3
    x8 = C3 * (x6 + x7) + 4
    x6 = (x8 - (C3 - C5) * x6) >> 3
    x7 = (x8 - (C3 + C5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C6 * (x3 + x2) + 4
    x2 = (x1 - (C2 + C6) * x2) >> 3
    x3 = (x1 + (C2 - C6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    out = ((x7 + x1), (x3 + x2), (x0 + x4), (x8 + x6),
           (x8 - x6), (x0 - x4), (x3 - x2), (x7 - x1))
    return tuple(np.clip(v >> 14, -256, 255) for v in out)


def idct(blocks: np.ndarray) -> np.ndarray:
    """int64 [n, 8, 8] natural-order dequantised blocks -> samples in
    [-256, 255].  The butterflies take columns 0, 4, 6, 2, 1, 7, 5, 3."""
    order = (0, 4, 6, 2, 1, 7, 5, 3)
    b = np.stack(_rows(*(blocks[..., :, k] for k in order)), axis=-1)
    return np.stack(_cols(*(b[..., k, :] for k in order)), axis=-2)


def _prev(s, axis):
    return np.concatenate([np.take(s, [0], axis=axis),
                           np.take(s, range(s.shape[axis] - 1), axis=axis)],
                          axis=axis)


def _next(s, axis):
    n = s.shape[axis]
    return np.concatenate([np.take(s, range(1, n), axis=axis),
                           np.take(s, [n - 1], axis=axis)], axis=axis)


def _interleave(even, odd, axis):
    shape = list(even.shape)
    shape[axis] *= 2
    return np.stack([even, odd], axis=axis + 1).reshape(shape)


def _triangle(s, axis, bias_even, bias_odd, shift):
    return _interleave((3 * s + _prev(s, axis) + bias_even) >> shift,
                       (3 * s + _next(s, axis) + bias_odd) >> shift, axis)


def upsample(plane: np.ndarray, fh: int, fv: int, fancy: bool) -> np.ndarray:
    """A centred plane ([-256, 255]) upsampled by (fh, fv) in {1, 2}.

    Box: sample replication.  Fancy (libjpeg's jdsample.c): samples are
    range-limited first; 2 x 2 keeps the vertical 3:1 column sums and
    rounds once in the horizontal pass (biases 8 and 7, >> 4); 2 x 1 and
    1 x 2 round with biases 1 and 2, >> 2; edges repeat."""
    if fh == 1 and fv == 1:
        return plane
    if not fancy:
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    s = np.clip(plane + 128, 0, 255)
    if fh == 2 and fv == 2:
        out = _interleave(_triangle(3 * s + _prev(s, 0), 1, 8, 7, 4),
                          _triangle(3 * s + _next(s, 0), 1, 8, 7, 4), 0)
    elif fh == 2:
        out = _triangle(s, 1, 1, 2, 2)
    else:
        out = _triangle(s, 0, 1, 2, 2)
    return out - 128


def colour(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Centred Y, Cb, Cr -> uint8 [..., 3] RGB."""
    yf = y.astype(np.float64)
    r32 = (C_RED * cr + yf).astype(np.float32)
    b32 = (C_BLUE * cb + yf).astype(np.float32)
    g32 = ((yf - C_GY_B * b32.astype(np.float64)
            - C_GY_R * r32.astype(np.float64)) / C_GY_DIV).astype(np.float32)
    out = np.empty(y.shape + (3,), np.uint8)
    for i, ch in enumerate((r32, g32, b32)):
        v = np.trunc(ch + np.float32(128.0)).astype(np.int32)
        out[..., i] = np.clip(v, 0, 255)
    return out


def decode(zz: np.ndarray, quant: np.ndarray, width: int, height: int,
           sampling: str, fancy: bool) -> np.ndarray:
    """Quantised coefficients -> uint8 [height, width, 3] RGB.

    zz: int [n_blocks, 64], zigzag order, scan order (interleaved MCUs,
    each component's blocks row by row inside its MCU), DC absolute.
    quant: [2, 64] zigzag order, luma then chroma (Cb and Cr share it)."""
    factors = SAMPLINGS[sampling]
    max_h = max(h for h, _ in factors)
    max_v = max(v for _, v in factors)
    mx, my = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    bpm = sum(h * v for h, v in factors)
    comp = np.tile(np.repeat(np.arange(3), [h * v for h, v in factors]),
                   mx * my)
    deq = zz.astype(np.int64) * quant.astype(np.int64)[np.minimum(comp, 1)]
    natural = np.empty_like(deq)
    natural[:, ZIGZAG] = deq
    samples = idct(natural.reshape(-1, 8, 8)).reshape(my, mx, bpm, 8, 8)
    planes, base = [], 0
    for h, v in factors:
        grid = samples[:, :, base:base + h * v].reshape(my, mx, v, h, 8, 8)
        base += h * v
        plane = grid.transpose(0, 2, 4, 1, 3, 5).reshape(my * v * 8,
                                                         mx * h * 8)
        plane = upsample(plane, max_h // h, max_v // v, fancy)
        planes.append(plane[:height, :width])
    return colour(*planes)
