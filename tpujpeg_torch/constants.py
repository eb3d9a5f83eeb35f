"""Shared constants of tpujpeg_torch (own copy of tpujpeg/constants.py).

Semantics mirror the reference decoder (debesheedas/GPU-JPEG-Decoder) so that
decoded pixels are bit-exact against its golden outputs:

- zigzag tables: reference `cuda-decoder/src/parser.h:57-66`
- integer IDCT constants: reference `cuda-decoder/src/parser.h:42-47`
  (C[k] = round(2048*sqrt(2)*cos(k*pi/16)))
- color constants: reference `cuda-decoder/src/parser.cu:566-568`
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# JPEG marker bytes (the second byte of the 0xFFxx marker word).
# ---------------------------------------------------------------------------
M_SOI = 0xD8
M_EOI = 0xD9
M_SOS = 0xDA
M_DQT = 0xDB
M_DNL = 0xDC
M_DRI = 0xDD
M_DHT = 0xC4
M_SOF0 = 0xC0  # baseline sequential DCT (the only coding process supported)
M_SOF1 = 0xC1  # extended sequential, Huffman: same entropy/IDCT path
M_SOF2 = 0xC2  # progressive: rejected
M_APP0 = 0xE0
M_COM = 0xFE
M_RST0 = 0xD0
M_RST7 = 0xD7

# SOF markers that signal coding processes we do NOT support.
UNSUPPORTED_SOF = {0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}

# ---------------------------------------------------------------------------
# Zigzag order.
#
# ZIGZAG_TO_NATURAL[p] = index in the zigzag-ordered coefficient vector that
# lands at *natural* (row-major) position p.  This is exactly the reference's
# `zigzagEntries` LUT (parser.h:57-66), used as
#   natural[p] = zz[ZIGZAG_TO_NATURAL[p]]       (parser.cu:535-540)
# ---------------------------------------------------------------------------
ZIGZAG_TO_NATURAL = np.array(
    [
        0, 1, 5, 6, 14, 15, 27, 28,
        2, 4, 7, 13, 16, 26, 29, 42,
        3, 8, 12, 17, 25, 30, 41, 43,
        9, 11, 18, 24, 31, 40, 44, 53,
        10, 19, 23, 32, 39, 45, 52, 54,
        20, 22, 33, 38, 46, 51, 55, 60,
        21, 34, 37, 47, 50, 56, 59, 61,
        35, 36, 48, 49, 57, 58, 62, 63,
    ],
    dtype=np.int32,
)

# NATURAL_TO_ZIGZAG[z] = natural position of zigzag index z (the inverse map).
NATURAL_TO_ZIGZAG = np.argsort(ZIGZAG_TO_NATURAL).astype(np.int32)

# ---------------------------------------------------------------------------
# Integer IDCT constants (reference parser.h:42-47).
# ---------------------------------------------------------------------------
C1 = 2841  # 2048*sqrt(2)*cos(1*pi/16)
C2 = 2676  # 2048*sqrt(2)*cos(2*pi/16)
C3 = 2408  # 2048*sqrt(2)*cos(3*pi/16)
C5 = 1609  # 2048*sqrt(2)*cos(5*pi/16)
C6 = 1108  # 2048*sqrt(2)*cos(6*pi/16)
C7 = 565   # 2048*sqrt(2)*cos(7*pi/16)

# ---------------------------------------------------------------------------
# Color conversion constants.  The reference computes these sub-expressions in
# *double* precision and only rounds the final per-pixel value to float32
# (`float red = Cr * (2 - 2*0.299) + Y`, parser.cu:566-568).  We keep the f64
# values here; the device path uses their f32 roundings, which is validated
# exhaustively over the full int16 input domain (tools/check_color_exact.py).
# ---------------------------------------------------------------------------
C_RED = 2.0 - 2.0 * 0.299    # 1.402
C_BLUE = 2.0 - 2.0 * 0.114   # 1.772
C_GY_B = 0.114
C_GY_R = 0.299
C_GY_DIV = 0.587


def pad8(x: int) -> int:
    """Round up to a multiple of 8 (reference parser.cu:330-331)."""
    return ((x + 7) // 8) * 8
