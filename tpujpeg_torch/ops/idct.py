"""Integer 8x8 inverse DCT on int tensors (plain PyTorch).

Counterpart of tpujpeg/ops/idct.py: the same fixed-point butterflies as
the reference (cpp-decoder/src/idct.cpp:33-133), row pass >> 8, column
pass >> 14 with a clip to [-256, 255], all in int32 wraparound
arithmetic.

The reference and the JAX package let int32 adds and multiplies wrap.
PyTorch does not promise that for int32, so these functions take int64
tensors, do every add, multiply and left shift exactly in int64, and
reduce to int32 (`_w32`) right before each arithmetic right shift.  Add,
multiply and shift-left commute with reduction mod 2^32, so the bits
equal the int32 wraparound result; int64 never overflows here (inputs
are dequantized int16 times int16 quant, < 2^23; the largest product is
below 2^47).
"""

from __future__ import annotations

import torch

from ..constants import C1, C2, C3, C5, C6, C7

_2_31 = 1 << 31
_MASK32 = (1 << 32) - 1


def _w32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (as int64)."""
    return ((x + _2_31) & _MASK32) - _2_31


def _rowpass(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = x0 * (1 << 11) + 128
    x1 = x1 * (1 << 11)
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
    x2 = _w32(181 * (x4 + x5) + 128) >> 8
    x4 = _w32(181 * (x4 - x5) + 128) >> 8
    return (
        _w32(x7 + x1) >> 8,
        _w32(x3 + x2) >> 8,
        _w32(x0 + x4) >> 8,
        _w32(x8 + x6) >> 8,
        _w32(x8 - x6) >> 8,
        _w32(x0 - x4) >> 8,
        _w32(x3 - x2) >> 8,
        _w32(x7 - x1) >> 8,
    )


def _colpass(x0, x1, x2, x3, x4, x5, x6, x7):
    x0 = x0 * (1 << 8) + 8192
    x1 = x1 * (1 << 8)
    x8 = C7 * (x4 + x5) + 4
    x4 = _w32(x8 + (C1 - C7) * x4) >> 3
    x5 = _w32(x8 - (C1 + C7) * x5) >> 3
    x8 = C3 * (x6 + x7) + 4
    x6 = _w32(x8 - (C3 - C5) * x6) >> 3
    x7 = _w32(x8 - (C3 + C5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = C6 * (x3 + x2) + 4
    x2 = _w32(x1 - (C2 + C6) * x2) >> 3
    x3 = _w32(x1 + (C2 - C6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = _w32(181 * (x4 + x5) + 128) >> 8
    x4 = _w32(181 * (x4 - x5) + 128) >> 8

    def out(v):
        return torch.clamp(_w32(v) >> 14, -256, 255)

    return (
        out(x7 + x1),
        out(x3 + x2),
        out(x0 + x4),
        out(x8 + x6),
        out(x8 - x6),
        out(x0 - x4),
        out(x3 - x2),
        out(x7 - x1),
    )


def idct_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Two-pass integer IDCT over [..., 8, 8] blocks -> int32 [..., 8, 8]
    in [-256, 255] (the row pass over each row, then the column pass over
    each column, as `idct_planes`).  Input values are taken as int32."""
    b = _w32(blocks.to(torch.int64))
    cols = [b[..., :, k] for k in range(8)]
    r = _rowpass(cols[0], cols[4], cols[6], cols[2], cols[1], cols[7],
                 cols[5], cols[3])
    b = torch.stack(r, dim=-1)
    rows = [b[..., k, :] for k in range(8)]
    r = _colpass(rows[0], rows[4], rows[6], rows[2], rows[1], rows[7],
                 rows[5], rows[3])
    return torch.stack(r, dim=-2).to(torch.int32)


def idct_planes(planes64: torch.Tensor) -> torch.Tensor:
    """IDCT in coefficient-major layout: [..., 64, N] -> [..., 64, N].

    Row p of the input holds natural-order coefficient p of N blocks; row
    p of the output holds raster position p (int32, in [-256, 255]).
    Input values are taken as int32 (dequantized coefficients).
    """
    x = _w32(planes64.to(torch.int64))
    rows = []
    for rr in range(8):
        c = [x[..., 8 * rr + k, :] for k in range(8)]
        rows.append(_rowpass(c[0], c[4], c[6], c[2], c[1], c[7], c[5], c[3]))
    out = [None] * 64
    for cc in range(8):
        col = [rows[k][cc] for k in range(8)]
        res = _colpass(col[0], col[4], col[6], col[2],
                       col[1], col[7], col[5], col[3])
        for rr in range(8):
            out[8 * rr + cc] = res[rr]
    return torch.stack(out, dim=-2).to(torch.int32)
