"""Bit-exact NumPy oracle decoder (own copy of tpujpeg/oracle/decoder.py,
with the chroma upsampling of tpujpeg/ops/upsample.py written in numpy).

Mirrors the reference's serial C++ decoder semantics (`cpp-decoder/`), which
produced the golden `.array` files, and which the reference's CUDA decoder
matches exactly (reference README.md:172).  Every numerics choice cites the
reference:

- JPEG EXTEND ("decodeNumber"): cuda-decoder/utils/utils.cu:34-41
- entropy RLE/EOB/ZRL handling: cpp-decoder/src/parser.cpp:105-142
- dequantization in the zigzag domain: cpp-decoder/src/parser.cpp:111,130
- inverse zigzag: cpp-decoder/src/idct.cpp:24-31
- integer IDCT (row >>8, col >>14, clip [-256,255]): cpp-decoder/src/idct.cpp:33-133
  (computed in 32-bit int like the C++ oracle; the CUDA variant's int16
  stores coincide for in-range data)
- color conversion with double-precision products rounded to float32 and a
  truncating integer cast: cpp-decoder/utils/color.cpp:8-19

The oracle is also the host-side *entropy decoder* for the first pipeline
slice (the cudaH strategy: Huffman on host feeding device kernels,
legacy_versions/cudaH-implementation/src/parser.cu:281-311) until the native
C++ runtime takes over.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    C_BLUE,
    C_GY_B,
    C_GY_DIV,
    C_GY_R,
    C_RED,
    C1,
    C2,
    C3,
    C5,
    C6,
    C7,
    ZIGZAG_TO_NATURAL,
)
from ..errors import JpegError
from ..io.parser import JpegImage


# ---------------------------------------------------------------------------
# Entropy decoding (host)
# ---------------------------------------------------------------------------


def extend(size: int, bits: int) -> int:
    """JPEG EXTEND: map a `size`-bit magnitude to a signed value.

    Reference `decodeNumber` (utils.cu:34-41).  size == 0 yields 0 (the
    reference relies on shift-by-negative UB that resolves to returning the
    zero `bits` value; see SURVEY §4).
    """
    if size == 0:
        return 0
    half = 1 << (size - 1)
    return bits if bits >= half else bits - (2 * half - 1)


class _BitReader:
    """MSB-first bit reader over the de-stuffed scan bytes.

    Equivalent to the reference's device bit reader (utils.cu:6-20) but reads
    a 24-bit window per symbol so a 16-bit peek is one arithmetic expression.
    """

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: np.ndarray, start_byte: int = 0):
        # Zero-pad generously so peeks stay in bounds for up to one block of
        # runaway decode past the end; truncation is detected by the same
        # per-block `pos > nbits + 16` rule as the native runtime
        # (runtime/native/src/entropy.cpp:158), keeping corrupt-stream
        # behavior bit-identical across backends.
        self.data = np.concatenate([data, np.zeros(512, np.uint8)]).astype(np.uint8)
        self.pos = start_byte * 8
        self.nbits = data.size * 8

    def peek16(self) -> int:
        i = self.pos >> 3
        shift = self.pos & 7
        d = self.data
        if i + 2 >= d.size:
            # Consumption escaped even the zero pad: the stream is truncated
            # mid-scan.  Surface the structured error, never an IndexError.
            raise JpegError(
                f"scan data exhausted at bit {self.pos} (truncated stream)"
            )
        window = (int(d[i]) << 16) | (int(d[i + 1]) << 8) | int(d[i + 2])
        return (window >> (8 - shift)) & 0xFFFF

    def get_bits(self, n: int) -> int:
        if n == 0:
            return 0
        val = self.peek16() >> (16 - n)
        self.pos += n
        return val


def entropy_decode(img: JpegImage) -> np.ndarray:
    """Huffman-decode the scan into zigzag-order coefficient blocks.

    Returns int32 [n_mcus * blocks_per_mcu, 64] in scan order, with DC
    differences already accumulated (DPCM resolved; reset at restart
    boundaries per ITU T.81 E.1.2).
    """
    luts: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    for header, table in img.huffman.items():
        luts[(header >> 4, header & 0x0F)] = table.build_lut(16)

    pattern = img.mcu_block_pattern()
    comps = img.components
    n_blocks = img.n_mcus * img.blocks_per_mcu
    coeffs = np.zeros((n_blocks, 64), dtype=np.int32)

    seg_offsets = img.segment_offsets
    ri = img.restart_interval
    n_mcus = img.n_mcus

    reader = _BitReader(img.scan_data)
    dc_pred = [0] * len(comps)
    block_idx = 0
    seg_idx = 0

    for mcu in range(n_mcus):
        if ri and mcu > 0 and mcu % ri == 0:
            # Restart: advance to the next byte-aligned segment, reset DC.
            seg_idx += 1
            if seg_idx >= len(seg_offsets):
                raise JpegError(
                    f"stream ended early: expected restart segment {seg_idx}"
                )
            reader = _BitReader(img.scan_data, start_byte=int(seg_offsets[seg_idx]))
            dc_pred = [0] * len(comps)
        for ci in pattern:
            comp = comps[ci]
            block = coeffs[block_idx]
            # DC: size symbol, then EXTEND (cpp parser.cpp:105-110).
            sym, length = _decode_symbol(reader, luts[(0, comp.dc_table_id)])
            diff = extend(sym, reader.get_bits(sym))
            dc_pred[ci] += diff
            block[0] = dc_pred[ci]
            # AC: run/size symbols (cpp parser.cpp:113-135).
            k = 1
            lut_sym, lut_len = luts[(1, comp.ac_table_id)]
            while k < 64:
                sym, length = _decode_symbol(reader, (lut_sym, lut_len))
                if sym == 0:  # EOB
                    break
                run, size = sym >> 4, sym & 0x0F
                k += run
                if k < 64:
                    block[k] = extend(size, reader.get_bits(size))
                    k += 1
                else:
                    reader.get_bits(size)  # mirror reference: bits consumed
            if reader.pos > reader.nbits + 16:
                # same truncation rule as the native runtime (entropy.cpp:158)
                raise JpegError(
                    f"scan data exhausted at bit {reader.pos} (truncated stream)"
                )
            block_idx += 1
    return coeffs


def _decode_symbol(
    reader: _BitReader, lut: tuple[np.ndarray, np.ndarray]
) -> tuple[int, int]:
    lut_sym, lut_len = lut
    peek = reader.peek16()
    length = int(lut_len[peek])
    if length == 0:
        raise JpegError(f"invalid Huffman window {peek:#06x} at bit {reader.pos}")
    reader.pos += length
    return int(lut_sym[peek]), length


# ---------------------------------------------------------------------------
# Dequantization + inverse zigzag
# ---------------------------------------------------------------------------


def dequantize(img: JpegImage, coeffs_zz: np.ndarray) -> np.ndarray:
    """Multiply by the quant table in the zigzag domain, then reorder.

    Reference fuses dequant into entropy decode in the zigzag domain
    (cpp parser.cpp:111,130) and reorders afterwards (idct.cpp:24-31):
    natural[p] = zz[ZIGZAG_TO_NATURAL[p]].

    Returns int32 [n_blocks, 8, 8] natural-order dequantized blocks.
    """
    pattern = np.array(img.mcu_block_pattern(), dtype=np.int32)
    quant_by_comp = np.stack(
        [img.quant_tables[c.quant_id].astype(np.int32) for c in img.components]
    )  # [n_comp, 64] zigzag order
    block_quant = quant_by_comp[np.tile(pattern, img.n_mcus)]  # [n_blocks, 64]
    deq = coeffs_zz * block_quant
    natural = deq[:, ZIGZAG_TO_NATURAL]
    return natural.reshape(-1, 8, 8)


# ---------------------------------------------------------------------------
# Integer IDCT (vectorized over blocks; exact reference arithmetic)
# ---------------------------------------------------------------------------


def idct_blocks(blocks: np.ndarray) -> np.ndarray:
    """Two-pass fixed-point 8x8 IDCT over [..., 8, 8] int32 blocks.

    Row pass (>>8) then column pass (>>14 with clip to [-256, 255]),
    bit-identical to cpp-decoder/src/idct.cpp:33-133 (whose zero-AC shortcut
    is arithmetically equal to the general path, so we always run the general
    butterflies — which also matches the CUDA variant that dropped the
    branch, reference README.md:186).
    """
    b = blocks.astype(np.int64)  # headroom; all reference math fits in i32

    def rowpass(x0, x1, x2, x3, x4, x5, x6, x7):
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
        return (
            (x7 + x1) >> 8,
            (x3 + x2) >> 8,
            (x0 + x4) >> 8,
            (x8 + x6) >> 8,
            (x8 - x6) >> 8,
            (x0 - x4) >> 8,
            (x3 - x2) >> 8,
            (x7 - x1) >> 8,
        )

    def colpass(x0, x1, x2, x3, x4, x5, x6, x7):
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
        clip = lambda v: np.clip(v, -256, 255)
        return (
            clip((x7 + x1) >> 14),
            clip((x3 + x2) >> 14),
            clip((x0 + x4) >> 14),
            clip((x8 + x6) >> 14),
            clip((x8 - x6) >> 14),
            clip((x0 - x4) >> 14),
            clip((x3 - x2) >> 14),
            clip((x7 - x1) >> 14),
        )

    # Row pass: butterfly inputs are columns 0,4,6,2,1,7,5,3 of each row.
    c = [b[..., :, k] for k in range(8)]
    r = rowpass(c[0], c[4], c[6], c[2], c[1], c[7], c[5], c[3])
    b = np.stack(r, axis=-1)
    # Column pass: same permutation over rows.
    c = [b[..., k, :] for k in range(8)]
    r = colpass(c[0], c[4], c[6], c[2], c[1], c[7], c[5], c[3])
    return np.stack(r, axis=-2).astype(np.int32)


# ---------------------------------------------------------------------------
# Chroma upsampling: box (sample replication) and fancy (triangle filter)
# ---------------------------------------------------------------------------
#
# Integer-exact to libjpeg's jdsample.c: factor-2 horizontal
# out[2i] = (3*s[i] + s[i-1] + 1) >> 2, out[2i+1] = (3*s[i] + s[i+1] + 2)
# >> 2 with edge replication; factor 2x2 keeps the vertical 3:1 column sums
# unrounded and rounds once in the horizontal pass (biases 8/7, >> 4); other
# factors fall back to box, as libjpeg does.


def _edge_prev(s, axis):
    first = np.take(s, [0], axis=axis)
    body = np.take(s, range(s.shape[axis] - 1), axis=axis)
    return np.concatenate([first, body], axis=axis)


def _edge_next(s, axis):
    body = np.take(s, range(1, s.shape[axis]), axis=axis)
    last = np.take(s, [s.shape[axis] - 1], axis=axis)
    return np.concatenate([body, last], axis=axis)


def _interleave(even, odd, axis):
    stacked = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return stacked.reshape(shape)


def _fancy_axis(s, axis, bias_even, bias_odd, shift):
    even = (3 * s + _edge_prev(s, axis) + bias_even) >> shift
    odd = (3 * s + _edge_next(s, axis) + bias_odd) >> shift
    return _interleave(even, odd, axis)


def fancy_upsample(s: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """Triangle-upsample clamped samples [H, W] by (fh, fv) in {1, 2}."""
    if fh == 2 and fv == 2:
        cs_even = 3 * s + _edge_prev(s, 0)   # column sums, even output rows
        cs_odd = 3 * s + _edge_next(s, 0)    # ... and odd output rows
        return _interleave(_fancy_axis(cs_even, 1, 8, 7, 4),
                           _fancy_axis(cs_odd, 1, 8, 7, 4), 0)
    if fh == 2 and fv == 1:
        return _fancy_axis(s, 1, 1, 2, 2)
    if fh == 1 and fv == 2:
        return _fancy_axis(s, 0, 1, 2, 2)
    if fh == 1 and fv == 1:
        return s
    raise ValueError(
        f"fancy upsampling only supports factors 1-2, got {fh}x{fv}")


def upsample_plane(plane: np.ndarray, fh: int, fv: int,
                   fancy: bool) -> np.ndarray:
    """Upsample a centered int plane ([-256, 255] IDCT output) by (fh, fv).

    fancy=True clamps to samples first (libjpeg order: range-limit, then
    triangle filter), then re-centers; factors > 2 fall back to box."""
    if fh == 1 and fv == 1:
        return plane
    if fancy and fh <= 2 and fv <= 2:
        return fancy_upsample(np.clip(plane + 128, 0, 255), fh, fv) - 128
    if fh > 1:
        plane = np.repeat(plane, fh, axis=1)
    if fv > 1:
        plane = np.repeat(plane, fv, axis=0)
    return plane


# ---------------------------------------------------------------------------
# Plane assembly + chroma upsampling
# ---------------------------------------------------------------------------


def assemble_planes(
    img: JpegImage, pixels: np.ndarray, fancy: bool = False
) -> list[np.ndarray]:
    """Arrange IDCT output blocks into full-size per-component planes.

    `pixels` is int32 [n_blocks, 8, 8] in scan order.  Returns one
    [padded_mcu_h, padded_mcu_w] plane per component, chroma upsampled to
    the full MCU-padded frame for subsampled streams: sample replication
    (box) by default, libjpeg's triangle filter with fancy=True
    (`upsample_plane` below).  For 4:4:4 this is the reference's
    block->raster scatter (cpp parser.cpp:172-190).
    """
    n_mcus = img.n_mcus
    bpm = img.blocks_per_mcu
    blocks = pixels.reshape(n_mcus, bpm, 8, 8)
    planes: list[np.ndarray] = []
    base = 0
    for c in img.components:
        nb = c.h * c.v
        comp_blocks = blocks[:, base : base + nb]  # [n_mcus, h*v, 8, 8]
        base += nb
        grid = comp_blocks.reshape(img.mcus_y, img.mcus_x, c.v, c.h, 8, 8)
        # -> [mcus_y, v, 8, mcus_x, h, 8]
        plane = grid.transpose(0, 2, 4, 1, 3, 5).reshape(
            img.mcus_y * c.v * 8, img.mcus_x * c.h * 8
        )
        plane = upsample_plane(
            plane, img.max_h // c.h, img.max_v // c.v, fancy
        )
        planes.append(plane)
    return planes


# ---------------------------------------------------------------------------
# Color conversion (exact float semantics)
# ---------------------------------------------------------------------------


def ycbcr_to_rgb_exact(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Reference color conversion with exact C++ mixed-precision semantics.

    cpp color.cpp:8-19 / cuda parser.cu:566-573: the products are computed in
    double, each channel value is rounded once to float32 (the C++ `float`
    assignment), +128 is added in float32, then a truncating integer cast and
    clamp to [0, 255].
    """
    yf = y.astype(np.float64)
    r32 = (C_RED * cr + yf).astype(np.float32)
    b32 = (C_BLUE * cb + yf).astype(np.float32)
    g32 = (
        (yf - C_GY_B * b32.astype(np.float64) - C_GY_R * r32.astype(np.float64))
        / C_GY_DIV
    ).astype(np.float32)
    out = np.empty(y.shape + (3,), dtype=np.int32)
    for i, ch in enumerate((r32, g32, b32)):
        v = np.trunc(ch + np.float32(128.0)).astype(np.int32)
        out[..., i] = np.clip(v, 0, 255)
    return out


# ---------------------------------------------------------------------------
# Full oracle decode
# ---------------------------------------------------------------------------


def decode(img: JpegImage, fancy: bool = False) -> np.ndarray:
    """Decode to an int32 [height, width, 3] RGB array in [0, 255].

    fancy=True selects libjpeg triangle chroma upsampling for subsampled
    streams (no effect on 4:4:4/grayscale).
    """
    coeffs = entropy_decode(img)
    natural = dequantize(img, coeffs)
    pixels = idct_blocks(natural)
    planes = assemble_planes(img, pixels, fancy=fancy)
    if len(planes) == 1:
        yp = planes[0][: img.height, : img.width]
        zeros = np.zeros_like(yp)
        rgb = ycbcr_to_rgb_exact(yp, zeros, zeros)
    else:
        yp, cbp, crp = (p[: img.height, : img.width] for p in planes)
        rgb = ycbcr_to_rgb_exact(yp, cbp, crp)
    return rgb



def decode_file(path: str) -> np.ndarray:
    """Decode the JPEG file at `path` (`decode`, box upsampling)."""
    from ..io.parser import parse_file

    return decode(parse_file(path))
