"""A plain NumPy baseline JPEG encoder (ITU T.81 sequential DCT, Huffman).

The benchmark makes its own streams, because the machine that holds the
card has no JPEG encoder.  `encode` writes a baseline stream with
libjpeg's Annex K quantisation tables scaled to a quality, the Annex K
Huffman tables, 4:4:4 or 4:2:0 sampling and, where asked, a restart
marker after every MCU row.  `coefficients` is the encoder's own
quantisation step alone: the plain reference (jpegbench/reference/)
starts from what it returns, so the reference never reads a stream.

Everything is vectorised over blocks and symbols; nothing here imports
torch or the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# zigzag index z -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# ITU T.81 Annex K.1, natural order (libjpeg's std_luminance_quant_tbl and
# std_chrominance_quant_tbl)
_QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
], np.int64)

# ITU T.81 Annex K.3 (Tables K.3-K.6): counts of codes of each length 1-16
# and the symbols in code order
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# sampling -> (h, v) of each component (Y, Cb, Cr)
SAMPLINGS = {"4:4:4": ((1, 1), (1, 1), (1, 1)),
             "4:2:0": ((2, 2), (1, 1), (1, 1))}


def quant_tables(quality: int) -> np.ndarray:
    """libjpeg's jpeg_set_quality: the Annex K tables scaled, clamped to
    1..255 (baseline).  int64 [2, 64] natural order (luma, chroma)."""
    if not 1 <= quality <= 100:
        raise ValueError(f"quality {quality} outside 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = np.stack([_QUANT_LUMA, _QUANT_CHROMA])
    return np.clip((base * scale + 50) // 100, 1, 255)


def _canonical(spec) -> tuple[np.ndarray, np.ndarray]:
    """Annex C: code and length of every symbol of a (bits, vals) table."""
    bits, vals = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


# [table class: 0 luma, 1 chroma] -> code / length per symbol
_DC_CODE, _DC_LEN = map(np.stack, zip(*(_canonical(t)
                                        for t in (_DC_LUMA, _DC_CHROMA))))
_AC_CODE, _AC_LEN = map(np.stack, zip(*(_canonical(t)
                                        for t in (_AC_LUMA, _AC_CHROMA))))


@dataclass
class Geometry:
    """Frame layout of one stream: what the decoder derives from SOF."""

    width: int
    height: int
    sampling: str

    @property
    def factors(self):
        return SAMPLINGS[self.sampling]

    @property
    def max_h(self) -> int:
        return max(h for h, _ in self.factors)

    @property
    def max_v(self) -> int:
        return max(v for _, v in self.factors)

    @property
    def mcus_x(self) -> int:
        return -(-self.width // (8 * self.max_h))

    @property
    def mcus_y(self) -> int:
        return -(-self.height // (8 * self.max_v))

    @property
    def blocks_per_mcu(self) -> int:
        return sum(h * v for h, v in self.factors)

    @property
    def n_blocks(self) -> int:
        return self.mcus_x * self.mcus_y * self.blocks_per_mcu

    def block_components(self) -> np.ndarray:
        """Component index of every block in scan order."""
        pattern = np.repeat(np.arange(3), [h * v for h, v in self.factors])
        return np.tile(pattern, self.mcus_x * self.mcus_y)


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, which is T.81's FDCT in 2-D."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    d[0] /= np.sqrt(2.0)
    return d


_DCT = _dct_matrix()


def _ycbcr(rgb: np.ndarray) -> list[np.ndarray]:
    """JFIF RGB -> Y, Cb, Cr in float64."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[8 hb, 8 wb] -> [hb, wb, 8, 8]."""
    hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3)


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """D X D^T over [..., 8, 8], as two large matrix products."""
    shape = blocks.shape
    a = blocks.reshape(-1, 8) @ _DCT.T                        # X D^T
    a = a.reshape(-1, 8, 8).transpose(0, 2, 1).reshape(-1, 8) @ _DCT.T
    return a.reshape(-1, 8, 8).transpose(0, 2, 1).reshape(shape)


def coefficients(rgb: np.ndarray, sampling: str,
                 quality: int) -> np.ndarray:
    """The quantised DCT coefficients of an image: int32 [n_blocks, 64],
    zigzag order, scan order (interleaved MCUs, each component's blocks
    row by row inside its MCU), DC absolute.

    The frame is padded to whole MCUs by repeating its last row and
    column; 4:2:0 chroma is the mean of each 2 x 2 of the padded plane."""
    h, w = rgb.shape[:2]
    geom = Geometry(w, h, sampling)
    qt = quant_tables(quality)
    ph, pw = geom.mcus_y * 8 * geom.max_v, geom.mcus_x * 8 * geom.max_h
    per_comp = []
    for ci, plane in enumerate(_ycbcr(rgb)):
        plane = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        ch, cv = geom.factors[ci]
        fy, fx = geom.max_v // cv, geom.max_h // ch
        if fy > 1 or fx > 1:
            plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3))
        coef = _fdct(_blocks(plane - 128.0))
        q = qt[0 if ci == 0 else 1].reshape(8, 8)
        zz = np.rint(coef / q).reshape(*coef.shape[:2], 64)[..., ZIGZAG]
        # [mcus_y, cv, mcus_x, ch, 64] -> [mcus_y, mcus_x, cv * ch, 64]
        zz = zz.reshape(geom.mcus_y, cv, geom.mcus_x, ch, 64)
        per_comp.append(zz.transpose(0, 2, 1, 3, 4).reshape(
            geom.mcus_y, geom.mcus_x, cv * ch, 64))
    return np.concatenate(per_comp, axis=2).reshape(-1, 64).astype(np.int32)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Magnitude category of each value: bits of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    nz = a > 0
    n[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return n


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """T.81 F.1.2.1: v itself, or for v < 0 the low `size` bits of v - 1."""
    return np.where(v >= 0, v, v + (np.int64(1) << size) - 1)


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(a.size, np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def entropy_code(zz: np.ndarray, geom: Geometry,
                 restart_interval: int) -> tuple[np.ndarray, int]:
    """Huffman-code the blocks of `coefficients` into the scan's bytes.

    Returns (the entropy-coded segment as it stands in the file: byte
    stuffed, RST markers between restart intervals, uint8; the number of
    entropy-coded bytes without stuffing and markers)."""
    n = zz.shape[0]
    comp = geom.block_components()
    table = (comp > 0).astype(np.int64)
    mcu = np.arange(n) // geom.blocks_per_mcu
    seg = (mcu // restart_interval if restart_interval
           else np.zeros(n, np.int64))
    n_seg = int(seg[-1]) + 1
    zz = zz.astype(np.int64)

    # DC differences, each component's predictor reset at every restart
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        d = dc[idx]
        prev = np.concatenate([[0], d[:-1]])
        s = seg[idx]
        prev[np.concatenate([[True], s[1:] != s[:-1]])] = 0
        diff[idx] = d - prev
    size = _bit_length(diff)
    dc_val = (_DC_CODE[table, size] << size) | _extra_bits(diff, size)
    dc_len = _DC_LEN[table, size] + size

    # AC: one symbol per nonzero, behind (run // 16) ZRLs; EOB after the
    # last nonzero unless it is at position 63
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.concatenate([[True], b[1:] != b[:-1]])
    prev_k = np.concatenate([[0], k[:-1]])
    prev_k[first] = 0
    run = k - prev_k - 1
    zrl = run >> 4
    size = _bit_length(v)
    sym = ((run & 15) << 4) | size
    tb = table[b]
    if np.any(_AC_LEN[tb, sym] == 0) or np.any(_DC_LEN[table, _bit_length(
            diff)] == 0):
        raise ValueError("a coefficient outside the Annex K tables' range")
    ac_val = (_AC_CODE[tb, sym] << size) | _extra_bits(v, size)
    ac_len = _AC_LEN[tb, sym] + size
    last = np.concatenate([b[1:] != b[:-1], [True]]) if b.size else b
    last_k = np.zeros(n, np.int64)
    last_k[b[last]] = k[last]
    eob = last_k < 63

    width = zrl + 1                      # symbols each nonzero brings
    count = 1 + np.bincount(b, weights=width, minlength=n).astype(
        np.int64) + eob
    start = _exclusive_cumsum(count)
    total = int(count.sum())
    vals = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    vals[start], lens[start] = dc_val, dc_len
    before = _exclusive_cumsum(width)    # symbols of earlier nonzeros
    slot = start[b] + 1 + before - before[np.flatnonzero(first)][
        np.cumsum(first) - 1] + zrl
    vals[slot], lens[slot] = ac_val, ac_len
    zi = np.flatnonzero(zrl > 0)
    if zi.size:
        reps = zrl[zi]
        pos = (np.repeat(slot[zi] - reps, reps)
               + np.arange(reps.sum()) - np.repeat(_exclusive_cumsum(reps),
                                                   reps))
        vals[pos] = np.repeat(_AC_CODE[tb[zi], 0xF0], reps)
        lens[pos] = np.repeat(_AC_LEN[tb[zi], 0xF0], reps)
    eb = np.flatnonzero(eob)
    vals[start[eb] + count[eb] - 1] = _AC_CODE[table[eb], 0]
    lens[start[eb] + count[eb] - 1] = _AC_LEN[table[eb], 0]

    # bit placement: each restart interval starts on a byte, and its last
    # byte is padded with 1-bits
    sym_seg = np.repeat(seg, count)
    seg_bits = np.bincount(sym_seg, weights=lens, minlength=n_seg).astype(
        np.int64)
    seg_bytes = (seg_bits + 7) // 8
    seg_off = _exclusive_cumsum(seg_bytes)
    cum = _exclusive_cumsum(lens)
    seg_first = _exclusive_cumsum(np.bincount(sym_seg, minlength=n_seg))
    bit_off = seg_off[sym_seg] * 8 + cum - cum[seg_first][sym_seg]
    # a symbol (at most 27 bits) at bit offset o % 8 spans at most 5
    # bytes: place it in a 40-bit word and add each byte into its place
    # (the symbols' bits are disjoint, so adding is OR)
    n_bytes = int(seg_bytes.sum())
    word = vals << (40 - bit_off % 8 - lens)
    at = bit_off // 8
    packed = np.zeros(n_bytes + 5, np.int64)
    for i in range(5):
        packed += np.bincount(at + i, weights=(word >> (32 - 8 * i)) & 0xFF,
                              minlength=n_bytes + 5).astype(np.int64)
    pad = seg_bytes * 8 - seg_bits
    packed[seg_off + seg_bytes - 1] |= (np.int64(1) << pad) - 1
    packed = packed[:n_bytes].astype(np.uint8)

    ff = np.flatnonzero(packed == 0xFF)
    stuffed = np.insert(packed, ff + 1, 0)
    if n_seg > 1:
        bnd = seg_off[1:]
        at = bnd + np.searchsorted(ff, bnd)
        marks = np.stack([np.full(n_seg - 1, 0xFF),
                          0xD0 + np.arange(n_seg - 1) % 8], axis=1)
        stuffed = np.insert(stuffed, np.repeat(at, 2), marks.reshape(-1))
    return stuffed.astype(np.uint8), n_bytes


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def _dht(cls: int, ident: int, spec) -> bytes:
    bits, vals = spec
    return bytes([(cls << 4) | ident, *bits, *vals])


def headers(geom: Geometry, quality: int, restart_interval: int) -> bytes:
    """SOI through SOS: JFIF APP0, DQT, SOF0, DHT, DRI where asked."""
    qt = quant_tables(quality)[:, ZIGZAG]
    out = bytes([0xFF, 0xD8])
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, bytes([0, *qt[0]]) + bytes([1, *qt[1]]))
    sof = bytes([8]) + geom.height.to_bytes(2, "big") \
        + geom.width.to_bytes(2, "big") + bytes([3])
    for ci, (h, v) in enumerate(geom.factors):
        sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
    out += _segment(0xC0, sof)
    out += _segment(0xC4, _dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
                    + _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA))
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


def restart_interval_of(geom: Geometry, restart: str) -> int:
    """The DRI value of a restart policy: "none" or "mcu_row"."""
    if restart == "none":
        return 0
    if restart == "mcu_row":
        return geom.mcus_x
    raise ValueError(f"unknown restart policy {restart!r}")


def encode(rgb: np.ndarray, sampling: str, quality: int,
           restart: str) -> tuple[bytes, int]:
    """A baseline JPEG of uint8 [H, W, 3] RGB.  Returns (the stream, its
    entropy-coded bytes without stuffing and markers)."""
    geom = Geometry(rgb.shape[1], rgb.shape[0], sampling)
    ri = restart_interval_of(geom, restart)
    scan, n_scan = entropy_code(coefficients(rgb, sampling, quality), geom,
                                ri)
    return headers(geom, quality, ri) + scan.tobytes() + b"\xff\xd9", n_scan
