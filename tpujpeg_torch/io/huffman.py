"""Canonical Huffman tables for baseline JPEG entropy decoding.

The reference builds a pointer tree from each DHT payload and then flattens it
into two 256-entry arrays indexed by symbol (`codes[256]`, `codeLengths[256]`,
reference `cuda-decoder/src/huffmanTree.cpp:40-53`, `.h:52-53`).  Because the
tree is filled left-first in order of increasing code length, the resulting
codes are exactly the *canonical* JPEG codes, so we construct them directly
from the (counts, symbols) DHT payload without any tree.

For decoding we do not use the reference's 256-way linear scan
(`match_huffman_code`, parser.cu:5-19).  Instead we build a direct-indexed
lookup table over a 16-bit peek window: LUT[peek16 >> (16-maxlen)] ->
(symbol, code_length).  Since JPEG codes are <= 16 bits and prefix-free, every
16-bit window maps to exactly one leading code.  This turns one decode step
into a single gather, which is the shape both the host runtime and the Pallas
device decoder want.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np


@dataclass
class HuffmanTable:
    """One canonical Huffman table (DC or AC, one table class/id).

    Attributes:
      counts: 16-entry uint8 array, number of codes of length 1..16.
      symbols: the code values in canonical order (concatenated by length).
      codes: 256-entry uint16, canonical code for each symbol value
        (valid only where lengths[sym] > 0) — layout-compatible with the
        reference's flat device tables (huffmanTree.h:52-53).
      lengths: 256-entry int32 code length per symbol value (0 = absent).
    """

    counts: np.ndarray
    symbols: np.ndarray
    codes: np.ndarray = field(init=False)
    lengths: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        counts = np.asarray(self.counts, dtype=np.int64)
        symbols = np.asarray(self.symbols, dtype=np.uint8)
        if counts.shape != (16,):
            raise ValueError(f"DHT counts must have 16 entries, got {counts.shape}")
        if int(counts.sum()) != symbols.size:
            raise ValueError(
                f"DHT symbol count mismatch: counts say {int(counts.sum())}, "
                f"got {symbols.size} symbols"
            )
        codes = np.zeros(256, dtype=np.uint16)
        lengths = np.zeros(256, dtype=np.int32)
        code = 0
        k = 0
        for bit_length in range(1, 17):
            for _ in range(int(counts[bit_length - 1])):
                sym = int(symbols[k])
                if lengths[sym] != 0:
                    raise ValueError(f"duplicate symbol {sym:#x} in DHT")
                codes[sym] = code
                lengths[sym] = bit_length
                code += 1
                k += 1
            if code > (1 << bit_length):
                raise ValueError("DHT is over-subscribed (not a prefix code)")
            code <<= 1
        self.codes = codes
        self.lengths = lengths

    # -- decoding -----------------------------------------------------------

    @property
    def max_length(self) -> int:
        return int(self.lengths.max(initial=0))

    def build_lut(self, bits: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """Direct-indexed decode LUT over a `bits`-wide peek window.

        Returns (lut_symbol uint8 [2**bits], lut_length uint8 [2**bits]).
        Windows that do not start with any valid code get length 0 (invalid);
        a conforming stream never produces them.
        """
        if bits < self.max_length:
            raise ValueError(f"LUT width {bits} < max code length {self.max_length}")
        lut_sym = np.zeros(1 << bits, dtype=np.uint8)
        lut_len = np.zeros(1 << bits, dtype=np.uint8)
        for sym in range(256):
            length = int(self.lengths[sym])
            if length == 0:
                continue
            code = int(self.codes[sym])
            lo = code << (bits - length)
            hi = (code + 1) << (bits - length)
            lut_sym[lo:hi] = sym
            lut_len[lo:hi] = length
        return lut_sym, lut_len

    def decode_one(self, peek16: int) -> tuple[int, int]:
        """Decode one symbol from a 16-bit big-endian peek. Returns (sym, len).

        Reference behavior: `match_huffman_code` (parser.cu:5-19) compares the
        top `len` bits of the 16-bit window against each symbol's code.
        """
        for sym in range(256):
            length = int(self.lengths[sym])
            if length and (peek16 >> (16 - length)) == int(self.codes[sym]):
                return sym, length
        raise ValueError(f"no Huffman code matches window {peek16:#06x}")


_dht_cache: dict[bytes, dict[int, "HuffmanTable"]] = {}
# BatchDecoder's parse pool hits this cache from several threads; the lock
# keeps insert-after-build atomic (CPython dict ops are atomic, but the
# check-then-insert pair is not, and cached tables are shared objects).
_dht_lock = threading.Lock()


def parse_dht_payload(payload: bytes | np.ndarray) -> dict[int, HuffmanTable]:
    """Parse a DHT segment payload (may contain several tables).

    Returns {table_header_byte: HuffmanTable} where the header byte is
    (table_class << 4) | table_id — e.g. 0x00 DC-luma, 0x10 AC-luma, matching
    the reference's tree map keys (parser.cu:415, 340-349).

    Results are cached on the payload bytes: batches overwhelmingly reuse
    one table family (encoders emit the Annex K defaults), and rebuilding
    the canonical code arrays per image was a measured host cost at batch
    scale.  Tables are immutable by convention; callers get a shallow copy
    of the mapping.
    """
    key = bytes(payload)
    with _dht_lock:
        hit = _dht_cache.get(key)
    if hit is not None:
        return dict(hit)
    data = np.frombuffer(bytes(payload), dtype=np.uint8)
    tables: dict[int, HuffmanTable] = {}
    pos = 0
    while pos < data.size:
        header = int(data[pos])
        table_class = header >> 4
        table_id = header & 0x0F
        if table_class > 1 or table_id > 3:
            raise ValueError(f"bad DHT header byte {header:#x}")
        counts = data[pos + 1 : pos + 17]
        if counts.size != 16:
            raise ValueError("truncated DHT segment")
        n = int(counts.sum())
        symbols = data[pos + 17 : pos + 17 + n]
        if symbols.size != n:
            raise ValueError("truncated DHT symbol list")
        if table_class == 0 and n and int(symbols.max()) > 15:
            # DC symbols are EXTEND bit counts; >15 would make decoders read
            # more magnitude bits than any peek window holds (T.81 F.1.2.1).
            raise ValueError("DC Huffman table defines size symbols > 15")
        tables[header] = HuffmanTable(counts=counts, symbols=symbols)
        pos += 17 + n
    with _dht_lock:
        if len(_dht_cache) < 256:
            _dht_cache[key] = dict(tables)
    return tables
