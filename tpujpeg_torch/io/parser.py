"""Host-side JFIF/JPEG marker parser.

Produces a :class:`JpegImage` — the full "decode plan" the device pipeline
consumes: frame geometry, per-component sampling/table assignment, quant
tables, canonical Huffman tables, and the de-stuffed entropy bitstream split
at restart-marker boundaries.

This is a strict superset of the reference's `extract()`
(`cuda-decoder/src/parser.cu:360-471`): the reference only walks
SOI/APP0/DQT/SOF0/DHT/SOS for 4:4:4 streams and does not understand DRI/RSTn;
we additionally handle arbitrary APPn/COM segments, multiple tables per
DQT/DHT segment, 16-bit quant tables, subsampled chroma (4:2:0/4:2:2/4:1:1,
grayscale), and restart intervals — which are what make principled
segment-parallel entropy decoding possible on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    M_COM,
    M_DHT,
    M_DNL,
    M_DQT,
    M_DRI,
    M_EOI,
    M_SOF0,
    M_SOF1,
    M_SOI,
    M_SOS,
    UNSUPPORTED_SOF,
    pad8,
)
from ..errors import JpegError
from .destuff import destuff_scan
from .huffman import HuffmanTable, parse_dht_payload


@dataclass
class Component:
    """One frame component (Y, Cb, or Cr)."""

    component_id: int
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    quant_id: int
    dc_table_id: int = 0  # filled from SOS
    ac_table_id: int = 0


@dataclass
class JpegImage:
    """Everything needed to decode one baseline JPEG scan."""

    width: int
    height: int
    precision: int
    components: list[Component]
    quant_tables: dict[int, np.ndarray]  # id -> uint16[64] zigzag order
    huffman: dict[int, HuffmanTable]  # DHT header byte -> table
    restart_interval: int  # MCUs between restarts; 0 = none
    scan_data: np.ndarray  # de-stuffed entropy bytes, uint8
    segment_offsets: np.ndarray  # byte offset of each restart segment start
    path: str | None = None

    # -- derived geometry ---------------------------------------------------

    @property
    def max_h(self) -> int:
        return max(c.h for c in self.components)

    @property
    def max_v(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcu_width(self) -> int:
        return 8 * self.max_h

    @property
    def mcu_height(self) -> int:
        return 8 * self.max_v

    @property
    def mcus_x(self) -> int:
        return -(-self.width // self.mcu_width)

    @property
    def mcus_y(self) -> int:
        return -(-self.height // self.mcu_height)

    @property
    def n_mcus(self) -> int:
        return self.mcus_x * self.mcus_y

    @property
    def blocks_per_mcu(self) -> int:
        return sum(c.h * c.v for c in self.components)

    @property
    def padded_width(self) -> int:
        return pad8(self.width)

    @property
    def padded_height(self) -> int:
        return pad8(self.height)

    @property
    def is_444(self) -> bool:
        return all(c.h == 1 and c.v == 1 for c in self.components) and (
            len(self.components) == 3
        )

    @property
    def sampling(self) -> str:
        if len(self.components) == 1:
            return "gray"
        y = self.components[0]
        key = (y.h, y.v)
        return {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0", (4, 1): "4:1:1", (1, 2): "4:4:0"}.get(
            key, f"{y.h}x{y.v}"
        )

    def n_segments(self) -> int:
        return int(self.segment_offsets.shape[0])

    def mcu_block_pattern(self) -> list[int]:
        """Component index of each block within one MCU, in scan order."""
        pattern: list[int] = []
        for ci, c in enumerate(self.components):
            pattern.extend([ci] * (c.h * c.v))
        return pattern


def _u16(data: np.ndarray, pos: int) -> int:
    return (int(data[pos]) << 8) | int(data[pos + 1])


def parse(data: bytes | bytearray | np.ndarray, path: str | None = None) -> JpegImage:
    """Parse a baseline JPEG byte stream into a :class:`JpegImage`.

    Raises :class:`JpegError` on truncation, unsupported coding processes
    (progressive/arithmetic/12-bit), or malformed tables — the structured
    error surface the reference lacks (it only has a CUDA-error wrapper,
    parser.cu:317-321).
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size < 4 or buf[0] != 0xFF or buf[1] != M_SOI:
        raise JpegError("not a JPEG: missing SOI marker")

    quant_tables: dict[int, np.ndarray] = {}
    huffman: dict[int, HuffmanTable] = {}
    components: list[Component] = []
    width = height = precision = 0
    restart_interval = 0

    pos = 2
    while True:
        # Markers may be preceded by fill bytes (0xFF padding).
        if pos + 1 >= buf.size:
            raise JpegError("truncated JPEG: ran out of bytes before SOS")
        if buf[pos] != 0xFF:
            raise JpegError(f"expected marker at byte {pos}, got {buf[pos]:#x}")
        while pos < buf.size and buf[pos] == 0xFF:
            pos += 1
        if pos >= buf.size:
            raise JpegError("truncated JPEG: dangling 0xFF")
        marker = int(buf[pos])
        pos += 1

        if marker == M_SOI:
            continue
        if marker == M_EOI:
            raise JpegError("EOI before SOS: no image data")
        if marker in UNSUPPORTED_SOF:
            raise JpegError(
                f"unsupported coding process (SOF marker 0xFF{marker:02X}); "
                "only baseline/extended sequential Huffman is supported"
            )

        if pos + 2 > buf.size:
            raise JpegError("truncated marker segment header")
        seg_len = _u16(buf, pos)
        if seg_len < 2 or pos + seg_len > buf.size:
            raise JpegError(f"bad segment length {seg_len} for marker 0xFF{marker:02X}")
        payload = buf[pos + 2 : pos + seg_len]
        next_pos = pos + seg_len

        if marker == M_DQT:
            # One DQT segment may carry several tables (ITU T.81 B.2.4.1);
            # the reference assumes exactly one 8-bit table per segment
            # (parser.cu:382-399) — we handle the general case.
            q = 0
            while q < payload.size:
                pq_tq = int(payload[q])
                pq, tq = pq_tq >> 4, pq_tq & 0x0F
                if tq > 3 or pq > 1:
                    raise JpegError(f"bad DQT header {pq_tq:#x}")
                if pq == 0:
                    table = payload[q + 1 : q + 65].astype(np.uint16)
                    q += 65
                else:
                    raw = payload[q + 1 : q + 129]
                    table = ((raw[0::2].astype(np.uint16) << 8) | raw[1::2]).astype(np.uint16)
                    q += 129
                if table.size != 64:
                    raise JpegError("truncated DQT table")
                quant_tables[tq] = table
        elif marker in (M_SOF0, M_SOF1):
            precision = int(payload[0])
            if precision != 8:
                raise JpegError(f"unsupported sample precision {precision}")
            height = _u16(payload, 1)
            width = _u16(payload, 3)
            n_comp = int(payload[5])
            if n_comp not in (1, 3):
                raise JpegError(f"unsupported component count {n_comp}")
            components = []
            for ci in range(n_comp):
                cid = int(payload[6 + 3 * ci])
                hv = int(payload[7 + 3 * ci])
                tq = int(payload[8 + 3 * ci])
                components.append(
                    Component(component_id=cid, h=hv >> 4, v=hv & 0x0F, quant_id=tq)
                )
            if height == 0:
                raise JpegError("DNL-deferred height is not supported")
        elif marker == M_DHT:
            try:
                huffman.update(parse_dht_payload(payload))
            except ValueError as e:
                raise JpegError(f"bad DHT segment: {e}") from e
        elif marker == M_DRI:
            restart_interval = _u16(payload, 0)
        elif marker == M_DNL:
            raise JpegError("DNL segments are not supported")
        elif marker == M_SOS:
            if not components:
                raise JpegError("SOS before SOF")
            n_scan = int(payload[0])
            if n_scan != len(components):
                raise JpegError("non-interleaved (multi-scan) streams not supported")
            by_id = {c.component_id: c for c in components}
            for si in range(n_scan):
                cs = int(payload[1 + 2 * si])
                tables = int(payload[2 + 2 * si])
                if cs not in by_id:
                    raise JpegError(f"SOS references unknown component {cs}")
                by_id[cs].dc_table_id = tables >> 4
                by_id[cs].ac_table_id = tables & 0x0F
            scan_data, segment_offsets = destuff_scan(buf, next_pos)
            return JpegImage(
                width=width,
                height=height,
                precision=precision,
                components=components,
                quant_tables=quant_tables,
                huffman=huffman,
                restart_interval=restart_interval,
                scan_data=scan_data,
                segment_offsets=segment_offsets,
                path=path,
            )
        # APPn / COM / unknown segments: skip payload.
        pos = next_pos


def parse_file(path: str) -> JpegImage:
    with open(path, "rb") as f:
        return parse(f.read(), path=path)
