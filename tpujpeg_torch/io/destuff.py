"""Vectorized entropy-segment extraction: byte de-stuffing + RST segmentation.

The reference de-stuffs with a byte-at-a-time host loop that only understands
0xFF00 (drop the 00) and 0xFFD9 (stop) — `cuda-decoder/src/parser.cu:450-464`.
That loop is serial and becomes the host bottleneck at batch scale (SURVEY
§3.2).  Here the whole transform is vectorized NumPy over the byte array:

  1. find all 0xFF positions and classify the following byte,
  2. locate the scan terminator (EOI or any non-RST marker),
  3. build a keep-mask (drop stuffed 0x00 bytes and RSTn marker pairs),
  4. compact with one boolean gather, and map restart-marker positions to
     byte offsets in the de-stuffed stream.

Restart markers give the entropy decoder its parallelism: each segment starts
byte-aligned with DC predictors reset (ITU T.81 E.1.2), so segments decode
independently — the lane-parallel answer to the reference's speculative
self-synchronizing bitstream split (parser.cu:132-208).
"""

from __future__ import annotations

import os

import numpy as np

from ..errors import JpegError

_RST_LO, _RST_HI = 0xD0, 0xD7


_native = None
_native_checked = False


def _native_runtime():
    """The C++ runtime's destuff, if it builds on this box (else None)."""
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        if not os.environ.get("TPJ_NO_NATIVE"):
            try:
                from ..runtime.native import lib as _nlib  # lazy: import cycle

                _native = _nlib.load()
            except Exception:  # noqa: BLE001 - any toolchain failure
                _native = None
    return _native


def destuff_scan(buf: np.ndarray, start: int) -> tuple[np.ndarray, np.ndarray]:
    """De-stuff the entropy-coded scan starting at byte `start`.

    Args:
      buf: the whole JPEG file as uint8.
      start: index of the first entropy-coded byte (just past the SOS header).

    Returns:
      (scan_data, segment_offsets): de-stuffed bytes, and for each restart
      segment the byte offset where it starts in `scan_data` (first entry 0).
    """
    sub = buf[start:]
    if sub.size == 0:
        raise JpegError("empty scan")

    rt = _native_runtime()
    if rt is not None:
        return rt.destuff(sub)

    ff_pos = np.flatnonzero(sub == 0xFF)
    # A trailing lone 0xFF is malformed; clamp the lookahead.
    nxt = np.zeros_like(ff_pos)
    in_range = ff_pos + 1 < sub.size
    nxt[in_range] = sub[ff_pos[in_range] + 1]

    is_stuff = nxt == 0x00
    is_rst = (nxt >= _RST_LO) & (nxt <= _RST_HI)
    is_fill = nxt == 0xFF  # fill bytes before a marker
    is_term = ~(is_stuff | is_rst | is_fill)

    term_idx = np.flatnonzero(is_term)
    if term_idx.size == 0:
        raise JpegError("truncated scan: no terminating marker (EOI missing)")
    end = int(ff_pos[term_idx[0]])  # exclusive end of entropy data

    live = ff_pos < end
    ff_pos, is_stuff, is_rst = ff_pos[live], is_stuff[live], is_rst[live]

    keep = np.ones(end, dtype=bool)
    keep[ff_pos[is_stuff] + 1] = False  # drop the stuffed 0x00
    rst_at = ff_pos[is_rst]
    keep[rst_at] = False  # drop the 0xFF
    keep[rst_at + 1] = False  # drop the RSTn byte

    scan_data = sub[:end][keep]
    # De-stuffed offset where each post-RST segment begins = number of kept
    # bytes strictly before the marker pair.
    kept_excl = np.concatenate([[0], np.cumsum(keep)])
    seg_starts = kept_excl[rst_at] if rst_at.size else np.empty(0, np.int64)
    segment_offsets = np.concatenate([[0], seg_starts]).astype(np.int64)
    return np.ascontiguousarray(scan_data), segment_offsets
