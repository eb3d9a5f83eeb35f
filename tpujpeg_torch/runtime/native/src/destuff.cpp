// Native byte de-stuffing + restart segmentation.
//
// Plays the role of the reference's host de-stuff loop
// (cuda-decoder/src/parser.cu:450-464), extended with RSTn segmentation
// (the reference never strips restart markers).  Semantics are pinned to
// tpujpeg/io/destuff.py::destuff_scan — tests/test_native.py enforces
// byte-for-byte equality of (scan_data, segment_offsets) on conformant
// and corrupt streams alike:
//   0xFF 0x00        -> emit 0xFF, drop the stuffed 0x00
//   0xFF 0xD0..0xD7  -> drop both, record a segment start at the current
//                       de-stuffed length
//   0xFF 0xFF        -> emit the first 0xFF (fill byte), re-examine the
//                       second
//   0xFF other       -> terminator: entropy data ends before this 0xFF
//
// Error codes (match lib.py _ERRORS):
//   -5 empty scan, -6 no terminating marker, -7 segment table overflow.

#include <cstdint>

extern "C" {

int32_t tpj_destuff(const uint8_t* buf, int64_t n,
                    uint8_t* out, int64_t* out_len,
                    int64_t* seg_offsets, int64_t seg_cap, int64_t* n_segs) {
  if (n <= 0) return -5;
  int64_t o = 0;
  int64_t ns = 0;
  if (seg_cap < 1) return -7;
  seg_offsets[ns++] = 0;
  int64_t i = 0;
  bool terminated = false;
  while (i < n) {
    const uint8_t b = buf[i];
    if (b != 0xFF) {
      out[o++] = b;
      ++i;
      continue;
    }
    if (i + 1 >= n) {
      // lone trailing 0xFF: no terminator can follow
      break;
    }
    const uint8_t nxt = buf[i + 1];
    if (nxt == 0x00) {
      out[o++] = 0xFF;
      i += 2;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {
      if (ns == seg_cap) return -7;
      seg_offsets[ns++] = o;
      i += 2;
    } else if (nxt == 0xFF) {
      out[o++] = 0xFF;  // fill byte before a marker
      i += 1;
    } else {
      terminated = true;
      break;
    }
  }
  if (!terminated) return -6;
  *out_len = o;
  *n_segs = ns;
  return 0;
}

}  // extern "C"
