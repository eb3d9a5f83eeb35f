// Native host entropy decoder for baseline JPEG scans.
//
// This is the port's equivalent of the reference's host-side C++
// decode path (the cudaH strategy: Huffman on the host CPU feeding device
// kernels, reference legacy_versions/cudaH-implementation/src/parser.cu:281-311,
// and the serial oracle cpp-decoder/src/parser.cpp:105-142).  Unlike the
// reference's bit-by-bit tree walk (huffmanTree.cpp:110-123) or 256-way
// linear code scan (cuda-decoder/src/parser.cu:5-19), symbols decode
// through a two-level direct-indexed table:
//   level 1: 10-bit peek -> packed (len<<8 | sym), 2 KB per table,
//            L1-cache resident, covers virtually all real codes;
//   level 2: full 16-bit peek table for codes longer than 10 bits.
// The bit reader keeps a 64-bit buffer refilled once per symbol (a code is
// <= 16 bits and its magnitude <= 15, so 32 buffered bits always suffice).
//
// Restart segments decode independently (byte-aligned starts, DC reset —
// ITU T.81 E.1.2), so segmented scans are parallelized with OpenMP: the
// same segment table the device decoder uses for lane parallelism gives the
// host decoder core parallelism.
//
// Scans WITHOUT restart markers parallelize through speculative
// self-synchronization (the host mirror of the device fsm-spec path and
// of the reference's final strategy, cuda-decoder/src/parser.cu): worker
// threads decode equal byte chunks from guessed states (byte-aligned,
// MCU phase 0, DC as raw diffs); a serial verification walk then decodes
// from the true stream state and, at every block boundary, adopts a
// chunk's recorded suffix when the speculative state (bit position AND
// block phase within the MCU) matches exactly.  Huffman streams
// self-synchronize, so the walk typically re-decodes only a short prefix
// of each chunk; exact state matching makes the result bit-identical to
// the serial decode regardless of sync luck, and every anomaly (invalid
// code, truncation, DC range) simply falls through to serial re-decode
// at the same position, preserving error semantics.
//
// Semantics are bit-identical to tpujpeg.oracle.decoder.entropy_decode:
//   - JPEG EXTEND per reference utils.cu:34-41 (size==0 -> 0),
//   - AC RLE with EOB / ZRL and the reference's "consume size bits even when
//     the run overflows the block" behavior (cpp parser.cpp:130-135),
//   - DC DPCM accumulated per component, reset at restart boundaries.
//
// Exported C ABI (loaded via ctypes; no pybind11 in this image):
//   tpj_entropy_decode        - decode one scan into int32 coefficients
//   tpj_version               - ABI version tag
#ifdef _OPENMP
#include <omp.h>
#else
// built without OpenMP (runtime/native/build.py's second attempt): the
// pragmas are ignored and every call runs on its caller's thread
static inline int omp_get_max_threads() { return 1; }
static inline int omp_get_thread_num() { return 0; }
#endif

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kLutBits = 16;
constexpr int64_t kLutSize = int64_t(1) << kLutBits;
constexpr int kFastBits = 10;
constexpr int kFastSize = 1 << kFastBits;

// Error codes (keep in sync with runtime/native/lib.py).
enum : int32_t {
  kOk = 0,
  kErrInvalidCode = -1,
  kErrMissingSegment = -2,
  kErrTruncated = -3,
  kErrDcOverflow = -4,  // int16 output cannot hold the DC predictor
};

struct BitReader {
  const uint8_t* data;  // caller guarantees >= 512 bytes of zero padding
  int64_t byte_pos;     // next byte to refill from
  uint64_t buf;         // MSB-first bit buffer
  int bits;             // valid bits in buf

  inline void reset(const uint8_t* d, int64_t start_byte) {
    data = d;
    byte_pos = start_byte;
    buf = 0;
    bits = 0;
  }

  inline void refill() {
    // Branchless fill to >= 56 bits: one unaligned 64-bit load (the caller
    // guarantees padding), big-endian normalize, splice below current bits.
    uint64_t w;
    std::memcpy(&w, data + byte_pos, 8);
    w = __builtin_bswap64(w);
    buf |= w >> bits;
    int add = (63 - bits) & ~7;
    byte_pos += add >> 3;
    bits += add;
  }

  inline uint32_t peek(int n) const { return uint32_t(buf >> (64 - n)); }

  inline void consume(int n) {
    buf <<= n;
    bits -= n;
  }

  // n in [0, 16]; requires bits >= 16 + n.
  inline uint32_t get_bits(int n) {
    if (n == 0) return 0;
    uint32_t v = uint32_t(buf >> (64 - n));
    consume(n);
    return v;
  }

  inline int64_t bit_position() const { return byte_pos * 8 - bits; }

  // Position the reader at an arbitrary (not byte-aligned) bit offset.
  inline void seek(const uint8_t* d, int64_t bitpos) {
    reset(d, bitpos >> 3);
    refill();
    consume(int(bitpos & 7));
  }
};

// JPEG EXTEND (reference decodeNumber, utils.cu:34-41).
static inline int32_t extend(int size, uint32_t raw) {
  if (size == 0) return 0;
  int32_t half = int32_t(1) << (size - 1);
  int32_t v = int32_t(raw);
  return v >= half ? v : v - (2 * half - 1);
}

struct CompTables {
  const uint16_t* dc16;   // full 16-bit-peek table, packed (len<<8)|sym
  const uint16_t* ac16;
  const uint16_t* dc_fast;  // 10-bit first level (0 = escape to 16-bit)
  const uint16_t* ac_fast;
};

// Decode one symbol; returns packed (len<<8)|sym, or 0 on invalid code.
static inline uint32_t decode_sym(BitReader& br, const uint16_t* fast,
                                  const uint16_t* full) {
  uint32_t e = fast[br.peek(kFastBits)];
  if (e == 0) e = full[br.peek(kLutBits)];
  br.consume(e >> 8);
  return e;
}

// Decode one block's symbols.  The DC value is returned as the raw DPCM
// DIFF via `dc_diff` (the caller accumulates — speculative decodes don't
// know their predecessor's predictor).  Returns kOk / kErrInvalidCode.
// The caller must zero `block` beforehand and apply the per-block
// truncation rule afterwards.
template <typename OutT>
static inline int32_t decode_block(BitReader& br, const CompTables& t,
                                   int32_t* dc_diff, OutT* block) {
  // DC: size symbol, then EXTEND (cpp parser.cpp:105-110).
  br.refill();
  uint32_t e = decode_sym(br, t.dc_fast, t.dc16);
  if (e == 0) return kErrInvalidCode;
  int size = e & 0xFF;
  *dc_diff = extend(size, br.get_bits(size));
  // AC: run/size symbols (cpp parser.cpp:113-135).  A symbol consumes
  // at most 16 (code) + 15 (magnitude) = 31 bits, so refill only when
  // the buffer dips below that: the predictable branch is cheaper than
  // the unconditional load+bswap+splice chain every symbol.
  int k = 1;
  while (k < 64) {
    if (br.bits < 31) br.refill();
    e = decode_sym(br, t.ac_fast, t.ac16);
    if (e == 0) return kErrInvalidCode;
    int sym = e & 0xFF;
    if (sym == 0) break;  // EOB
    k += sym >> 4;
    size = sym & 0x0F;
    uint32_t raw = br.get_bits(size);
    if (k < 64) {
      block[k] = OutT(extend(size, raw));
      ++k;
    }
    // else: bits consumed, value dropped (reference parser.cpp:130-135)
  }
  return kOk;
}

// Accumulate a DC diff into the per-component predictor and store it.
// int16 outputs surface predictor overflow instead of wrapping: conformant
// streams keep |DC| <= 2047, but a corrupt-but-decodable stream can walk
// the predictor out of range, where a silent wrap would diverge from the
// int32 oracle (round-1 advisor finding); callers retry on a wider path.
template <typename OutT>
static inline int32_t store_dc(int32_t* dc_pred, int comp, int32_t diff,
                               OutT* block) {
  dc_pred[comp] += diff;
  if (sizeof(OutT) == 2 &&
      (dc_pred[comp] > 32767 || dc_pred[comp] < -32768))
    return kErrDcOverflow;
  block[0] = OutT(dc_pred[comp]);
  return kOk;
}

// Decode MCUs [mcu_begin, mcu_end) starting at scan byte `start_byte`
// with fresh DC predictors.  `out` points at the first block of mcu_begin.
// OutT is int32 or int16: every coefficient of a conformant baseline scan
// fits int16 (|DC| <= 2047 cumulative, |AC| <= 1023), and the int16 form
// halves the host->device transfer that dominates batched decode.
template <typename OutT>
static int32_t decode_range(const uint8_t* scan, int64_t scan_len,
                            int64_t start_byte, int64_t mcu_begin,
                            int64_t mcu_end, const int32_t* pattern,
                            int64_t bpm, const CompTables* ct, OutT* out) {
  const int64_t total_bits = scan_len * 8;
  BitReader br;
  br.reset(scan, start_byte);
  int32_t dc_pred[4] = {0, 0, 0, 0};
  OutT* block = out;

  for (int64_t mcu = mcu_begin; mcu < mcu_end; ++mcu) {
    for (int64_t b = 0; b < bpm; ++b, block += 64) {
      int32_t diff;
      int32_t rc = decode_block(br, ct[pattern[b]], &diff, block);
      if (rc != kOk) return rc;
      rc = store_dc(dc_pred, pattern[b], diff, block);
      if (rc != kOk) return rc;
      if (br.bit_position() > total_bits + 16) return kErrTruncated;
    }
  }
  return kOk;
}

// -- speculative self-sync decode of restart-free scans ----------------------
//
// The host mirror of the device fsm-spec path (ops/fsm.py
// decode_speculative_batch) and of the reference's self-synchronizing
// final strategy: chunks decode in parallel from guessed states, a serial
// walk verifies and stitches.  Exact state matching (bit position AND
// block phase within the MCU) makes the stitched stream bit-identical to
// a serial decode; speculation only affects speed.

template <typename OutT>
struct SpecChunk {
  std::vector<int64_t> pos;  // pos[j] = bit position before block j;
                             // pos[n] = exit state after the last block
  std::vector<OutT> coeffs;  // [n, 64] zigzag blocks, DC as raw DPCM diff
  int64_t n = 0;             // recorded block count
};

// Speculatively decode from byte-aligned `start_bit` (assumed MCU phase 0,
// unknown DC predictor -> DC stored as diff) until the next block would
// begin at/after `end_bit`, `max_blocks` are recorded, or the stream
// misbehaves.  A bad block (invalid code, past-the-end position, diff too
// wide for OutT) is dropped and ends the record: the verification walk
// re-decodes from the exit state, so spurious pre-sync garbage never
// surfaces and genuine errors re-manifest with serial semantics.
template <typename OutT>
static void decode_spec_chunk(const uint8_t* scan, int64_t total_bits,
                              int64_t start_bit, int64_t end_bit,
                              const int32_t* pattern, int64_t bpm,
                              const CompTables* ct, int64_t max_blocks,
                              SpecChunk<OutT>& sc) {
  BitReader br;
  br.reset(scan, start_bit >> 3);
  const int64_t est = (end_bit - start_bit) / 64 + 16;
  sc.pos.reserve(size_t(std::min(est, max_blocks) + 1));
  sc.coeffs.reserve(size_t(std::min(est, max_blocks)) * 64);
  while (sc.n < max_blocks) {
    const int64_t p = br.bit_position();
    if (p >= end_bit) break;
    sc.coeffs.resize(size_t(sc.n + 1) * 64, OutT(0));
    OutT* block = sc.coeffs.data() + sc.n * 64;
    int32_t diff;
    if (decode_block(br, ct[pattern[sc.n % bpm]], &diff, block) != kOk ||
        br.bit_position() > total_bits + 16 ||
        (sizeof(OutT) == 2 && (diff > 32767 || diff < -32768))) {
      sc.coeffs.resize(size_t(sc.n) * 64);
      sc.pos.push_back(p);  // exit = entry of the unverifiable block
      return;
    }
    block[0] = OutT(diff);
    sc.pos.push_back(p);
    ++sc.n;
  }
  sc.pos.push_back(br.bit_position());
}

// Reusable per-caller-thread chunk records: the spec buffers are the size
// of the coefficient output (tens of MB at 2000^2), and a fresh
// malloc/free per decode hands them back to the OS and repays the soft
// page-fault cost every call (same rationale as the pixels.cpp arena).
// clear() keeps capacity, so buffers are warm from the second image on.
template <typename OutT>
static std::vector<SpecChunk<OutT>>& spec_chunk_pool() {
  static thread_local std::vector<SpecChunk<OutT>> pool;
  return pool;
}

// Parallel decode of a scan with no restart segments, in three passes:
//   1. speculative chunk decode (parallel),
//   2. serial verification walk: adopt recorded suffixes on exact state
//      match (recording copy spans + predictor snapshots, advancing the
//      DC predictors by the spans' per-component diff sums — a strided
//      read of block[0] only), else re-decode one block in place,
//   3. span apply (parallel): bulk-copy each adopted span and resolve its
//      DC prefix from the snapshot.
// Bit-identical to decode_range(scan, scan_len, 0, 0, n_mcus, ...); on
// multiple errors the code of the earliest block in stream order is
// returned, matching the serial decode's first-error semantics.
// The caller must NOT pre-zero `out`: adopted spans are fully overwritten
// and walk-decoded blocks zero themselves (skipping the whole-buffer
// memset saves a full pass of write traffic).
template <typename OutT>
static int32_t decode_noseg_spec(const uint8_t* scan, int64_t scan_len,
                                 int64_t n_blocks, const int32_t* pattern,
                                 int64_t bpm, const CompTables* ct,
                                 int64_t chunk_bytes, int64_t n_chunks,
                                 int nt, OutT* out) {
  const int64_t total_bits = scan_len * 8;
  auto& chunks = spec_chunk_pool<OutT>();
  if (int64_t(chunks.size()) < n_chunks) chunks.resize(size_t(n_chunks));
  for (int64_t c = 0; c < n_chunks; ++c) {
    chunks[size_t(c)].pos.clear();
    chunks[size_t(c)].coeffs.clear();
    chunks[size_t(c)].n = 0;
  }
  // 4x the pro-rata block share bounds a degenerate chunk's memory; a
  // chunk that is genuinely denser than that just gets re-decoded
  // serially past its record (correctness never depends on the cap).
  const int64_t cap = 4 * n_blocks * chunk_bytes / scan_len + 1024;
#pragma omp parallel for schedule(dynamic, 1) num_threads(nt)
  for (int64_t c = 0; c < n_chunks; ++c) {
    const int64_t end_bit = c + 1 < n_chunks ? (c + 1) * chunk_bytes * 8
                                             : total_bits + 17;
    decode_spec_chunk(scan, total_bits, c * chunk_bytes * 8, end_bit,
                      pattern, bpm, ct, cap, chunks[size_t(c)]);
  }

  // Pass 2: serial verification walk over the true stream state (S, G).
  // Chunk 0's guess IS the true state, so it adopts immediately; later
  // chunks adopt from their first self-synchronized block.
  struct Span {
    const OutT* src;
    int64_t g0, n;
    int32_t dc0[4];  // DC predictor snapshot at span start
    int64_t err_g;   // first int16-overflow block in pass 3, or -1
  };
  std::vector<Span> spans;
  spans.reserve(size_t(n_chunks) + 4);
  BitReader br;
  bool br_synced = false;
  int32_t dc_pred[4] = {0, 0, 0, 0};
  int64_t S = 0;  // bit position
  int64_t G = 0;  // global block index
  int32_t walk_rc = kOk;
  int64_t walk_err_g = INT64_MAX;
  for (int64_t c = 0; c < n_chunks && G < n_blocks && walk_rc == kOk; ++c) {
    const SpecChunk<OutT>& sc = chunks[size_t(c)];
    const int64_t walk_end =
        c + 1 < n_chunks ? (c + 1) * chunk_bytes * 8 : INT64_MAX;
    while (G < n_blocks && S < walk_end) {
      if (sc.n) {
        auto it = std::lower_bound(sc.pos.begin(), sc.pos.begin() + sc.n, S);
        const int64_t j = it - sc.pos.begin();
        if (j < sc.n && *it == S && j % bpm == G % bpm) {
          Span sp;
          sp.src = sc.coeffs.data() + j * 64;
          sp.g0 = G;
          sp.n = std::min(sc.n - j, n_blocks - G);
          std::memcpy(sp.dc0, dc_pred, sizeof(dc_pred));
          sp.err_g = -1;
          spans.push_back(sp);
          for (int64_t k = 0; k < sp.n; ++k)
            dc_pred[pattern[(G + k) % bpm]] += int32_t(sp.src[k * 64]);
          G += sp.n;
          S = sc.pos[size_t(j + sp.n)];
          br_synced = false;
          continue;
        }
      }
      if (!br_synced) {
        br.seek(scan, S);
        br_synced = true;
      }
      OutT* block = out + G * 64;
      std::memset(block, 0, 64 * sizeof(OutT));
      int32_t diff;
      int32_t rc = decode_block(br, ct[pattern[G % bpm]], &diff, block);
      if (rc == kOk) rc = store_dc(dc_pred, pattern[G % bpm], diff, block);
      if (rc == kOk && br.bit_position() > total_bits + 16)
        rc = kErrTruncated;
      if (rc != kOk) {
        walk_rc = rc;
        walk_err_g = G;
        break;
      }
      S = br.bit_position();
      ++G;
    }
  }

  // Pass 3: apply the adopted spans (bulk copy + DC prefix resolution)
  // in parallel.  Runs even when the walk latched an error: an earlier
  // span error in stream order must win, like the serial decode would.
#pragma omp parallel for schedule(dynamic, 1) num_threads(nt)
  for (int64_t si = 0; si < int64_t(spans.size()); ++si) {
    Span& sp = spans[size_t(si)];
    std::memcpy(out + sp.g0 * 64, sp.src, size_t(sp.n) * 64 * sizeof(OutT));
    int32_t pred[4];
    std::memcpy(pred, sp.dc0, sizeof(pred));
    for (int64_t k = 0; k < sp.n; ++k) {
      OutT* block = out + (sp.g0 + k) * 64;
      const int32_t diff = int32_t(block[0]);
      if (store_dc(pred, pattern[(sp.g0 + k) % bpm], diff, block) != kOk) {
        sp.err_g = sp.g0 + k;
        break;
      }
    }
  }
  int32_t rc = walk_rc;
  int64_t err_g = walk_err_g;
  for (const Span& sp : spans)
    if (sp.err_g >= 0 && sp.err_g < err_g) {
      err_g = sp.err_g;
      rc = kErrDcOverflow;
    }
  if (std::getenv("TPJ_SPEC_DEBUG")) {
    int64_t n_adopted = 0;
    for (const Span& sp : spans) n_adopted += sp.n;
    std::fprintf(
        stderr, "tpj spec: chunks=%lld adopted=%lld serial=%lld spans=%lld\n",
        (long long)n_chunks, (long long)n_adopted,
        (long long)(G - n_adopted), (long long)spans.size());
  }
  return rc;
}

// Derive the 10-bit first-level table: entry j covers peek windows with top
// bits j; valid iff the code there is <= kFastBits long (all such windows
// share it).  0 marks escape-to-full-table (also covers invalid windows).
static void build_fast(const uint16_t* full, uint16_t* fast) {
  for (int j = 0; j < kFastSize; ++j) {
    uint16_t e = full[uint32_t(j) << (kLutBits - kFastBits)];
    fast[j] = (e != 0 && (e >> 8) <= kFastBits) ? e : 0;
  }
}


// Decode one de-stuffed entropy scan into zigzag-order coefficient blocks.
//
//   scan         de-stuffed entropy bytes, padded with >= 512 zero bytes
//   scan_len     number of real bytes (excluding padding)
//   seg_offsets  [n_segments] byte offset of each restart segment start
//   ri           restart interval in MCUs (0 = none)
//   n_mcus       total MCU count
//   pattern      [bpm] component index of each block within an MCU
//   bpm          blocks per MCU
//   dc_rows      [n_comp] row of each component's DC table in luts
//   ac_rows      [n_comp] row of each component's AC table
//   n_comp       component count (<= 4)
//   luts         [n_luts * 65536] uint16 packed (len << 8) | sym (0 invalid)
//   out          [n_mcus * bpm * 64] int32, written in scan order
template <typename OutT>
static int32_t entropy_decode_impl(
    const uint8_t* scan, int64_t scan_len,
    const int64_t* seg_offsets, int64_t n_segments,
    int64_t ri, int64_t n_mcus,
    const int32_t* pattern, int64_t bpm,
    const int32_t* dc_rows, const int32_t* ac_rows, int64_t n_comp,
    const uint16_t* luts, int32_t n_threads,
    OutT* out) {
  // n_threads > 0 caps the OpenMP teams (see pixels_impl note): batch
  // callers pass 1 and parallelize across images instead.
  const int nt = n_threads > 0 ? int(n_threads) : omp_get_max_threads();
  // Fast first-level tables for every distinct LUT row in use.
  uint16_t fast[8][kFastSize];
  int fast_of[16];
  for (int i = 0; i < 16; ++i) fast_of[i] = -1;
  int n_fast = 0;
  CompTables ct[4];
  for (int64_t c = 0; c < n_comp; ++c) {
    for (int which = 0; which < 2; ++which) {
      int row = which == 0 ? dc_rows[c] : ac_rows[c];
      if (row < 0 || row >= 8) return kErrInvalidCode;
      if (fast_of[row] < 0) {
        fast_of[row] = n_fast;
        build_fast(luts + int64_t(row) * kLutSize, fast[n_fast]);
        ++n_fast;
      }
      const uint16_t* full = luts + int64_t(row) * kLutSize;
      const uint16_t* fl = fast[fast_of[row]];
      if (which == 0) {
        ct[c].dc16 = full;
        ct[c].dc_fast = fl;
      } else {
        ct[c].ac16 = full;
        ct[c].ac_fast = fl;
      }
    }
  }

  if (ri == 0 || n_segments <= 1) {
    // No restart segments: speculative self-sync parallelism when the
    // scan is big enough to amortize it.  Measured on the 4-core box:
    // spec wins from ~20 KB scans up (0.27 vs 0.42 ms at 21 KB), so the
    // gate is mostly an OMP-fork floor.  TPJ_SPEC_MIN_BYTES overrides
    // (tests force every fixture through the speculative path).
    int64_t spec_min = int64_t(1) << 14;
    if (const char* env = std::getenv("TPJ_SPEC_MIN_BYTES")) {
      char* endp = nullptr;
      long long v = std::strtoll(env, &endp, 10);
      if (endp != env && v >= 0) spec_min = v;
    }
    if (nt > 1 && scan_len >= spec_min && spec_min > 0) {
      const int64_t floor_bytes = std::max<int64_t>(spec_min / 4, 1);
      const int64_t chunk_bytes = std::max<int64_t>(
          floor_bytes, (scan_len + 4 * nt - 1) / (4 * nt));
      const int64_t n_chunks = (scan_len + chunk_bytes - 1) / chunk_bytes;
      if (n_chunks >= 2)
        return decode_noseg_spec(scan, scan_len, n_mcus * bpm, pattern, bpm,
                                 ct, chunk_bytes, n_chunks, nt, out);
    }
    std::memset(out, 0, size_t(n_mcus) * bpm * 64 * sizeof(OutT));
    return decode_range(scan, scan_len, 0, 0, n_mcus, pattern, bpm, ct, out);
  }

  // One independent decode per restart segment; parallel across cores.
  std::memset(out, 0, size_t(n_mcus) * bpm * 64 * sizeof(OutT));
  int32_t status = kOk;
  const int64_t need = (n_mcus + ri - 1) / ri;
  if (need > n_segments) return kErrMissingSegment;
#pragma omp parallel for schedule(dynamic, 8) num_threads(nt)
  for (int64_t s = 0; s < need; ++s) {
    int64_t mcu_begin = s * ri;
    int64_t mcu_end = mcu_begin + ri < n_mcus ? mcu_begin + ri : n_mcus;
    int32_t rc = decode_range(scan, scan_len, seg_offsets[s], mcu_begin,
                              mcu_end, pattern, bpm, ct,
                              out + mcu_begin * bpm * 64);
    if (rc != kOk) {
#pragma omp atomic write
      status = rc;
    }
  }
  return status;
}
}  // namespace

extern "C" {

int32_t tpj_version() { return 7; }  // 7: n_threads arg on decode/pixels

int32_t tpj_entropy_decode(
    const uint8_t* scan, int64_t scan_len,
    const int64_t* seg_offsets, int64_t n_segments,
    int64_t ri, int64_t n_mcus,
    const int32_t* pattern, int64_t bpm,
    const int32_t* dc_rows, const int32_t* ac_rows, int64_t n_comp,
    const uint16_t* luts, int32_t n_threads,
    int32_t* out) {
  return entropy_decode_impl(scan, scan_len, seg_offsets, n_segments, ri,
                             n_mcus, pattern, bpm, dc_rows, ac_rows, n_comp,
                             luts, n_threads, out);
}

// int16 variant: conformant baseline coefficients always fit (|DC| <= 2047,
// |AC| <= 1023), and halving the coefficient bytes halves the host->device
// transfer that bounds batched decode throughput.
int32_t tpj_entropy_decode16(
    const uint8_t* scan, int64_t scan_len,
    const int64_t* seg_offsets, int64_t n_segments,
    int64_t ri, int64_t n_mcus,
    const int32_t* pattern, int64_t bpm,
    const int32_t* dc_rows, const int32_t* ac_rows, int64_t n_comp,
    const uint16_t* luts, int32_t n_threads,
    int16_t* out) {
  return entropy_decode_impl(scan, scan_len, seg_offsets, n_segments, ri,
                             n_mcus, pattern, bpm, dc_rows, ac_rows, n_comp,
                             luts, n_threads, out);
}

}  // extern "C"
