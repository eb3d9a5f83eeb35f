// Lockstep-lane Huffman decode of restart segments (the gather backend's
// entropy stage).
//
// Replaces: tpujpeg/ops/entropy.py::decode_segments, two nested XLA
// lax.scan loops over symbol steps (entropy.py:315, :337) and a final
// scatter (:342-346) on the TPU.  Contract: tpujpeg_torch/ops/entropy.py::
// decode_segments_plain.
//
// One thread per lane (one restart segment) walks its segment one Huffman
// symbol per step: a 16-bit peek of the scan bytes read in place, one read
// of the lane's direct-indexed table (luts: int32 [n_rows, 65536],
// (length << 8) | symbol, 256 KB a table, so it lives in L2 and not in
// shared memory), EXTEND, and the DC DPCM per component.  Each
// coefficient goes straight into the zero-filled output; the TPU's
// step-major emit buffers and the scatter after them are not carried over.
//
// What bounds it: latency.  Every step needs the previous step's bit
// position, and each step's table read is a dependent L2 access, so a
// lane costs (its symbols) x (one L2 round trip plus the step's
// arithmetic).  The step loads the eight scan bytes from its peek's byte
// onwards at once, which cover the magnitude bits' peek as well (that
// starts at most 2 bytes further on), so one table read and one byte
// fetch (L1) sit on the chain per symbol.  A lane leaves its loop when it
// is done; the warp runs as long as its longest lane.
//
// Error edges, bit for bit with the JAX function: the peek's byte index
// is clamped at n_bytes - 4; a code of length 0 latches err; a lane still
// undone after n_steps latches err; an AC run past z = 63 ends the block
// without an error and without a write; a lane with 0 blocks is born
// done.  A write outside [0, n_coeffs) is dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // one warp a block: the lanes spread over SMs
constexpr int kLutSize = 1 << 16;

// Bytes [i, i + 8) of the scan as a big-endian 64-bit word; bytes past the
// end read as 0 (the peeks never use them).
__device__ __forceinline__ uint64_t load8(const uint8_t* __restrict__ scan,
                                          long long i, long long n_bytes) {
  uint64_t w = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const long long j = i + b;
    const uint64_t v = j < n_bytes ? __ldg(scan + j) : 0u;
    w |= v << (56 - 8 * b);
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
decode_segments_kernel(const uint8_t* __restrict__ scan, long long n_bytes,
                       const int32_t* __restrict__ start_bits,
                       const int32_t* __restrict__ block_base,
                       const int32_t* __restrict__ n_blocks,
                       const int32_t* __restrict__ rows, int n_comp,
                       const int32_t* __restrict__ luts, int n_rows,
                       const int32_t* __restrict__ pattern, int bpm,
                       int n_steps, int32_t* __restrict__ coeffs,
                       long long n_coeffs, uint8_t* __restrict__ err_out,
                       int L) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= L) return;

  // MCU pattern as 2-bit component indices, in a register
  uint32_t pmask = 0;
  for (int i = 0; i < bpm; ++i) {
    const int c = min(max(pattern[i], 0), n_comp - 1);
    pmask |= static_cast<uint32_t>(c) << (2 * i);
  }
  // this lane's table rows per component (DC, AC), in registers
  int rdc[4] = {0, 0, 0, 0}, rac[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < n_comp) {
      const int32_t* r = rows + (static_cast<size_t>(lane) * n_comp + c) * 2;
      rdc[c] = min(max(r[0], 0), n_rows - 1);
      rac[c] = min(max(r[1], 0), n_rows - 1);
    }
  }

  const long long n_words = n_bytes - 3;   // last peek byte index + 1
  const int quota = n_blocks[lane];
  const long long base = block_base[lane];
  int p = start_bits[lane];
  int blk = 0, k = 0, bim = 0;
  // DC predictors; unsigned so that a wrap is defined, as int32 in JAX
  uint32_t dc0 = 0, dc1 = 0, dc2 = 0, dc3 = 0;
  bool done = quota == 0;
  bool err = false;

  for (int s = 0; s < n_steps && !done; ++s) {
    const int comp = (pmask >> (2 * bim)) & 3;
    const bool is_dc = k == 0;
    const int row = is_dc ? (comp == 0 ? rdc[0] : comp == 1 ? rdc[1]
                             : comp == 2 ? rdc[2] : rdc[3])
                          : (comp == 0 ? rac[0] : comp == 1 ? rac[1]
                             : comp == 2 ? rac[2] : rac[3]);
    const long long i =
        max(min(static_cast<long long>(p >> 3), n_words - 1), 0LL);
    const uint64_t win = load8(scan, i, n_bytes);
    const uint32_t w = static_cast<uint32_t>(win >> 32);
    const int peek = static_cast<int>(((w << (p & 7)) >> 16) & 0xFFFFu);
    const int code =
        __ldg(luts + static_cast<size_t>(row) * kLutSize + peek);
    const int clen = code >> 8;
    const int sym = code & 0xFF;
    if (clen == 0) {   // no code matches the window: the lane fails
      err = true;
      done = true;
      break;
    }
    const int p2 = p + clen;
    const int size = is_dc ? sym : (sym & 0x0F);
    const int run = is_dc ? 0 : (sym >> 4);
    // the magnitude bits' peek starts at most 2 bytes past i
    const long long i2 =
        max(min(static_cast<long long>(p2 >> 3), n_words - 1), 0LL);
    const int d = static_cast<int>(min(max(i2 - i, 0LL), 4LL));
    const uint32_t w2 = static_cast<uint32_t>(win >> (32 - 8 * d));
    const int sz1 = max(size, 1);
    const int raw =
        static_cast<int>(((w2 << (p2 & 7)) >> 16) & 0xFFFFu) >> (16 - sz1);
    const int half = 1 << (sz1 - 1);
    const int val = size == 0 ? 0 : (raw >= half ? raw : raw - 2 * half + 1);
    p = p2 + size;
    const bool is_eob = !is_dc && sym == 0;
    const int z = is_dc ? 0 : k + run;
    int emit = val;
    if (is_dc) {
      const uint32_t v = static_cast<uint32_t>(val);
      if (comp == 0) {
        emit = static_cast<int>(dc0 += v);
      } else if (comp == 1) {
        emit = static_cast<int>(dc1 += v);
      } else if (comp == 2) {
        emit = static_cast<int>(dc2 += v);
      } else {
        emit = static_cast<int>(dc3 += v);
      }
    }
    if (!is_eob && z < 64) {
      const long long idx = (base + blk) * 64 + z;
      if (idx >= 0 && idx < n_coeffs) coeffs[idx] = emit;
    }
    const int k_after = is_dc ? 1 : ((is_eob || z >= 64) ? 64 : z + 1);
    if (k_after >= 64) {
      ++blk;
      k = 0;
      bim = bim + 1 == bpm ? 0 : bim + 1;
    } else {
      k = k_after;
    }
    done = blk >= quota;
  }
  err_out[lane] = (err || !done) ? 1 : 0;
}

}  // namespace

// scan: uint8 [n_bytes] (n_bytes >= 4); start_bits, block_base, n_blocks:
// int32 [L]; rows: int32 [L, n_comp, 2] (n_comp <= 4); luts: int32
// [n_rows, 65536]; pattern: int32 [bpm] (bpm <= 16); coeffs: int32
// [n_coeffs], zero-filled by the caller; err: bool [L].  All on the card.
extern "C" int tpj_decode_segments(const uint8_t* scan, long long n_bytes,
                                   const int32_t* start_bits,
                                   const int32_t* block_base,
                                   const int32_t* n_blocks,
                                   const int32_t* rows, int n_comp,
                                   const int32_t* luts, int n_rows,
                                   const int32_t* pattern, int bpm,
                                   int n_steps, int32_t* coeffs,
                                   long long n_coeffs, uint8_t* err, int L,
                                   cudaStream_t stream) {
  if (L < 1 || n_bytes < 4 || n_comp < 1 || n_comp > 4 || n_rows < 1 ||
      bpm < 1 || bpm > 16 || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (L + kThreads - 1) / kThreads;
  decode_segments_kernel<<<blocks, kThreads, 0, stream>>>(
      scan, n_bytes, start_bits, block_base, n_blocks, rows, n_comp, luts,
      n_rows, pattern, bpm, n_steps, coeffs, n_coeffs, err, L);
  return static_cast<int>(cudaGetLastError());
}
