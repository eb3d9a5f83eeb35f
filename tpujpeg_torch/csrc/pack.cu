// Lane matrix from a chunk's scan bytes (kernel "pack_lanes" of
// tpujpeg_torch).
//
// Replaces no TPU kernel.  The JAX package packs the lane matrix xs on the
// host (tpujpeg/ops/fsm.py build_plan and build_spec_plan_batch: a fresh
// zeroed matrix, one row copy per lane), and so did the port until the
// host's row-by-row packing, on the path of every restart and speculative
// chunk, kept the card waiting.  Now the chunk's scan bytes go up once
// with a small table per lane (ops/fsm.py ScanLanes), and this kernel lays
// out the rows on the card.  Contract:
// tpujpeg_torch/ops/fsm.py::pack_lanes_plain.
//
// Row i of xs uint8 [L, stride] is the lane_len[i] bytes of src from
// lane_off[i], then zeros; a padding lane (length 0) is all zeros.
//
// Bound: bytes.  The source read once plus xs written once over 3.35 TB/s:
// a 128-image restart chunk of 640 x 640 q90 pictures reads ~30 MB and
// writes 36.7 MB ([10240, 3584]), ~20 us.
//
// Design: one thread a 16-byte word of a row, neighbouring threads on
// neighbouring words, so every store is an aligned 16-byte store and a
// warp writes 512 contiguous bytes.  A lane's bytes start anywhere in the
// source, so the reads are unaligned: each thread reads its up to 16 bytes
// one by one through L1 and L2, where a warp's 32 threads read 512
// consecutive bytes and share their sectors.  Bytes past a lane's length
// are written as zeros without a read.  Simple first: anything under a
// quarter of a millisecond is invisible beside a decode call of ~100 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_lanes_kernel(const uint8_t* __restrict__ src,
                  const int64_t* __restrict__ lane_off,
                  const int32_t* __restrict__ lane_len,
                  uint4* __restrict__ xs, int64_t n_words,
                  int words_per_row) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= n_words) return;
  const int64_t row = w / words_per_row;
  const int col = static_cast<int>(w - row * words_per_row) * 16;
  const int n = min(16, lane_len[row] - col);   // bytes of this word
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (n > 0) {
    const uint8_t* p = src + lane_off[row] + col;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < n) v[k >> 2] |= static_cast<uint32_t>(__ldg(p + k)) << (8 * (k & 3));
    }
  }
  xs[w] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// xs must be 16-byte aligned and stride a multiple of 16 (the wrapper
// checks both); every lane_off[i] + lane_len[i] lies inside src.
extern "C" int tpj_pack_lanes(const uint8_t* src, const int64_t* lane_off,
                              const int32_t* lane_len, uint8_t* xs, int L,
                              int stride, cudaStream_t stream) {
  if (L <= 0 || stride <= 0 || stride % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words_per_row = stride / 16;
  const int64_t n_words = static_cast<int64_t>(L) * words_per_row;
  const int64_t blocks = (n_words + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  pack_lanes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      src, lane_off, lane_len, reinterpret_cast<uint4*>(xs), n_words,
      words_per_row);
  return static_cast<int>(cudaGetLastError());
}
