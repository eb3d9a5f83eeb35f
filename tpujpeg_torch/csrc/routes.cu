// The two other routes of the classic materialize (kernels
// "compact_offsets", "compact_full" and "spread_full" of tpujpeg_torch).
//
// Replace, in tpujpeg/ops/materialize.py:
//   * compact_offsets — _fine_compact_kernel (materialize.py:271) with the
//                       XLA coarse compact stages of _compact_to_rank
//                       (materialize.py:575-613): the compaction whose
//                       offsets pos - rank were computed outside, by a
//                       column cumsum.  With a mask it is one group of the
//                       network's stages alone (each event moves up by
//                       o & mask and keeps the rest of its offset): the
//                       fine stage and the coarse stages that
//                       tools/bench_materialize2.py times apart;
//   * compact_full    — _compact_kernel (materialize.py:102): full-height
//                       stable compaction with the ranks computed inside,
//                       payload only;
//   * spread_full     — _spread_kernel (materialize.py:130): compacted
//                       events to dense rows, unpacking block, zigzag
//                       index and value itself.
// Contracts: tpujpeg_torch/ops/materialize.py::compact_offsets_plain,
// compact_full_plain, spread_full_plain.
//
// What bounds them on Hopper: memory.  Each reads its int32/int16 [N, L]
// inputs once and writes its output once; the work per element is a few
// integer ops.  On the TPU all three are butterfly networks of log2(N)
// shift-and-select stages held in VMEM, because XLA:TPU cannot scatter;
// none of that is a contract here.
//
// Design:
//   * compact_offsets and spread_full are scatters with one thread per
//     (row, lane) element, coalesced over lanes, with no serial walk down
//     a lane: an element knows its own destination (row - o, or
//     64 * blk + z).  Outputs are pre-filled with memsets; destinations are
//     distinct per lane, so stores need no atomics.
//   * compact_full is the body it shares with slots.cu's compact,
//     csrc/compact.cuh, writing cp alone (8 bytes an element): a 32-lane
//     tile walked by 8 warps in 128-row chunks, each event read once, the
//     rank carried down the lane, the events staged in a shared-memory
//     window of output rows and written a whole row of the tile at a
//     time, the -1 rows with them, so no memset runs.
// Validity is a sign (ev >= 0, o >= 0), never cp > 0: an event that packs
// to 0 (blk 0, z 0, val -2048) is placed like any other.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr int kRowThreads = 256;  // lanes per block of the scatters

__global__ void compact_offsets_kernel(const int32_t* __restrict__ p,
                                       const int16_t* __restrict__ o,
                                       int32_t* __restrict__ p_out,
                                       int16_t* __restrict__ o_out, int L,
                                       int mask) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (lane >= L) return;
  const size_t i = static_cast<size_t>(r) * L + lane;
  const int off = __ldg(o + i);
  if (off < 0) return;             // empty row
  const int move = off & mask;     // the stages this call runs
  if (move > r) return;            // an offset past row 0
  const size_t dst = static_cast<size_t>(r - move) * L + lane;
  p_out[dst] = __ldg(p + i);
  o_out[dst] = static_cast<int16_t>(off - move);
}

__global__ void spread_full_kernel(const int32_t* __restrict__ cp,
                                   const int16_t* __restrict__ o,
                                   int16_t* __restrict__ dense,
                                   uint8_t* __restrict__ err, int M, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (lane >= L) return;
  const size_t i = static_cast<size_t>(r) * L + lane;
  const int32_t e = __ldg(cp + i);
  // validity: the offset's sign when the caller has one, else the event's
  const bool valid = o != nullptr ? __ldg(o + i) >= 0 : e >= 0;
  if (!valid) return;
  const int target = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63);
  if (target < M) {
    dense[static_cast<size_t>(target) * L + lane] =
        static_cast<int16_t>((e & 0xFFF) - 2048);
  } else if (err != nullptr) {
    err[lane] = 1;  // every writer stores the same value
  }
}

dim3 row_grid(int rows, int L) {
  return dim3((L + kRowThreads - 1) / kRowThreads, rows);
}

}  // namespace

// (p int32, o int16) [Np, L], o = row - rank >= 0 on valid rows ->
// (p_out, o_out) [Np, L]: each valid event at row - (o & mask) with
// o_out = o - (o & mask) there (0 when mask is -1), p_out == 0 and
// o_out == -1 elsewhere.  Np must be <= 65535.
extern "C" int tpj_compact_offsets(const int32_t* p, const int16_t* o,
                                   int32_t* p_out, int16_t* o_out, int Np,
                                   int L, int mask, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(Np) * L;
  cudaError_t rc = cudaMemsetAsync(p_out, 0, n * sizeof(int32_t), stream);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(o_out, 0xFF, n * sizeof(int16_t), stream);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (Np == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  compact_offsets_kernel<<<row_grid(Np, L), kRowThreads, 0, stream>>>(
      p, o, p_out, o_out, L, mask);
  return static_cast<int>(cudaGetLastError());
}

// ev int32 [N, L] (valid when >= 0) -> out int32 [N, L]: the valid events
// of each lane in row order at rows 0..n-1, -1 on the rows after.  Every
// element of out is written by the kernel; nothing is launched when N or
// L is 0.
extern "C" int tpj_compact_full(const int32_t* ev, int32_t* out, int N,
                                int L, cudaStream_t stream) {
  return static_cast<int>(
      compact::launch(ev, compact::PayloadRows{out}, N, L, stream));
}

// cp int32 [N, L] (+ optional o int16 [N, L]) -> dense int16 [M, L] at row
// 64 * blk + z; a valid event with a target >= M is not stored and sets
// err[lane] (err may be null).  N must be <= 65535.
extern "C" int tpj_spread_full(const int32_t* cp, const int16_t* o,
                               int16_t* dense, uint8_t* err, int N, int M,
                               int L, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      dense, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (N == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  spread_full_kernel<<<row_grid(N, L), kRowThreads, 0, stream>>>(
      cp, o, dense, err, M, L);
  return static_cast<int>(cudaGetLastError());
}
