// The slot route of the materialize stage (kernels "compact",
// "slot_unpack" and "slot_expand" of tpujpeg_torch).
//
// Replaces, in tpujpeg/ops/materialize.py::place_events_slots:
//   * compact  — _fine_compact_rank_kernel (materialize.py:205) with the
//                XLA coarse compact stages of _compact_to_rank;
//   * unpack   — _slot_unpack_kernel (materialize.py:728);
//   * expand   — _fine_spread_expand_kernel (materialize.py:773) with the
//                XLA coarse slot-spread stages before it.
// Contracts: tpujpeg_torch/ops/materialize.py::compact_to_rank_plain,
// slot_unpack_plain, slot_expand_plain.
//
// What bounds them on Hopper: memory.  Each kernel reads its input
// matrices once (int32/int16 [N, L], mostly empty) and writes its output
// once; the work per element is a few integer ops.  On the TPU these are
// butterfly networks and windowed running maxima because XLA:TPU cannot
// scatter and a kernel sees one VMEM window at a time; none of that is a
// contract here.
//
// Design:
//   * compact and unpack are per-lane sequential passes, one thread per
//     lane (a rank and a group start are running values down a lane).
//     Reads of a row are coalesced across the lanes of a warp; the
//     outputs are pre-filled with memsets and the kernels store only
//     the live rows.  Unpack stops at the lane's first empty row (the
//     compacted events are a prefix).
//   * expand is a scatter from slot coordinates, one thread per
//     (row, lane): the slot's group and the event's block-in-group and
//     zigzag index give the dense row.  Targets are distinct per lane,
//     so the stores need no atomics.
// Validity is o >= 0 / o2 >= 0 throughout, never p != 0: an event that
// packs to 0 (blk 0, z 0, val -2048) is placed like any other.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLaneThreads = 32;   // one warp per block: spread over SMs
constexpr int kExpandThreads = 256;

__global__ void compact_kernel(const int32_t* __restrict__ ev,
                               int32_t* __restrict__ p,
                               int16_t* __restrict__ o, int N, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  size_t dst = lane;
#pragma unroll 8
  for (int r = 0; r < N; ++r) {
    const int32_t e = __ldg(ev + static_cast<size_t>(r) * L + lane);
    if (e >= 0) {
      p[dst] = e;
      o[dst] = 0;
      dst += L;
    }
  }
}

__global__ void slot_unpack_kernel(const int32_t* __restrict__ p,
                                   const int16_t* __restrict__ o,
                                   int16_t* __restrict__ o2,
                                   uint8_t* __restrict__ ovf, int Np, int L,
                                   int C, int gshift) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  int start = 0, gprev = -1;
  bool over = false;
  for (int r = 0; r < Np; ++r) {
    const size_t i = static_cast<size_t>(r) * L + lane;
    if (__ldg(o + i) < 0) break;  // end of the compacted events
    const int32_t e = __ldg(p + i);
    const int g = ((e >> 18) & 0x1FFF) >> gshift;
    if (r == 0 || g != gprev) {
      start = r;
      gprev = g;
    }
    const int rib = r - start;
    if (rib >= C) {
      over = true;  // the group holds more than C events
    } else {
      o2[i] = static_cast<int16_t>(g * C + rib - r);
    }
  }
  ovf[lane] = over ? 1 : 0;
}

__global__ void slot_expand_kernel(const int16_t* __restrict__ o2,
                                   const int32_t* __restrict__ p,
                                   int16_t* __restrict__ dense, int M, int L,
                                   int cshift, int gshift) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (lane >= L) return;
  const size_t i = static_cast<size_t>(r) * L + lane;
  const int off = __ldg(o2 + i);
  if (off < 0) return;
  const int32_t e = __ldg(p + i);
  const int group = (r + off) >> cshift;
  const int b_loc = (e >> 18) & ((1 << gshift) - 1);
  const int target = (group << (gshift + 6)) + (b_loc << 6) + ((e >> 12) & 63);
  if (target < M) {
    dense[static_cast<size_t>(target) * L + lane] =
        static_cast<int16_t>((e & 0xFFF) - 2048);
  }
}

int lane_blocks(int L) { return (L + kLaneThreads - 1) / kLaneThreads; }

}  // namespace

// ev int32 [N, L] -> p int32 [N, L] (0 past the events), o int16 [N, L]
// (0 on event rows, -1 past them).
extern "C" int tpj_compact(const int32_t* ev, int32_t* p, int16_t* o, int N,
                           int L, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(N) * L;
  cudaError_t rc = cudaMemsetAsync(p, 0, n * sizeof(int32_t), stream);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(o, 0xFF, n * sizeof(int16_t), stream);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  compact_kernel<<<lane_blocks(L), kLaneThreads, 0, stream>>>(ev, p, o, N, L);
  return static_cast<int>(cudaGetLastError());
}

// (p, o) [Np, L] -> o2 int16 [Np, L] (-1 where empty or overflowed),
// ovf uint8 [L]; C a power of two, gshift = log2(G).
extern "C" int tpj_slot_unpack(const int32_t* p, const int16_t* o,
                               int16_t* o2, uint8_t* ovf, int Np, int L,
                               int C, int gshift, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      o2, 0xFF, static_cast<size_t>(Np) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  slot_unpack_kernel<<<lane_blocks(L), kLaneThreads, 0, stream>>>(
      p, o, o2, ovf, Np, L, C, gshift);
  return static_cast<int>(cudaGetLastError());
}

// (o2, p) [Np, L] -> dense int16 [M, L]; cshift = log2(C), gshift =
// log2(G).  Np must be <= 65535 (the grid's y extent; the int16 offsets
// already bound it by 32768).
extern "C" int tpj_slot_expand(const int16_t* o2, const int32_t* p,
                               int16_t* dense, int Np, int M, int L,
                               int cshift, int gshift, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      dense, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (Np == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((L + kExpandThreads - 1) / kExpandThreads, Np);
  slot_expand_kernel<<<grid, kExpandThreads, 0, stream>>>(
      o2, p, dense, M, L, cshift, gshift);
  return static_cast<int>(cudaGetLastError());
}
