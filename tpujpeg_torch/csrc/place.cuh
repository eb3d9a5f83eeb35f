// The scatter of packed events to dense coefficient rows: the one body
// of kernels "place_events" (csrc/materialize.cu) and "spread_full"
// (csrc/routes.cu), which differ only in where validity comes from.
//
// ev int32 [N, L] packed `blk << 18 | z << 12 | (val + 2048)` (+ for
// spread_full with offsets, o int16 [N, L]) -> dense int16 [M, L]: every
// valid row stores val at row 64 * blk + z of its lane; the other dense
// rows are 0.  A row is valid when its event is >= 0 (Valid::kSign:
// place_events, spread_full without o) or when its offset is >= 0
// (Valid::kOffset: spread_full with the offsets of compact_to_rank, whose
// p is 0 on empty rows); never when the event is > 0, so the event that
// packs to 0 (blk 0, z 0, val -2048) is placed like any other.  A valid
// event with a target >= M is not stored and latches err[lane] (err may
// be null); a row that is not valid neither stores nor latches.
//
// Replaces, in tpujpeg/ops/materialize.py: place_events — the Pallas
// kernels _fine_compact_rank_kernel (materialize.py:205) and
// _fine_spread_kernel (materialize.py:314) with their XLA coarse stages
// (place_events_v3); spread_full — _spread_kernel (materialize.py:130).
// On the TPU these route every event through butterfly networks, because
// XLA:TPU scatters serially; Hopper scatters natively, so each contract
// is one kernel.
//
// What bounds it on Hopper: memory, twice over.  The byte bound is the
// event matrix (and o) read once and the dense output written once.  The
// second bound is the scatter's own: the output is lane-minor, so events
// of neighbouring rows or lanes rarely share a 32-byte sector, and every
// 2-byte store moves a sector in and out of device memory (the sector
// bound: the byte bound plus 64 bytes per valid event).
//
// Design: zero the output (cudaMemsetAsync), then stream the inputs once
// with as many loads in flight as the card needs to run at its memory
// rate.  Every event carries its own target and per-lane targets are
// distinct, so any thread may place any event and no two stores collide:
// the walk is parallel over rows as well as lanes.  A thread owns four
// consecutive lanes (one 16-byte load of ev and one 8-byte load of o per
// row) times kRows consecutive rows, starts all its loads before its
// first store, then stores the valid events; rows are on gridDim.x, so
// any row count launches.  With offsets, a thread loads its rows' o
// first and ev only for the rows where one of its lanes is valid: the
// compacted rows of the ranked route hold their events at the top of
// each lane, so most ev loads below them are skipped (6-7% faster on the
// mixed chunk than loading both; PERF.md, section 6).  A lane count that
// is not a multiple of 4, or an ev or o pointer that is not aligned to
// its vector, takes the same body at one lane per thread.  The validity
// policy is a template parameter, so neither instantiation branches on
// it inside the row loop.  Every thread that sees a target >= M writes
// the same 1.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace place {

// Event rows per thread: 4 was the fastest of 1, 2, 4, 8 and 16 on both
// chunk shapes of PERF.md, by 2-6% over 8 and 16.
constexpr int kRows = 4;
constexpr int kThreads = 256;

enum class Valid { kSign, kOffset };

template <int kVec>
struct Lanes;
template <>
struct Lanes<4> {
  using Events = int4;
  using Offsets = short4;
  static __device__ __forceinline__ int4 no_events() {
    return make_int4(-1, -1, -1, -1);
  }
  static __device__ __forceinline__ short4 no_offsets() {
    return make_short4(-1, -1, -1, -1);
  }
};
template <>
struct Lanes<1> {
  using Events = int;
  using Offsets = short;
  static __device__ __forceinline__ int no_events() { return -1; }
  static __device__ __forceinline__ short no_offsets() { return -1; }
};

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane_of(const int& v, int) { return v; }
__device__ __forceinline__ int lane_of(const short4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane_of(const short& v, int) { return v; }

// kVec lanes per thread: 4 (vector loads) or 1.  blockIdx.x is the row
// tile, blockIdx.y and the thread the lane group.  o is read only with
// Valid::kOffset.
template <int kVec, Valid kValid>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ ev,
               const int16_t* __restrict__ o, int16_t* __restrict__ out,
               uint8_t* __restrict__ err, int N, int M, int L) {
  using V = Lanes<kVec>;
  const int groups = L / kVec;           // lane groups per event row
  const int group = blockIdx.y * kThreads + threadIdx.x;
  if (group >= groups) return;
  const int row0 = blockIdx.x * kRows;
  const int lane0 = group * kVec;
  const size_t at = static_cast<size_t>(row0) * L + lane0;
  const auto* src = reinterpret_cast<const typename V::Events*>(ev + at);
  typename V::Events e[kRows];
  [[maybe_unused]] typename V::Offsets f[kRows];
  if constexpr (kValid == Valid::kOffset) {
    const auto* osrc = reinterpret_cast<const typename V::Offsets*>(o + at);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      f[r] = row0 + r < N ? __ldg(osrc + static_cast<size_t>(r) * groups)
                          : V::no_offsets();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      int all = lane_of(f[r], 0);     // negative when every lane is empty
#pragma unroll
      for (int i = 1; i < kVec; ++i) all &= lane_of(f[r], i);
      e[r] = all >= 0 ? __ldg(src + static_cast<size_t>(r) * groups)
                      : V::no_events();
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      e[r] = row0 + r < N ? __ldg(src + static_cast<size_t>(r) * groups)
                          : V::no_events();
    }
  }
  unsigned oob = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int v = lane_of(e[r], i);
      bool valid;
      if constexpr (kValid == Valid::kOffset) {
        valid = lane_of(f[r], i) >= 0;
      } else {
        valid = v >= 0;
      }
      if (valid) {
        const int target = ((v >> 18) & 0x1FFF) * 64 + ((v >> 12) & 63);
        if (target < M) {
          out[static_cast<size_t>(target) * L + lane0 + i] =
              static_cast<int16_t>((v & 0xFFF) - 2048);
        } else {
          oob |= 1u << i;
        }
      }
    }
  }
  if (oob != 0 && err != nullptr) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if ((oob >> i) & 1u) err[lane0 + i] = 1;
    }
  }
}

template <int kVec, Valid kValid>
cudaError_t launch_at(const int32_t* ev, const int16_t* o, int16_t* out,
                      uint8_t* err, int N, int M, int L,
                      cudaStream_t stream) {
  const int groups = L / kVec;
  const dim3 grid((N + kRows - 1) / kRows,
                  (groups + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  scatter_kernel<kVec, kValid><<<grid, kThreads, 0, stream>>>(ev, o, out,
                                                              err, N, M, L);
  return cudaGetLastError();
}

// Zeroes out [M, L], then scatters ev [N, L] into it; nothing is launched
// when N or L is 0.
template <Valid kValid>
cudaError_t launch(const int32_t* ev, const int16_t* o, int16_t* out,
                   uint8_t* err, int N, int M, int L, cudaStream_t stream) {
  const cudaError_t rc = cudaMemsetAsync(
      out, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return rc;
  if (N < 1 || L < 1) return cudaSuccess;
  const bool vec4 =
      L % 4 == 0 && (reinterpret_cast<uintptr_t>(ev) & 15) == 0 &&
      (kValid == Valid::kSign || (reinterpret_cast<uintptr_t>(o) & 7) == 0);
  return vec4 ? launch_at<4, kValid>(ev, o, out, err, N, M, L, stream)
              : launch_at<1, kValid>(ev, o, out, err, N, M, L, stream);
}

}  // namespace place

}  // namespace
