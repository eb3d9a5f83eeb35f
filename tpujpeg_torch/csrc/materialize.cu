// Packed events -> dense coefficient rows (kernel 2 of tpujpeg_torch).
//
// Replaces: the classic materialize of tpujpeg/ops/materialize.py —
// the Pallas kernels _fine_compact_rank_kernel (materialize.py:205) and
// _fine_spread_kernel (materialize.py:314) together with their XLA
// coarse stages (place_events_v3).  On the TPU those route every event
// to its rank and then to its target through butterfly networks, because
// XLA:TPU scatters serially; Hopper scatters natively, so their joint
// contract is one kernel.  Contract:
// tpujpeg_torch/ops/materialize.py::place_events_plain.
//
// What bounds it on Hopper: memory, twice over.  The byte bound is the
// event matrix (int32 [N, L], about two thirds -1) read once and the
// int16 [M, L] output written once.  The second bound is the scatter's
// own: the output is lane-minor, so events of neighbouring rows or lanes
// rarely share a 32-byte sector, and every 2-byte store moves a sector
// in and out of device memory; that traffic (valid events x 32 bytes,
// read and written, plus the fill) is several times the byte bound.
//
// Design: zero the output (cudaMemsetAsync), then stream the event
// matrix once with as many loads in flight as the card needs to run at
// its memory rate.  Every event carries its own target (row 64*blk + z
// of its lane) and per-lane targets are distinct, so any thread may
// place any event and no two stores collide: the walk is parallel over
// rows as well as lanes.  A thread owns four consecutive lanes (one
// 16-byte load per event row) times kRows consecutive rows, issues all
// its loads before its first store, then stores the valid events; the
// grid is N * L / (4 kRows) threads.  A lane count or a pointer that is
// not 16-byte aligned takes the same kernel at one lane per thread.  A
// target >= M (which the scan cannot produce) is not stored and latches
// the lane's error flag: every thread that sees one writes the same 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Event rows per thread: 4 was the fastest of 1, 2, 4, 8 and 16 on both
// chunk shapes of PERF.md, by 2-6% over 8 and 16.
constexpr int kRows = 4;
constexpr int kThreads = 256;

template <int kVec>
struct Events;
template <>
struct Events<4> {
  using type = int4;
  static __device__ __forceinline__ int4 empty() {
    return make_int4(-1, -1, -1, -1);
  }
};
template <>
struct Events<1> {
  using type = int;
  static __device__ __forceinline__ int empty() { return -1; }
};

__device__ __forceinline__ int lane_event(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int lane_event(const int& v, int) { return v; }

// kVec lanes per thread: 4 (16-byte loads) or 1.  blockIdx.x is the row
// tile, blockIdx.y and the thread the lane group.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
place_events_kernel(const int32_t* __restrict__ ev,
                    int16_t* __restrict__ out, uint8_t* __restrict__ err,
                    int N, int M, int L) {
  using Vec = typename Events<kVec>::type;
  const int groups = L / kVec;           // lane groups per event row
  const int group = blockIdx.y * kThreads + threadIdx.x;
  if (group >= groups) return;
  const int row0 = blockIdx.x * kRows;
  const int lane0 = group * kVec;
  const Vec* src = reinterpret_cast<const Vec*>(
      ev + static_cast<size_t>(row0) * L + lane0);
  Vec e[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    e[r] = row0 + r < N ? __ldg(src + static_cast<size_t>(r) * groups)
                        : Events<kVec>::empty();
  }
  unsigned oob = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int v = lane_event(e[r], i);
      if (v >= 0) {
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

template <int kVec>
cudaError_t launch_place(const int32_t* ev, int16_t* out, uint8_t* err, int N,
                         int M, int L, cudaStream_t stream) {
  const int groups = L / kVec;
  const dim3 grid((N + kRows - 1) / kRows, (groups + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  place_events_kernel<kVec><<<grid, kThreads, 0, stream>>>(ev, out, err, N,
                                                           M, L);
  return cudaGetLastError();
}

}  // namespace

// err may be null; otherwise lanes with an out-of-range target are set to 1.
extern "C" int tpj_place_events(const int32_t* ev, int16_t* out, uint8_t* err,
                                int N, int M, int L, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      out, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (N < 1 || L < 1) return static_cast<int>(cudaSuccess);
  const bool vec4 =
      L % 4 == 0 && (reinterpret_cast<uintptr_t>(ev) & 15) == 0;
  rc = vec4 ? launch_place<4>(ev, out, err, N, M, L, stream)
            : launch_place<1>(ev, out, err, N, M, L, stream);
  return static_cast<int>(rc);
}
