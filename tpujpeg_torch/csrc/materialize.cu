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
// What bounds it on Hopper: memory.  The event matrix (int32 [N, L],
// mostly -1) is read once and the int16 [M, L] output is written once
// (a memset, then the events' 2-byte stores).
//
// Design: zero the output, then one thread per lane walks its N event
// rows in order.  Row reads are coalesced across the lanes of a warp and
// unrolled so several are in flight.  An event goes to row 64*blk + z of
// its lane; per-lane targets are strictly increasing, so stores never
// collide and need no atomics.  A target >= M (which the scan cannot
// produce) is not stored and latches the lane's error flag.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void place_events_kernel(const int32_t* __restrict__ ev,
                                    int16_t* __restrict__ out,
                                    uint8_t* __restrict__ err,
                                    int N, int M, int L) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  bool oob = false;
#pragma unroll 8
  for (int r = 0; r < N; ++r) {
    const int32_t e = __ldg(ev + static_cast<size_t>(r) * L + lane);
    if (e >= 0) {
      const int target = ((e >> 18) & 0x1FFF) * 64 + ((e >> 12) & 63);
      if (target < M) {
        out[static_cast<size_t>(target) * L + lane] =
            static_cast<int16_t>((e & 0xFFF) - 2048);
      } else {
        oob = true;
      }
    }
  }
  if (oob && err != nullptr) err[lane] = 1;
}

}  // namespace

// err may be null; otherwise lanes with an out-of-range target are set to 1.
extern "C" int tpj_place_events(const int32_t* ev, int16_t* out, uint8_t* err,
                                int N, int M, int L, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      out, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // one warp per block spreads the few hundred lane warps over all SMs
  constexpr int kThreads = 32;
  const int blocks = (L + kThreads - 1) / kThreads;
  place_events_kernel<<<blocks, kThreads, 0, stream>>>(ev, out, err, N, M, L);
  return static_cast<int>(cudaGetLastError());
}
