// Packed events -> dense coefficient rows (kernel "place_events" of
// tpujpeg_torch): the classic scatter.
//
// Replaces: the classic materialize of tpujpeg/ops/materialize.py —
// the Pallas kernels _fine_compact_rank_kernel (materialize.py:205) and
// _fine_spread_kernel (materialize.py:314) together with their XLA
// coarse stages (place_events_v3).  Contract:
// tpujpeg_torch/ops/materialize.py::place_events_plain.
//
// The body is csrc/place.cuh, shared with routes.cu's spread_full, with
// validity from the event's sign; what bounds it on Hopper (the event
// matrix read once, dense written once, and a 32-byte sector moved in and
// out per stored event) and what its design does about that (four lanes
// x four rows a thread, all loads before the first store, rows on
// gridDim.x) are in the note there.

#include <cstdint>
#include <cuda_runtime.h>

#include "place.cuh"

// err may be null; otherwise lanes with an out-of-range target are set to 1.
extern "C" int tpj_place_events(const int32_t* ev, int16_t* out, uint8_t* err,
                                int N, int M, int L, cudaStream_t stream) {
  return static_cast<int>(place::launch<place::Valid::kSign>(
      ev, nullptr, out, err, N, M, L, stream));
}
