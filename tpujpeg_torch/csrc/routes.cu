// The two other placements of the classic materialize (kernels
// "compact_offsets", "compact_full" and "spread_full" of tpujpeg_torch;
// ops/materialize.place_events_ranked and place_events_full, which no
// decode path takes: the scatter of materialize.cu is as fast or faster).
//
// Replace, in tpujpeg/ops/materialize.py:
//   * compact_offsets — _fine_compact_kernel (materialize.py:271) with the
//                       XLA coarse compact stages of _compact_to_rank
//                       (materialize.py:575-613): the compaction whose
//                       offsets row - rank were computed outside, by a
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
// integer ops.  The scatters add their own traffic: an output that is
// lane-minor takes each lone store as a 32-byte sector read and written
// back.  On the TPU all three are butterfly networks of log2(N)
// shift-and-select stages held in VMEM, because XLA:TPU cannot scatter;
// none of that is a contract here.
//
// Design: two shared bodies, each measured on its first kernel.
//   * compact_offsets and compact_full are csrc/compact.cuh.  Without a
//     mask (the ranked placement), with the complement mask ~(W - 1) on the
//     multiples of W that the fine stage leaves, and in compact_full: the
//     walk of slots.cu's compact, a 32-lane tile walked by 8 warps in
//     128-row chunks, each element read once, the rank carried down the
//     lane, the events staged in a shared-memory window of output rows
//     and written a whole row of the tile at a time, the empty rows with
//     them, so no memset runs.  compact_offsets reads (p, o) and takes a
//     row's event as o >= 0 ? p : -1; under its precondition (o = row -
//     rank on valid rows) the counted rank is row - o, so the walk
//     computes the scatter's function (12 bytes an element); compact_full
//     writes cp alone (8 bytes an element).  With a low-bit mask W - 1
//     (the probe compact_fine, and compact_staged's first call) the same
//     tile and chunks, but the destination row - (o & mask) is read, not
//     counted: it rises down each lane, so the window follows
//     destinations, holds W + 127 rows (up to 576), and again every
//     element is written once with no memset (compact.cuh's note).  A
//     scatter after two memsets stored each event into two lone sectors:
//     1.34-1.38 ms on the mixed chunk's fine stage, the walk 0.57-0.62.
//   * spread_full is csrc/place.cuh, the body of materialize.cu's
//     place_events, with validity from o >= 0 when the caller has offsets
//     (o is then read first, and cp only on rows with a valid lane) and
//     from the event's sign otherwise: the dense output zeroed, four
//     lanes x four rows a thread with all loads before the first store,
//     rows on gridDim.x.
// Validity is a sign (ev >= 0, o >= 0), never cp > 0: an event that packs
// to 0 (blk 0, z 0, val -2048) is placed like any other.

#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"
#include "place.cuh"

// (p int32, o int16) [Np, L], o = row - rank >= 0 on valid rows ->
// (p_out, o_out) [Np, L]: each valid event at row - (o & mask) with
// o_out = o - (o & mask) there, p_out == 0 and o_out == -1 elsewhere.
// mask: -1, W - 1 or ~(W - 1) for W a power of two; ~(W - 1) only on
// offsets that are multiples of W (it then moves every event to its rank
// and leaves o_out 0, as -1 does; other offsets are not checked, take the
// same result, and the plain version refuses them).  Any other mask:
// cudaErrorInvalidValue.
// Negative masks run the ranked walk of compact.cuh, W - 1 its masked
// walk, which adds its direct stores (a lane behind the window) to
// *direct where direct is not null.  Every element of the outputs is
// written by the kernel; nothing is launched when Np or L is 0.
extern "C" int tpj_compact_offsets(const int32_t* p, const int16_t* o,
                                   int32_t* p_out, int16_t* o_out, int Np,
                                   int L, int mask, int* direct,
                                   cudaStream_t stream) {
  const unsigned low = mask < 0 ? ~static_cast<unsigned>(mask)
                                : static_cast<unsigned>(mask);
  if ((low & (low + 1u)) != 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mask < 0) {
    return static_cast<int>(compact::launch(compact::Offsets{p, o},
                                            compact::RankRows{p_out, o_out},
                                            Np, L, stream));
  }
  return static_cast<int>(compact::launch_masked(
      compact::Masked{p, o, p_out, o_out, mask, direct}, Np, L, stream));
}

// ev int32 [N, L] (valid when >= 0) -> out int32 [N, L]: the valid events
// of each lane in row order at rows 0..n-1, -1 on the rows after.  Every
// element of out is written by the kernel; nothing is launched when N or
// L is 0.
extern "C" int tpj_compact_full(const int32_t* ev, int32_t* out, int N,
                                int L, cudaStream_t stream) {
  return static_cast<int>(compact::launch(
      compact::Events{ev}, compact::PayloadRows{out}, N, L, stream));
}

// cp int32 [N, L] (+ optional o int16 [N, L]) -> dense int16 [M, L] at row
// 64 * blk + z; a valid event with a target >= M is not stored and sets
// err[lane] (err may be null).  Valid: o >= 0 when o is given, else
// cp >= 0.
extern "C" int tpj_spread_full(const int32_t* cp, const int16_t* o,
                               int16_t* dense, uint8_t* err, int N, int M,
                               int L, cudaStream_t stream) {
  const cudaError_t rc =
      o != nullptr
          ? place::launch<place::Valid::kOffset>(cp, o, dense, err, N, M, L,
                                                 stream)
          : place::launch<place::Valid::kSign>(cp, nullptr, dense, err, N, M,
                                               L, stream);
  return static_cast<int>(rc);
}
