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
// slot_unpack_plain, slot_expand_plain.  On the TPU these are butterfly
// networks and windowed running maxima because XLA:TPU cannot scatter
// and a kernel sees one VMEM window at a time; none of that is a
// contract here.  Validity is ev >= 0 / o >= 0 / o2 >= 0 throughout,
// never p != 0: an event that packs to 0 (blk 0, z 0, val -2048) is
// placed like any other.
//
// compact: the body it shares with routes.cu's compact_full,
// csrc/compact.cuh, writing (p, o); bounded by memory (ev read once, p
// and o written once: 10 bytes an element); a 32-lane tile walked by 8
// warps in 128-row chunks with the rank carried down the lane, the
// events staged in a shared-memory window of output rows and written a
// whole row of the tile at a time, the empty rows with them, so no
// memset runs (the note in compact.cuh).
//
// slot_unpack: bounded by memory (the live prefix of p and o read once,
// o2 written once), and by latency when one thread walks one lane: a
// lane's ~1,400 live rows are as many dependent round trips.  What a
// lane carries down its rows is an associative scan — liveness as the
// lane's first hole (a min), the group start as the last row whose group
// differs from the row before, or row 0 (a max), the overflow an OR — so
// the walk is parallel over rows as well as lanes.  A block of kWarps
// warps owns a tile of 32 lanes (each warp reads 64 / 128 contiguous
// bytes of a row of o / p) and walks the tile's rows in chunks of
// kWarps * kSlice rows; each warp takes a contiguous slice of a chunk.
// A thread issues all its slice's o and p loads (and the p of the row
// before the slice) before it uses any, reduces the slice to its first
// hole and last boundary, and the warps combine those in shared memory
// with the carry from the chunk before (double-buffered: one barrier a
// chunk).  Each row then gets o2 = g*C + rib - r, or -1 on dead or
// overflowed rows.  After the chunk in which all 32 lanes are dead the
// block writes the rest of the tile's o2 as -1 without loading, so o2 is
// written once and needs no memset.
//
// slot_expand: a scatter, bounded by its stores: dense is lane-minor, so
// each event's 2-byte store moves a 32-byte sector in and out, on top of
// the zero fill of dense (the sector bound: the byte bound plus 64 bytes
// per event).  A thread takes one row of kVec = 8 lanes (one 16-byte o2
// load), loads p only for the 4-lane halves whose o2 holds a live
// offset, then stores.  A block covers a strip of 128 lanes x 16 rows
// and blockIdx.x is the row tile, so the blocks in flight cover every
// row of a few strips: the sectors an event touches are the ones its
// neighbouring lanes touch, while they are still in L2 (16-row tiles of
// 128 lanes beat 4 rows x 2048 lanes by 4-8%, lanes fastest by 18-24%;
// PERF.md, section 6).  Every live row sits at slot r + o2 of group
// slot >> log2(C) and lands on dense row group * 64G + 64 * (blk mod G)
// + z of its lane; targets are distinct within a lane, so no store needs
// an atomic; a target >= M is dropped.  A lane count or a pointer that
// is not 16-byte aligned takes the same kernel at one lane per thread.
// The zero fill stays a memset: writing dense once (zeros and events
// together, from a shared-memory tile of a slot group) needs each lane's
// rows of that group, which start at rows tens of groups apart across a
// tile's lanes; it was not built (PERF.md, section 6).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr int kWarps = 8;          // slot_unpack: warps per 32-lane tile
constexpr int kSlice = 16;         // rows of a warp's slice of a chunk
constexpr int kChunk = kWarps * kSlice;

constexpr int kStripLanes = 128;   // slot_expand: lanes of a block
constexpr int kExpandThreads = 256;

// blockIdx.x: the tile of lanes [32 x, 32 x + 32); threadIdx.x: lane
// (low 5 bits) and warp.
__global__ void __launch_bounds__(kWarps * 32, 4)
slot_unpack_kernel(const int32_t* __restrict__ p,
                   const int16_t* __restrict__ o, int16_t* __restrict__ o2,
                   uint8_t* __restrict__ ovf, int Np, int L, int C,
                   int gshift) {
  __shared__ int s_start[2][kWarps][32];
  __shared__ int s_hole[2][kWarps][32];
  __shared__ unsigned s_over[kWarps][32];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lane = blockIdx.x * 32 + t;
  const bool in = lane < L;
  int start = 0;               // last group start above the chunk
  int hole = in ? INT_MAX : -1;  // the lane's first row with o < 0
  bool over = false;
  int c0 = 0;
  for (int buf = 0; c0 < Np; c0 += kChunk, buf ^= 1) {
    const int s0 = c0 + w * kSlice;
    // g[i]: the group of row s0 + i; bit i of holes / starts: that row
    // has o < 0 (or lies past Np) / differs in group from the row before
    int g[kSlice];
    unsigned holes = 0, starts = 0;
    if (hole >= c0) {          // the lane is live above this chunk
      int32_t e[kSlice];
      int16_t oo[kSlice];
      const size_t base = static_cast<size_t>(s0) * L + lane;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        const bool row = s0 + i < Np;
        oo[i] = row ? __ldg(o + base + static_cast<size_t>(i) * L)
                    : static_cast<int16_t>(-1);
        e[i] = row ? __ldg(p + base + static_cast<size_t>(i) * L) : 0;
      }
      // row 0 starts a group: -1 is no group
      int before = s0 > 0 && s0 <= Np
                       ? ((__ldg(p + base - L) >> 18) & 0x1FFF) >> gshift
                       : -1;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        g[i] = ((e[i] >> 18) & 0x1FFF) >> gshift;
        starts |= static_cast<unsigned>(g[i] != before) << i;
        holes |= static_cast<unsigned>(oo[i] < 0) << i;
        before = g[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlice; ++i) g[i] = 0;
    }
    const int first_hole = holes ? s0 + __ffs(holes) - 1 : INT_MAX;
    s_start[buf][w][t] = starts ? s0 + 31 - __clz(starts) : -1;
    s_hole[buf][w][t] = first_hole;
    __syncthreads();
    // the carry into this warp's slice, and into the next chunk
    int start_in = start, hole_in = hole;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k == w) {
        start_in = start;
        hole_in = hole;
      }
      start = max(start, s_start[buf][k][t]);
      hole = min(hole, s_hole[buf][k][t]);
    }
    const int dead = min(hole_in, first_hole);
    int st = start_in;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const int r = s0 + i;
      if ((starts >> i) & 1u) st = r;
      int16_t out = -1;
      if (r < dead) {
        const int rib = r - st;
        if (rib >= C) {
          over = true;         // the group holds more than C events
        } else {
          out = static_cast<int16_t>(g[i] * C + rib - r);
        }
      }
      if (in && r < Np) o2[static_cast<size_t>(r) * L + lane] = out;
    }
    // every warp holds the same carries, so the exit is block-uniform
    if (__all_sync(0xffffffffu, hole < c0 + kChunk)) {
      c0 += kChunk;
      break;
    }
  }
  if (in) {
    for (int r = c0 + w; r < Np; r += kWarps) {
      o2[static_cast<size_t>(r) * L + lane] = -1;
    }
  }
  s_over[w][t] = over ? 1u : 0u;
  __syncthreads();
  if (w == 0 && in) {
    unsigned any = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) any |= s_over[k][t];
    ovf[lane] = any ? 1 : 0;
  }
}

template <int kVec>
struct Offsets;
template <>
struct Offsets<8> {
  using type = int4;   // eight int16 offsets
  static __device__ __forceinline__ int at(const int4& v, int i) {
    const int word = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return static_cast<int16_t>((i & 1) ? (word >> 16) : (word & 0xFFFF));
  }
  // bit h: lanes 4h .. 4h+3 hold a live (>= 0) offset
  static __device__ __forceinline__ unsigned live_halves(const int4& v) {
    constexpr unsigned kSign = 0x80008000u;
    const unsigned lo = (~static_cast<unsigned>(v.x) & kSign) |
                        (~static_cast<unsigned>(v.y) & kSign);
    const unsigned hi = (~static_cast<unsigned>(v.z) & kSign) |
                        (~static_cast<unsigned>(v.w) & kSign);
    return (lo ? 1u : 0u) | (hi ? 2u : 0u);
  }
};
template <>
struct Offsets<1> {
  using type = int16_t;
  static __device__ __forceinline__ int at(int16_t v, int) { return v; }
  static __device__ __forceinline__ unsigned live_halves(int16_t v) {
    return v >= 0 ? 1u : 0u;
  }
};

template <int kVec>
struct Payload;
template <>
struct Payload<8> {
  int4 h[2];
  __device__ __forceinline__ int at(int i) const {
    const int4& v = h[i >> 2];
    const int j = i & 3;
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ void load(const int32_t* src, unsigned halves) {
    const int4* s = reinterpret_cast<const int4*>(src);
    h[0] = halves & 1u ? __ldg(s) : make_int4(0, 0, 0, 0);
    h[1] = halves & 2u ? __ldg(s + 1) : make_int4(0, 0, 0, 0);
  }
};
template <>
struct Payload<1> {
  int v;
  __device__ __forceinline__ int at(int) const { return v; }
  __device__ __forceinline__ void load(const int32_t* src, unsigned halves) {
    v = halves ? __ldg(src) : 0;
  }
};

// kVec lanes per thread: 8 (16-byte o2 loads) or 1.  A block covers a
// strip of kStripLanes lanes x (kExpandThreads * kVec / kStripLanes)
// rows, one row of kVec lanes a thread; blockIdx.x is the row tile,
// blockIdx.y the strip.
template <int kVec>
__global__ void __launch_bounds__(kExpandThreads)
slot_expand_kernel(const int16_t* __restrict__ o2,
                   const int32_t* __restrict__ p,
                   int16_t* __restrict__ dense, int Np, int M, int L,
                   int cshift, int gshift) {
  constexpr int kGroups = kStripLanes / kVec;   // lane groups of a strip
  constexpr int kTileRows = kExpandThreads / kGroups;
  const int group = blockIdx.y * kGroups + threadIdx.x % kGroups;
  const int row = blockIdx.x * kTileRows + threadIdx.x / kGroups;
  if (group * kVec >= L || row >= Np) return;
  const int lane0 = group * kVec;
  const size_t at = static_cast<size_t>(row) * L + lane0;
  const auto off = __ldg(
      reinterpret_cast<const typename Offsets<kVec>::type*>(o2 + at));
  Payload<kVec> pay;
  pay.load(p + at, Offsets<kVec>::live_halves(off));
  const int bmask = (1 << gshift) - 1;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int d = Offsets<kVec>::at(off, i);
    if (d >= 0) {
      const int e = pay.at(i);
      const int grp = (row + d) >> cshift;
      const int target = (grp << (gshift + 6)) + (((e >> 18) & bmask) << 6)
                         + ((e >> 12) & 63);
      if (target < M) {
        dense[static_cast<size_t>(target) * L + lane0 + i] =
            static_cast<int16_t>((e & 0xFFF) - 2048);
      }
    }
  }
}

template <int kVec>
cudaError_t launch_expand(const int16_t* o2, const int32_t* p, int16_t* dense,
                          int Np, int M, int L, int cshift, int gshift,
                          cudaStream_t stream) {
  constexpr int kTileRows = kExpandThreads * kVec / kStripLanes;
  const dim3 grid((Np + kTileRows - 1) / kTileRows,
                  (L + kStripLanes - 1) / kStripLanes);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  slot_expand_kernel<kVec><<<grid, kExpandThreads, 0, stream>>>(
      o2, p, dense, Np, M, L, cshift, gshift);
  return cudaGetLastError();
}

}  // namespace

// ev int32 [N, L] -> p int32 [N, L] (0 past the events), o int16 [N, L]
// (0 on event rows, -1 past them).  Every element of p and o is written
// by the kernel; nothing is launched when N or L is 0.
extern "C" int tpj_compact(const int32_t* ev, int32_t* p, int16_t* o, int N,
                           int L, cudaStream_t stream) {
  return static_cast<int>(
      compact::launch(compact::Events{ev}, compact::RankRows{p, o}, N, L,
                      stream));
}

// (p, o) [Np, L] -> o2 int16 [Np, L] (-1 where empty or overflowed),
// ovf uint8 [L]; C a power of two, gshift = log2(G).  Every element of
// o2 and ovf is written by the kernel.
extern "C" int tpj_slot_unpack(const int32_t* p, const int16_t* o,
                               int16_t* o2, uint8_t* ovf, int Np, int L,
                               int C, int gshift, cudaStream_t stream) {
  if (L < 1) return static_cast<int>(cudaSuccess);
  slot_unpack_kernel<<<(L + 31) / 32, kWarps * 32, 0, stream>>>(
      p, o, o2, ovf, Np, L, C, gshift);
  return static_cast<int>(cudaGetLastError());
}

// (o2, p) [Np, L] -> dense int16 [M, L]; cshift = log2(C), gshift =
// log2(G).
extern "C" int tpj_slot_expand(const int16_t* o2, const int32_t* p,
                               int16_t* dense, int Np, int M, int L,
                               int cshift, int gshift, cudaStream_t stream) {
  cudaError_t rc = cudaMemsetAsync(
      dense, 0, static_cast<size_t>(M) * L * sizeof(int16_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (Np < 1 || L < 1) return static_cast<int>(cudaSuccess);
  const bool vec8 = L % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(o2) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  rc = vec8 ? launch_expand<8>(o2, p, dense, Np, M, L, cshift, gshift, stream)
            : launch_expand<1>(o2, p, dense, Np, M, L, cshift, gshift, stream);
  return static_cast<int>(rc);
}
