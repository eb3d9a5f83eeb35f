// The stable per-lane compaction with its ranks found in the kernel: the
// one body of kernels "compact" (csrc/slots.cu), "compact_full" and
// "compact_offsets" without a mask (csrc/routes.cu), which differ only in
// what they read and what they write; and its second body, the walk whose
// window follows destinations read from the offsets: "compact_offsets"
// with a low-bit mask (the probes compact_fine and compact_staged).
//
// Each lane's valid events in row order go to rows 0..n-1 of that lane,
// and an empty mark to rows n..N-1.  Sources: `compact` and
// `compact_full` read ev int32 [N, L] (valid when >= 0; every negative
// value is invalid, and the event that packs to 0 is valid);
// `compact_offsets` reads (p int32, o int16) [N, L] and takes a row's
// event as o >= 0 ? p : -1 (a valid event is never negative).  Outputs:
// `compact` and `compact_offsets` write (p int32, o int16) = (event, 0) /
// (0, -1), `compact_full` cp int32 = event / -1.
//
// compact_offsets' precondition: on every valid row o = row - rank, the
// distance to the row's rank (compact_to_rank's 'init' cut, or the output
// of a masked compact_offsets, which keeps it on the rows it moved to).
// The rank the walk counts is then row - o, so writing each event at its
// counted rank is the scatter by offset of compact_offsets' contract.
// The walk counts rather than reads the destination because that keeps
// one body: the window's bookkeeping (the carry, the lead, the trail)
// stays a count, and the offsets source costs only its second load.
// The complement mask ~(W - 1) takes this walk too: on offsets that are
// multiples of W (what the fine stage leaves) o & ~(W - 1) = o, so the
// destination is the rank and the residual 0, as with mask -1.  Other
// offsets are not checked: the walk still writes mask -1's result, which
// is not the scatter by o & ~(W - 1), and the plain version refuses them.
//
// Replaces, in tpujpeg/ops/materialize.py: compact — the rank-in-kernel
// fine compaction _fine_compact_rank_kernel (materialize.py:205) with
// the XLA coarse stages of _compact_to_rank; compact_full —
// _compact_kernel (materialize.py:102); compact_offsets —
// _fine_compact_kernel (materialize.py:271) with the XLA coarse stages
// of _compact_to_rank (the rank kernel off); with a low-bit mask,
// _fine_compact_kernel alone (tools/bench_materialize2.py:141, 158).  On
// the TPU all are butterfly networks of log2(N) shift-and-select stages
// in VMEM, because XLA:TPU cannot scatter; none of that is a contract
// here.
//
// What bounds it on Hopper: memory.  The input is read once and each
// output element written once: 10 bytes an element for compact, 8 for
// compact_full, 12 for compact_offsets.  A rank is a running count
// down a lane, so the walk is a scan; the count is associative, so the
// walk is parallel over rows as well as lanes.  A block of kWarps warps
// owns a tile of 32 lanes (a warp reads one 128-byte line of a row) and
// walks the tile's rows in chunks of kWarps * kSlice rows, each warp a
// contiguous slice of kSlice rows.  A thread starts all its slice's
// loads before it uses any, counts the slice's valid rows, and the warps
// add those counts in shared memory to the rank carried from the chunks
// above.  There is no early exit: a valid event may sit at any row.
//
// The stores are the hard part.  The output is lane-minor, and the 32
// lanes of a tile sit at different ranks, so an event stored at its
// rank touches a sector no neighbouring lane fills until much later:
// each 4-byte store costs a sector read and written back (stored so,
// the kernel took 1.08 ms on the spec chunk's events against 0.27-0.29
// for the same walk storing every row in place; PERF.md, section 6).  So
// the block stages its events in a window of kRing output rows in
// shared memory (-1: no event yet) and writes whole rows of the tile
// from it: after each chunk, the rows that no lane will store into
// again — below the smallest carry, and below the window, which
// follows the lane that leads by kRing - kChunk rows — leave the ring
// as one coalesced store per row, each lane's staged event or, where
// it has none, the empty mark.  A lane further behind than the window
// stores its events directly, over the empty mark (after a barrier):
// on the chunks' events 4-8% of them with a window of 256 rows, at most
// 0.02% with 512; 384 rows (48 KB) leave room for the four blocks an SM
// holds at 64 registers, 512 for three.  After the last chunk
// the block writes the rows left the same way, so every element is
// written once (direct stores twice) and no memset runs.
//
// The masked walk (compact_offsets with mask W - 1: each valid event
// moves up by o & (W - 1) and keeps the residual o & ~(W - 1)) reads its
// destinations: dst = row - (o & mask) = rank + (o & ~mask).  Under the
// precondition o never falls down a lane (between valid rows r1 < r2 of
// ranks k, k + 1 it grows by r2 - r1 - 1), so o & ~mask never falls and
// dst rises by at least 1 an event, never below the lane's count.  That
// is what the window needs, not a rank: a lane's carry becomes its last
// destination + 1, and the lead is the largest destination of the chunk,
// found (a barrier) before anything is staged; the window advances to it
// first, writing out the rows that leave it, so no row takes a direct
// store before its empty mark.  No count is kept.  The ring stages p and
// the residual (6 bytes a row of each lane) for W + kChunk - 1 rows, the
// most a destination lags its row, up to kMaskedRingMax: two blocks an
// SM.  A lane further behind stores directly, and a caller can count
// those stores.  A thread issues its slice of the next chunk before it
// stages this one (0.79-0.83 ms -> 0.65-0.67 on the mixed chunk's fine
// stage at 1,152 rows).  Every element is written once (direct stores
// twice) and no memset runs.  Tried and slower (PERF.md, section 6):
// a scatter after two memsets, 1.34-1.38 ms; the same in place.cuh's
// layout, 1.41-1.44; 16-lane tiles with 1,152 rows, two blocks an SM,
// 0.68-0.70.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace compact {

constexpr int kWarps = 8;         // warps per 32-lane tile
constexpr int kSlice = 16;        // rows of a warp's slice of a chunk
constexpr int kChunk = kWarps * kSlice;
constexpr int kRing = 384;        // rows of the staged output window
constexpr int kRingBytes = kRing * 32 * sizeof(int32_t);
static_assert(kRing % kWarps == 0, "a ring slot's rows fall to one warp");

// compact, compact_full: the events themselves, valid when >= 0
struct Events {
  const int32_t* ev;
  __device__ __forceinline__ int32_t load(size_t at) const {
    return __ldg(ev + at);
  }
};

// compact_offsets: the row's p where its offset o >= 0, else -1.  Both
// loads are made whatever the offset, so a slice's loads stay in flight
// together (loading p only where o >= 0 took 0.70-0.73 ms on the mixed
// chunk against 0.51-0.53; PERF.md, section 6).
struct Offsets {
  const int32_t* p;
  const int16_t* o;
  __device__ __forceinline__ int32_t load(size_t at) const {
    const int32_t e = __ldg(p + at);
    return __ldg(o + at) >= 0 ? e : -1;
  }
};

// compact, compact_offsets: (p, o) = (event, 0) on event rows, (0, -1)
// after them
struct RankRows {
  int32_t* p;
  int16_t* o;
  __device__ __forceinline__ void event(size_t at, int32_t e) const {
    p[at] = e;
    o[at] = 0;
  }
  __device__ __forceinline__ void empty(size_t at) const {
    p[at] = 0;
    o[at] = -1;
  }
};

// compact_full: cp = event on event rows, -1 after them
struct PayloadRows {
  int32_t* cp;
  __device__ __forceinline__ void event(size_t at, int32_t e) const {
    cp[at] = e;
  }
  __device__ __forceinline__ void empty(size_t at) const { cp[at] = -1; }
};

// Writes rows [from, to) of a lane, this warp's share of them (every
// kWarps-th row from its own), whole rows of the tile at a time: the
// staged event, or else the empty mark.  Every event ranked >= from was
// staged; a lane below the window that later reaches a row marked empty
// stores its event there directly, after a barrier.
template <class Out>
__device__ __forceinline__ void write_rows(int32_t* ring, const Out& out,
                                           int from, int to, int L,
                                           int lane, bool in) {
  if (!in) return;
  const int t = threadIdx.x & 31;
  for (int r = from + (threadIdx.x >> 5); r < to; r += kWarps) {
    int32_t* slot = &ring[r % kRing * 32 + t];
    const int32_t v = *slot;
    const size_t at = static_cast<size_t>(r) * L + lane;
    if (v >= 0) {
      out.event(at, v);
      *slot = -1;
    } else {
      out.empty(at);
    }
  }
}

// blockIdx.x: the tile of lanes [32 x, 32 x + 32); threadIdx.x: lane
// (low 5 bits) and warp.
template <class Src, class Out>
__global__ void __launch_bounds__(kWarps * 32, 4)
compact_kernel(Src src, Out out, int N, int L) {
  __shared__ int s_count[kWarps][32];
  extern __shared__ int32_t s_ring[];     // [kRing][32]; -1: no event
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lane = blockIdx.x * 32 + t;
  const bool in = lane < L;
  for (int i = threadIdx.x; i < kRing * 32; i += kWarps * 32) {
    s_ring[i] = -1;
  }
  int carry = 0;   // the lane's valid rows above the chunk
  int lo = 0;      // events ranked >= lo go to the ring, the rest direct
  int done = 0;    // rows below `done` have left the ring
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int s0 = c0 + w * kSlice;
    const size_t base = static_cast<size_t>(s0) * L + lane;
    int32_t e[kSlice];
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      e[i] = in && s0 + i < N ? src.load(base + static_cast<size_t>(i) * L)
                              : -1;
    }
    unsigned valid = 0;           // bit i: row s0 + i holds an event
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      valid |= static_cast<unsigned>(e[i] >= 0) << i;
    }
    s_count[w][t] = __popc(valid);
    __syncthreads();
    int at = carry;               // the rank of the slice's first event
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int n = s_count[k][t];
      at += k < w ? n : 0;
      carry += n;
    }
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      if ((valid >> i) & 1u) {
        if (at >= lo) {
          s_ring[at % kRing * 32 + t] = e[i];
        } else {                  // a lane far behind the tile's lead
          out.event(static_cast<size_t>(at) * L + lane, e[i]);
        }
        ++at;
      }
    }
    // every warp holds the same carries.  The next chunk's stores, at
    // most kChunk a lane, must fit below lo + kRing; rows below both that
    // lo and every lane's carry take no more stores from the ring.
    const int lead = __reduce_max_sync(0xffffffffu, in ? carry : 0);
    const int trail = __reduce_min_sync(0xffffffffu, in ? carry : INT_MAX);
    lo = max(lo, lead + kChunk - kRing);
    const int upto = max(lo, trail);
    __syncthreads();
    write_rows(s_ring, out, done, upto, L, lane, in);
    done = upto;
  }
  __syncthreads();   // the ring slots of rows below `done` are clear
  write_rows(s_ring, out, done, N, L, lane, in);
}

// Launches the kernel on a source of [N, L] rows; nothing when N or L
// is 0.
template <class Src, class Out>
cudaError_t launch(Src src, Out out, int N, int L, cudaStream_t stream) {
  if (N < 1 || L < 1) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      compact_kernel<Src, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRingBytes);
  if (rc != cudaSuccess) return rc;
  compact_kernel<Src, Out>
      <<<(L + 31) / 32, kWarps * 32, kRingBytes, stream>>>(src, out, N, L);
  return cudaGetLastError();
}

// ---- the masked walk: destinations read from the offsets ----

// Ring rows of the masked walk at most: 576 x 32 lanes x 6 bytes =
// 110,592 bytes, two blocks an SM.  At W = 1024 (the JAX package's fine
// window) a lane that lags the lead by more than 448 rows stores directly:
// 6.6% of the mixed chunk's events, and 0.57-0.62 ms against 0.65-0.67
// for W + kChunk - 1 = 1,152 rows with none (one block an SM; PERF.md,
// section 6).
constexpr int kMaskedRingMax = 576;
static_assert(kMaskedRingMax % kWarps == 0, "rows fall to warps evenly");

// compact_offsets with a low-bit mask: (p, o) in, the event at
// row - (o & mask) with o_out = o & ~mask there, (0, -1) elsewhere.
struct Masked {
  const int32_t* p;
  const int16_t* o;
  int32_t* p_out;
  int16_t* o_out;
  int mask;       // W - 1 >= 0
  int* direct;    // null, or a count that the lanes' direct stores add to
};

// The ring of the masked walk: rows [done, done + rows) of the tile at
// slots (row - done + at) mod rows, where `at` is done's own slot; an
// event's p (-1: none) and its residual offset.
struct MaskedRing {
  int32_t* p;     // [rows][32]
  int16_t* o;     // [rows][32]
  int rows;
  __device__ __forceinline__ int slot(int r, int done, int at) const {
    const int s = r - done + at;
    return s >= rows ? s - rows : s;
  }
};

// Writes rows [from, to) of a lane (from = done), this warp's share of
// them: the staged event, or else the empty mark.  Rows from + rows and
// past hold nothing staged (the window had not reached them).
template <class M>
__device__ __forceinline__ void write_masked(const MaskedRing& ring,
                                             const M& m, int from, int to,
                                             int at, int L, int lane,
                                             bool in) {
  if (!in) return;
  const int t = threadIdx.x & 31;
  for (int r = from + (threadIdx.x >> 5); r < to; r += kWarps) {
    const size_t out = static_cast<size_t>(r) * L + lane;
    int s = 0;
    int32_t v = -1;
    if (r - from < ring.rows) {
      s = ring.slot(r, from, at) * 32 + t;
      v = ring.p[s];
    }
    if (v >= 0) {
      m.p_out[out] = v;
      m.o_out[out] = ring.o[s];
      ring.p[s] = -1;
    } else {
      m.p_out[out] = 0;
      m.o_out[out] = -1;
    }
  }
}

// A warp's slice of a chunk: each thread's kSlice rows of p and o (-1
// below the last row and on lanes past L).
struct MaskedSlice {
  int32_t e[kSlice];
  int off[kSlice];
  template <class M>
  __device__ __forceinline__ void load(const M& m, int s0, int N, int L,
                                       int lane, bool in) {
    const size_t base = static_cast<size_t>(s0) * L + lane;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const bool row = in && s0 + i < N;
      e[i] = row ? __ldg(m.p + base + static_cast<size_t>(i) * L) : 0;
      off[i] = row ? __ldg(m.o + base + static_cast<size_t>(i) * L) : -1;
    }
  }
};

// blockIdx.x: the tile of lanes [32 x, 32 x + 32); threadIdx.x: lane
// (low 5 bits) and warp.  Dynamic shared memory: the ring, `rows` rows.
// A thread issues its slice of the next chunk before it stages this
// one, so the loads stay in flight across the barriers and the stores.
// A template (M = Masked), so that slots.cu, which includes this header
// and launches no masked walk, does not compile one.
template <class M>
__global__ void __launch_bounds__(kWarps * 32, 2)
masked_kernel(M m, int N, int L, int rows) {
  __shared__ int s_last[kWarps][32];
  extern __shared__ int32_t s_masked[];
  const MaskedRing ring{s_masked,
                        reinterpret_cast<int16_t*>(s_masked + rows * 32),
                        rows};
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lane = blockIdx.x * 32 + t;
  const bool in = lane < L;
  for (int i = threadIdx.x; i < rows * 32; i += kWarps * 32) {
    ring.p[i] = -1;
  }
  int carry = 0;   // the lane's last destination + 1
  int trail = 0;   // the smallest carry of the tile
  int lo = 0;      // the window's first row: the lead < lo + rows
  int done = 0;    // rows below `done` have left the ring (done >= lo)
  int at = 0;      // done's slot
  int n_direct = 0;
  MaskedSlice cur;
  cur.load(m, w * kSlice, N, L, lane, in);
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int s0 = c0 + w * kSlice;
    // a row's destination, or -1: no event (o < 0, or an offset past
    // row 0, which the precondition excludes and the contract drops)
    int last = -1;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      const int dst = s0 + i - (cur.off[i] & m.mask);
      cur.off[i] = cur.off[i] >= 0 && dst >= 0 ? cur.off[i] : -1;
      last = cur.off[i] >= 0 ? dst : last;
    }
    s_last[w][t] = last;
    MaskedSlice next;
    next.load(m, s0 + kChunk, N, L, lane, in);
    __syncthreads();
    int chunk_last = -1;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      chunk_last = max(chunk_last, s_last[k][t]);
    }
    // every warp holds the same values.  The chunk's stores must fit
    // below lo + rows, and rows below the trail take no more stores: both
    // leave the ring before anything of this chunk is staged
    const int lead = __reduce_max_sync(0xffffffffu, in ? chunk_last : -1);
    lo = max(lo, lead + 1 - rows);
    const int upto = max(lo, trail);
    if (upto > done) {
      write_masked(ring, m, done, upto, at, L, lane, in);
      at = (at + (upto - done)) % rows;
      done = upto;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      if (cur.off[i] >= 0) {
        const int dst = s0 + i - (cur.off[i] & m.mask);
        const int16_t res = static_cast<int16_t>(cur.off[i] & ~m.mask);
        if (dst >= done) {   // >= lo: carried destinations never fall
          const int s = ring.slot(dst, done, at) * 32 + t;
          ring.p[s] = cur.e[i];
          ring.o[s] = res;
        } else {                  // a lane far behind the tile's lead
          const size_t out = static_cast<size_t>(dst) * L + lane;
          m.p_out[out] = cur.e[i];
          m.o_out[out] = res;
          ++n_direct;
        }
      }
    }
    carry = max(carry, chunk_last + 1);
    trail = __reduce_min_sync(0xffffffffu, in ? carry : INT_MAX);
    cur = next;
  }
  __syncthreads();   // the chunk's staged events are in the ring
  write_masked(ring, m, done, N, at, L, lane, in);
  if (m.direct != nullptr) {
    const int n = __reduce_add_sync(0xffffffffu, n_direct);
    if (t == 0 && n > 0) atomicAdd(m.direct, n);
  }
}

// The ring rows of a masked walk with mask W - 1 over N rows: W + kChunk
// - 1 (no lane left behind), at most N (no row comes back) and at most
// kMaskedRingMax, rounded up to whole warps.
inline int masked_ring_rows(int mask, int N) {
  long long want = static_cast<long long>(mask) + kChunk;
  if (want > N) want = N;
  if (want > kMaskedRingMax) want = kMaskedRingMax;
  return static_cast<int>((want + kWarps - 1) / kWarps * kWarps);
}

// Launches the masked walk on (p, o) [N, L]; nothing when N or L is 0.
template <class M>
cudaError_t launch_masked(const M& m, int N, int L, cudaStream_t stream) {
  if (N < 1 || L < 1) return cudaSuccess;
  const int rows = masked_ring_rows(m.mask, N);
  const size_t smem = static_cast<size_t>(rows) * 32 *
                      (sizeof(int32_t) + sizeof(int16_t));
  const cudaError_t rc = cudaFuncSetAttribute(
      masked_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  masked_kernel<M>
      <<<(L + 31) / 32, kWarps * 32, smem, stream>>>(m, N, L, rows);
  return cudaGetLastError();
}

}  // namespace compact

}  // namespace
