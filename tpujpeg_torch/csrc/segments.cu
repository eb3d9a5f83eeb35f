// Lockstep-lane Huffman decode of restart segments (the gather backend's
// entropy stage).
//
// Replaces: tpujpeg/ops/entropy.py::decode_segments, two nested XLA
// lax.scan loops over symbol steps (entropy.py:315, :337) and a final
// scatter (:342-346) on the TPU.  Contract: tpujpeg_torch/ops/entropy.py::
// decode_segments_plain.
//
// One thread per lane (one restart segment) walks its segment one Huffman
// symbol per step, resolves EXTEND and the DC DPCM per component, and
// stores each coefficient straight into the zero-filled output; the TPU's
// step-major emit buffers and the scatter after them are not carried over.
//
// What bounds it on Hopper: latency.  Every step needs the previous step's
// bit position, so a lane is a serial chain, and a warp runs as long as
// its deepest lane: the kernel takes (the deepest lane's symbols) x (one
// step of a warp).  What the design does to that step:
//
//  - Compact two-level tables in shared memory.  ops/entropy.py::
//    segment_tables derives them from `luts` on the host, once per table
//    set, and device_luts keeps them beside its tensor: per row a
//    1,024-entry first level keyed on the top 10 bits of the 16-bit
//    peek, and a 64-entry second level for every 10-bit prefix
//    whose 64 peeks do not share one entry (a code longer than 10 bits, or
//    the end of the code space).  Exact by construction.  Entry: luts'
//    (length << 8) | symbol, with length + (symbol & 15) at bit 13; a long
//    prefix is bit 31 | the second level's word offset from the row.  A
//    block stages the rows its lanes use (4.7 KB for each of the usual
//    tables) into 36 KB of shared memory; a row that does not fit stays in
//    global memory (an L2 round trip a symbol).  Each lane holds a generic
//    pointer per (component, DC/AC): one kernel, per-lane tables.
//  - The bits in a register.  A left-aligned 64-bit buffer holds the
//    stream from the bit position on, refilled a 32-bit word at a time
//    when fewer than 32 bits remain; three words wait behind it, the last
//    loaded by the step before, so no load sits on the chain.  The peek,
//    the code length and the magnitude are shifts of that buffer.
//  - An int32 step of predicates and selects: DC/AC, the refill and the
//    stores.  The table for the next step is one select (the AC table of
//    this block, or the DC table of the next one, both in registers; only
//    their reload from shared memory at a block's end may branch); the DC
//    predictors live in shared memory, unsigned so that a wrap is defined,
//    as int32 in JAX.  A lane leaves its loop when it is done.
//  - Lanes a block (one warp): ceil(L / SMs), 1 to 32.  A warp issues
//    every instruction any of its lanes needs, so a lane alone in its warp
//    steps fastest (NVIDIA H100 80GB HBM3, 700.00 W, through decode_plan
//    with its table lookup: 32.0-32.4 ms against 47.7 with 32 lanes a
//    warp on a chunk of 128 lanes), while with 10,240 lanes 32 a warp
//    read faster than 20 (1.74-1.92 ms against 2.01-2.13).
//
// Error edges, bit for bit with the JAX function: the peek's byte index
// is clamped at n_bytes - 4 (a lane whose peeks come within 17 bits of
// that point finishes in a second loop that selects the clamped window,
// the last four bytes shifted by the bit position's low three bits); a
// code of length 0 latches err; a lane still undone after n_steps latches
// err; an AC run past z = 63 ends the block without an error and without
// a write; a lane with 0 blocks is born done.  A write outside
// [0, n_coeffs) is dropped.  DC symbols above 15, which the parser
// refuses, lie outside the contract (the magnitude takes symbol & 15).
//
// Bytes are read as aligned words, each of which holds at least one byte
// of the scan (a word past the last is read as the last again); bits past
// n_bytes are never used by an unclamped peek.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;          // one warp a block, one lane a thread
constexpr int kTabWords = 9216;    // shared words for staged rows (36 KB)
constexpr int kSlots = 8;          // (component, DC/AC) tables of a lane
constexpr int kLongMask = 0x7FFFFFFF;

// Per block position: the AC table of its component and the DC table of
// the next position's component (what a lane needs when it enters it).
struct alignas(16) Next {
  const int32_t* ac;
  const int32_t* dc_next;
};

constexpr size_t kSmemFixed =
    kTabWords * 4 + kWarp * kSlots * sizeof(void*) + kWarp * 4 * 4;

// The scan as aligned 32-bit words, as stored.
struct Stream {
  const uint32_t* words;   // from the scan's 4-byte aligned start
  int a;                   // the scan's offset in its first word, bytes
  int last;                // the last word that holds a byte of the scan
  int plim;                // the first bit whose peek JAX clamps
};

__device__ __forceinline__ uint32_t raw_word(const Stream& st, int i) {
  return __ldg(st.words + min(i, st.last));
}

__device__ __forceinline__ uint32_t swap(uint32_t w) {
  return __byte_perm(w, 0u, 0x0123u);
}

struct Lane {
  uint32_t hi, lo;       // the buffer: bits [p, p + nbits), left-aligned
  int nbits, p;
  int wi;                // word index of w0
  uint32_t w0, w1, w2;   // the next three words of the stream, as stored
  const int32_t* tcur;   // this step's table
  const int32_t* tac;    // AC table of this block's component
  const int32_t* tdcn;   // DC table of the next block's component
  int k, bim, comp, left;
  long long ob;          // flat index of this block's coefficient 0
  bool done, err;
};

struct Ctx {
  Stream st;
  uint32_t wlast;        // bytes [n_bytes - 4, n_bytes), big-endian
  uint32_t pmask;        // component of each block position, 2 bits each
  int bpm;
  const Next* ent;       // this lane's entries, [bpm]
  uint32_t* dcp;         // this lane's DC predictors, [4]
  int32_t* coeffs;
  long long n_coeffs;
  bool safe;             // every block of the lane lies in the output
};

template <bool kTail>
__device__ __forceinline__ void step(Lane& s, const Ctx& c) {
  const bool is_dc = s.k == 0;
  uint32_t src = s.hi;
  if (kTail && s.p >= c.st.plim) src = c.wlast << (s.p & 7);
  int e = s.tcur[src >> 22];
  if (e < 0) e = s.tcur[(e & kLongMask) + ((src >> 16) & 63u)];
  const int clen = (e >> 8) & 31;
  const int total = (e >> 13) & 31;   // length + size
  const int sym = e & 0xFF;
  const bool bad = clen == 0;         // no code matches the window
  const int size = total - clen;
  // the magnitude: the `size` bits after the code
  uint32_t msrc = __funnelshift_l(s.lo, s.hi, clen);
  if (kTail) {
    const int p2 = s.p + clen;
    if (p2 >= c.st.plim) msrc = c.wlast << (p2 & 7);
  }
  const int raw = static_cast<int>((msrc >> 1) >> (31 - size));
  const int m = 1 << size;
  const int val = raw + (raw < (m >> 1) ? 1 - m : 0);
  // consume the symbol's bits; refill one word when fewer than 32 remain
  // (then 1..31 are left).  w2 was loaded by the step before: nothing here
  // waits for a load, and this step's load is read by the next.
  s.p += total;
  s.hi = __funnelshift_l(s.lo, s.hi, total);
  s.lo <<= total;
  s.nbits -= total;
  const bool refill = s.nbits < 32;
  const uint32_t wd = swap(s.w0);
  const int sh = s.nbits & 31;
  s.hi |= refill ? wd >> sh : 0u;
  s.lo |= refill ? (wd << 1) << (31 - sh) : 0u;
  s.nbits += refill ? 32 : 0;
  s.wi += refill ? 1 : 0;
  s.w0 = refill ? s.w1 : s.w0;
  s.w1 = refill ? s.w2 : s.w1;
  s.w2 = raw_word(c.st, s.wi + 2);
  // keep the stream 64 bytes ahead in L1
  asm volatile("prefetch.global.L1 [%0];" ::"l"(
      c.st.words + min(s.wi + 16, c.st.last)));
  const int run = is_dc ? 0 : (sym >> 4);
  const int z = s.k + run;
  const bool eob = !is_dc && sym == 0;
  const bool bdone = !is_dc && (sym == 0 || z >= 63);
  int emit = val;
  if (is_dc && !bad) {
    const uint32_t v = c.dcp[s.comp] + static_cast<uint32_t>(val);
    c.dcp[s.comp] = v;
    emit = static_cast<int>(v);
  }
  const long long idx = s.ob + z;
  if (!bad && !eob && z < 64 &&
      (c.safe || static_cast<unsigned long long>(idx) <
                     static_cast<unsigned long long>(c.n_coeffs))) {
    c.coeffs[idx] = emit;
  }
  s.k = bdone ? 0 : z + 1;
  s.left -= bdone ? 1 : 0;
  s.ob += bdone ? 64 : 0;
  s.tcur = bdone ? s.tdcn : s.tac;
  if (bdone) {   // the tables of the next block position
    s.bim = s.bim + 1 == c.bpm ? 0 : s.bim + 1;
    const Next n = c.ent[s.bim];
    s.tac = n.ac;
    s.tdcn = n.dc_next;
    s.comp = (c.pmask >> (2 * s.bim)) & 3u;
  }
  s.err |= bad;
  s.done = bad || s.left <= 0;
}

__global__ void __launch_bounds__(kWarp)
decode_segments_kernel(const uint8_t* __restrict__ scan, long long n_bytes,
                       Stream st, const int32_t* __restrict__ start_bits,
                       const int32_t* __restrict__ block_base,
                       const int32_t* __restrict__ n_blocks,
                       const int32_t* __restrict__ rows, int n_comp,
                       const int32_t* __restrict__ ctab,
                       const int32_t* __restrict__ roff, int n_rows,
                       const int32_t* __restrict__ pattern, int bpm,
                       int n_steps, int32_t* __restrict__ coeffs,
                       long long n_coeffs, uint8_t* __restrict__ err_out,
                       int L, int lanes) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  const int32_t** slot_ptr =
      reinterpret_cast<const int32_t**>(smem + kTabWords * 4);
  uint32_t* dcp = reinterpret_cast<uint32_t*>(
      smem + kTabWords * 4 + kWarp * kSlots * sizeof(void*));
  Next* ent = reinterpret_cast<Next*>(smem + kSmemFixed);

  const int t = threadIdx.x;
  const int lane = blockIdx.x * lanes + t;
  const bool active = t < lanes && lane < L;
  const int n_slots = 2 * n_comp;

  // ---- the rows to stage, one (slot, distinct row) at a time; thread t
  // of the warp holds entry t of the staged list (row, word offset)
  int my_row = -1, my_base = 0;
  int n_staged = 0, used = 0;
  for (int j = 0; j < n_slots; ++j) {
    int r = -1;
    if (active) {
      r = min(max(__ldg(rows + static_cast<size_t>(lane) * n_slots + j), 0),
              n_rows - 1);
    }
    int off = -1;
    unsigned pending = __ballot_sync(~0u, active);
    while (pending != 0u) {
      const int R = __shfl_sync(~0u, r, __ffs(pending) - 1);
      const bool mine = active && r == R;
      pending &= ~__ballot_sync(~0u, mine);
      const unsigned hit = __ballot_sync(~0u, t < n_staged && my_row == R);
      int base = -1;
      if (hit != 0u) {
        base = __shfl_sync(~0u, my_base, __ffs(hit) - 1);
      } else {
        const int words = __ldg(roff + R + 1) - __ldg(roff + R);
        if (n_staged < kWarp && words <= kTabWords - used) {
          if (t == n_staged) {
            my_row = R;
            my_base = used;
          }
          base = used;
          used += words;
          ++n_staged;
        }
      }
      if (mine) off = base;
    }
    if (active) {
      slot_ptr[t * kSlots + j] = off >= 0 ? tab + off : ctab + __ldg(roff + r);
    }
  }
  // ---- copy the staged rows in (16-byte vectors: rows are whole 64-word
  // pieces at 64-word offsets)
  for (int i = 0; i < n_staged; ++i) {
    const int R = __shfl_sync(~0u, my_row, i);
    const int base = __shfl_sync(~0u, my_base, i);
    const int o = __ldg(roff + R);
    const int n_vec = (__ldg(roff + R + 1) - o) / 4;
    const uint4* src = reinterpret_cast<const uint4*>(ctab + o);
    uint4* dst = reinterpret_cast<uint4*>(tab + base);
    for (int v = t; v < n_vec; v += kWarp) dst[v] = __ldg(src + v);
  }
  uint32_t pmask = 0;
  for (int b = 0; b < bpm; ++b) {
    pmask |= static_cast<uint32_t>(min(max(__ldg(pattern + b), 0),
                                       n_comp - 1)) << (2 * b);
  }
  Next* my_ent = ent + t * bpm;
  if (active) {
    for (int b = 0; b < bpm; ++b) {
      const int b1 = b + 1 == bpm ? 0 : b + 1;
      const int c0 = (pmask >> (2 * b)) & 3u, c1 = (pmask >> (2 * b1)) & 3u;
      my_ent[b] = Next{slot_ptr[t * kSlots + 2 * c0 + 1],
                       slot_ptr[t * kSlots + 2 * c1]};
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dcp[t * 4 + i] = 0u;
  }
  __syncwarp();
  if (!active) return;

  // ---- the lane
  Ctx c;
  c.st = st;
  c.wlast = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    c.wlast |= static_cast<uint32_t>(__ldg(scan + (n_bytes - 4 + b)))
               << (24 - 8 * b);
  }
  c.pmask = pmask;
  c.bpm = bpm;
  c.ent = my_ent;
  c.dcp = dcp + t * 4;
  c.coeffs = coeffs;
  c.n_coeffs = n_coeffs;

  const int quota = n_blocks[lane];
  const long long base = block_base[lane];
  c.safe = base >= 0 && (base + max(quota, 1)) * 64 <= n_coeffs;

  Lane s;
  s.p = start_bits[lane];
  const long long P = static_cast<long long>(s.p) + 8 * st.a;
  const int w = static_cast<int>(P >> 5), sh = static_cast<int>(P & 31);
  const uint32_t h0 = swap(raw_word(st, w)), l0 = swap(raw_word(st, w + 1));
  s.hi = __funnelshift_l(l0, h0, sh);
  s.lo = l0 << sh;
  s.nbits = 64 - sh;
  s.wi = w + 2;
  s.w0 = raw_word(st, w + 2);
  s.w1 = raw_word(st, w + 3);
  s.w2 = raw_word(st, w + 4);
  s.tcur = my_ent[bpm - 1].dc_next;
  s.tac = my_ent[0].ac;
  s.tdcn = my_ent[0].dc_next;
  s.k = 0;
  s.bim = 0;
  s.comp = pmask & 3u;
  s.left = quota;
  s.ob = base * 64;
  s.done = quota == 0;
  s.err = false;

  // every peek of a step at p <= plim - 17 lies before the clamp
  const int pfast = st.plim - 17;
  int i = 0;
  for (; i < n_steps && !s.done && s.p <= pfast; ++i) step<false>(s, c);
  for (; i < n_steps && !s.done; ++i) step<true>(s, c);
  err_out[lane] = (s.err || !s.done) ? 1 : 0;
}

}  // namespace

// scan: uint8 [n_bytes] (n_bytes >= 4); start_bits, block_base, n_blocks:
// int32 [L]; rows: int32 [L, n_comp, 2] (n_comp <= 4); ctab, roff: the
// compact tables of ops/entropy.py::segment_tables (int32, ctab 16-byte
// aligned, roff [n_rows + 1]); pattern: int32 [bpm] (bpm <= 16); coeffs:
// int32 [n_coeffs], zero-filled by the caller; err: bool [L].  All on the
// card.
extern "C" int tpj_decode_segments(const uint8_t* scan, long long n_bytes,
                                   const int32_t* start_bits,
                                   const int32_t* block_base,
                                   const int32_t* n_blocks,
                                   const int32_t* rows, int n_comp,
                                   const int32_t* ctab, const int32_t* roff,
                                   int n_rows, const int32_t* pattern,
                                   int bpm, int n_steps, int32_t* coeffs,
                                   long long n_coeffs, uint8_t* err, int L,
                                   cudaStream_t stream) {
  if (L < 1 || n_bytes < 4 || n_comp < 1 || n_comp > 4 || n_rows < 1 ||
      bpm < 1 || bpm > 16 || n_steps < 0 ||
      (reinterpret_cast<uintptr_t>(ctab) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  n_sm = std::max(n_sm, 1);
  const int lanes = std::min(std::max((L + n_sm - 1) / n_sm, 1), kWarp);
  const int blocks = (L + lanes - 1) / lanes;
  const size_t smem = kSmemFixed + static_cast<size_t>(kWarp) * bpm *
                                       sizeof(Next);
  Stream st;
  st.a = static_cast<int>(reinterpret_cast<uintptr_t>(scan) & 3);
  st.words = reinterpret_cast<const uint32_t*>(scan - st.a);
  st.last = static_cast<int>(
      std::min((st.a + n_bytes - 1) >> 2, static_cast<long long>(INT_MAX)));
  st.plim = static_cast<int>(
      std::min(8 * (n_bytes - 3), static_cast<long long>(INT_MAX)));
  decode_segments_kernel<<<blocks, kWarp, smem, stream>>>(
      scan, n_bytes, st, start_bits, block_base, n_blocks, rows, n_comp,
      ctab, roff, n_rows, pattern, bpm, n_steps, coeffs, n_coeffs, err, L,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
