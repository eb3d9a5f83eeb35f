// Lookup probes (kernels "gather_rows", "gather_table" and "chain" of
// tpujpeg_torch): the measurement kernels of tools/bench_torch_gather.py.
//
// Replace, in tools/bench_gather.py:
//   * gather_rows  — vkernel2 (bench_gather.py:115): per-row gather
//                    out[r, j] = t[r, i[r, j]] with the tables resident in
//                    fast memory (take_along_axis over axis 1);
//   * gather_table — vkernel (bench_gather.py:137): out[j] = t[i[j]] from
//                    one small table resident in fast memory;
//   * chain        — skernel (bench_gather.py:163): a chain of DEPENDENT
//                    lookups idx = (t[idx] * 7 + 1) % T, one scalar walk:
//                    the shape of a serial per-segment decoder, where the
//                    next index needs the previous value.
// Contracts: tpujpeg_torch/ops/probes.py::gather_rows_plain,
// gather_table_plain, chain_plain.
//
// The materialize-stage probes of tools/bench_materialize2.py
// (compact_fine_only, compact_only, spread_only) need no kernel of their
// own: they are compact_offsets with a mask and spread_full (routes.cu).
//
// What bounds them on Hopper: the two gathers move 4 bytes in and 4 bytes
// out per lookup and are bound by device memory; the table reads stay in
// shared memory.  The chain is bound by the latency of one load: nothing
// overlaps, so its time is steps x (load latency + the step's integer
// ops): a latency floor, not a byte bound.
//
// Design of the two gathers: a lookup's bytes are its index and its
// output, so both kernels stream those as 16-byte vectors (int4: four
// lookups) with every index load of a pass issued before the first table
// read, and stage the table with cp.async so that the staging round trip
// overlaps the first pass's index round trip.  The grid comes from the
// device's SM count, in Python (ops/probes.py: gather_rows_geometry,
// gather_table_blocks), and the blocks walk their work with a stride.
// Vector parts are counted from the output, which the wrapper allocates
// on 16 bytes: a row (or the flat output) has a scalar head up to its
// first 16-byte boundary, whole vectors, and a scalar tail.  The indices
// load as vectors only when they start on 16 bytes too; an index view
// that starts 4, 8 or 12 bytes into its storage loads the same parts as
// four scalars each.
//   * gather_rows: one row a warp where eight warps' tables fit the 48 KB
//     a block takes without opting in (T <= 1536): the warp stages its row
//     in its own slice of shared memory and synchronises with __syncwarp.
//     Past that, one row a block (__syncthreads).  kRowPass index vectors
//     a thread (32 lookups) are in flight before the wait; a row of 1,024
//     indices is one pass of a warp.
//   * gather_table: every block stages the whole table once, then walks
//     the index vectors with a grid stride, kTablePass vectors a thread
//     (16 lookups) issued before their lookups.  Blocks per SM: 4 (held
//     by __launch_bounds__).  At T = 12,288 a block stages 48 KB, so the
//     grid stages 132 x 4 x 48 KB = 25 MB from L2 however many lookups
//     follow: more blocks per SM would add staging and no bytes in flight
//     (4 x 256 threads x 4 vectors = 64 KB in flight an SM, several times
//     what hides the latency of device memory at 3.35 TB/s), fewer would
//     halve the threads that hide the staging's own latency.  Small N
//     takes fewer blocks, one whole pass a thread.
//   * chain: one block; thread 0 walks the chain.  Three compile-time
//     variants read the table from L2 (ld.global.cg, which bypasses L1),
//     from shared memory (all threads of the block stage it first), and
//     through the read-only cache path (ld.global.nc, the load the scan
//     kernel uses for its symbol table), so a tool can print the time per
//     dependent step of each.  The step's `% T` by a runtime T was a
//     32-bit division of about twenty instructions on the dependent path
//     of every step; it is a mask where T is a power of two (the tool's
//     4,096) and a multiply by a reciprocal fixed per launch elsewhere,
//     the same bits.  Its floor is the walk with no step at all
//     (tpj_chain_floor), read in the same CUDA graph (PERF.md, section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 12288;  // int32 entries that fit 48 KB of shared
constexpr int kWarpRowsMaxTable = kMaxTable / (kThreads / 32);  // 1536
constexpr int kRowPass = 8;    // index vectors a thread loads before a wait
constexpr int kTablePass = 4;  // (gather_table)
// ops/probes.py sizes the grids with copies of kThreads, kTablePass,
// kWarpRowsMaxTable and the 4 blocks an SM of __launch_bounds__;
// tests/test_torch_probes.py holds the copies equal to this source.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying n int32 from src to shared dst, thread `lane` of `width`:
// 16-byte copies where src starts on 16 bytes and n is a multiple of 4
// (dst is then on 16 bytes too), 4-byte copies otherwise.
__device__ __forceinline__ void stage_async(int32_t* dst,
                                            const int32_t* src, int n,
                                            int lane, int width) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int j = 4 * lane; j < n; j += 4 * width) cp_async16(dst + j, src + j);
  } else {
    for (int j = lane; j < n; j += width) cp_async4(dst + j, src + j);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kVecIdx>
__device__ __forceinline__ int4 load4(const int32_t* p) {
  if constexpr (kVecIdx) {
    return __ldg(reinterpret_cast<const int4*>(p));
  } else {
    return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
}

__device__ __forceinline__ int4 look4(const int32_t* tab, const int4& v) {
  return make_int4(tab[v.x], tab[v.y], tab[v.z], tab[v.w]);
}

// One pass of kPass vectors a thread: vector q = base + lane + k * width
// of the nv at iv (indices) and ov (outputs).  Loads first, then lookups.
template <int kPass, bool kVecIdx>
__device__ __forceinline__ void load_pass(int4 (&v)[kPass],
                                          const int32_t* iv, int nv,
                                          int base, int lane, int width) {
#pragma unroll
  for (int k = 0; k < kPass; ++k) {
    const int q = base + lane + k * width;
    if (q < nv) v[k] = load4<kVecIdx>(iv + 4 * static_cast<size_t>(q));
  }
}

template <int kPass>
__device__ __forceinline__ void store_pass(int4* ov, const int32_t* tab,
                                           const int4 (&v)[kPass], int nv,
                                           int base, int lane, int width) {
#pragma unroll
  for (int k = 0; k < kPass; ++k) {
    const int q = base + lane + k * width;
    if (q < nv) ov[q] = look4(tab, v[k]);
  }
}

template <int kGroup>
__device__ __forceinline__ void group_sync() {
  if constexpr (kGroup == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// kGroup threads (a warp, or the block) share one row's table: group g of
// the block takes rows blockIdx.x * groups + g, then every gridDim.x *
// groups-th row.  A row's parts start at element r * K of the output:
// head = (-r * K) mod 4 scalars (at most K), then whole vectors, then the
// tail; head lanes 0-2 and tail lanes 4-6 load their scalar index with
// the first pass.
template <int kGroup, bool kVecIdx>
__global__ void __launch_bounds__(kThreads, 4)
gather_rows_kernel(const int32_t* __restrict__ t,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int R, int T, int K) {
  extern __shared__ int4 smem[];
  constexpr int kGroups = kThreads / kGroup;
  const int g = threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  int32_t* tab = reinterpret_cast<int32_t*>(smem) + g * T;
  for (int r = blockIdx.x * kGroups + g; r < R; r += gridDim.x * kGroups) {
    group_sync<kGroup>();  // the last row's lookups are done: restage
    stage_async(tab, t + static_cast<size_t>(r) * T, T, lane, kGroup);
    const size_t s = static_cast<size_t>(r) * K;
    const int head = min(K, static_cast<int>((4 - (s & 3)) & 3));
    const int nv = (K - head) >> 2;
    const int tail = K - head - 4 * nv;
    const int32_t* ir = idx + s;
    int32_t* orow = out + s;
    const int sj = lane < head                       ? lane
                   : lane >= 4 && lane < 4 + tail ? head + 4 * nv + lane - 4
                                                   : -1;
    const int si = sj >= 0 ? __ldg(ir + sj) : 0;
    int4 v[kRowPass];
    load_pass<kRowPass, kVecIdx>(v, ir + head, nv, 0, lane, kGroup);
    cp_async_wait_all();
    group_sync<kGroup>();
    if (sj >= 0) orow[sj] = tab[si];
    int4* ov = reinterpret_cast<int4*>(orow + head);
    for (int base = 0;;) {
      store_pass<kRowPass>(ov, tab, v, nv, base, lane, kGroup);
      base += kRowPass * kGroup;
      if (base >= nv) break;
      load_pass<kRowPass, kVecIdx>(v, ir + head, nv, base, lane, kGroup);
    }
  }
}

// The flat output's parts: nv vectors, then `tail` scalars that block 0's
// threads [0, tail) take.  Thread i of the grid takes vectors base + i +
// k * (grid threads), k < kTablePass, for base = 0, kTablePass * (grid
// threads), ...
template <bool kVecIdx>
__global__ void __launch_bounds__(kThreads, 4)
gather_table_kernel(const int32_t* __restrict__ t,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int T, int nv, int tail) {
  extern __shared__ int4 smem[];
  int32_t* tab = reinterpret_cast<int32_t*>(smem);
  stage_async(tab, t, T, threadIdx.x, kThreads);
  const int width = gridDim.x * kThreads;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool scalar = blockIdx.x == 0 && threadIdx.x < tail;
  const size_t sj = 4 * static_cast<size_t>(nv) + threadIdx.x;
  const int si = scalar ? __ldg(idx + sj) : 0;
  int4 v[kTablePass];
  load_pass<kTablePass, kVecIdx>(v, idx, nv, 0, lane, width);
  cp_async_wait_all();
  __syncthreads();
  if (scalar) out[sj] = tab[si];
  int4* ov = reinterpret_cast<int4*>(out);
  for (int base = 0;;) {
    store_pass<kTablePass>(ov, tab, v, nv, base, lane, width);
    base += kTablePass * width;
    if (base >= nv) break;
    load_pass<kTablePass, kVecIdx>(v, idx, nv, base, lane, width);
  }
}

enum ChainSource { kL2 = 0, kShared = 1, kReadOnly = 2 };

// The step after each load: the contract's (v * 7 + 1) % T by a mask (T a
// power of two) or by a reciprocal fixed per launch; or none, idx = v, the
// latency floor that tools/bench_torch_gather.py reads on a table that is
// one permutation cycle (entry tpj_chain_floor, outside the port's API).
enum ChainStep { kMask = 0, kReciprocal = 1, kFloor = 2 };

// a % T for 0 <= a < 2^31 and 1 <= T < 2^31, with l = ceil(log2 T) and
// magic = ceil(2^(31 + l) / T) (< 2^32; ops/probes.chain_reciprocal):
// floor(a / T) = (a * magic) >> (31 + l), exact for every such a because
// magic * T - 2^(31 + l) < T <= 2^l (Granlund and Montgomery, 1994,
// theorem 4.2 with N = 31).  2a fits 32 bits, so one multiply-high
// gives (2a * magic) >> 32 = (a * magic) >> 31.  Four dependent integer
// operations where the division by a runtime T took about twenty.
__device__ __forceinline__ int mod_reciprocal(int a, int T, unsigned magic,
                                              int l) {
  const unsigned q = __umulhi(2u * static_cast<unsigned>(a), magic) >> l;
  return a - static_cast<int>(q) * T;
}

template <int kSource, int kStep>
__global__ void chain_kernel(const int32_t* __restrict__ t,
                             const int32_t* __restrict__ seed,
                             int32_t* __restrict__ out, int T, int steps,
                             unsigned magic, int l) {
  extern __shared__ int32_t tab[];
  if (kSource == kShared) {
    for (int j = threadIdx.x; j < T; j += blockDim.x) tab[j] = t[j];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int idx = seed[0];
  for (int s = 0; s < steps; ++s) {
    int v;
    if (kSource == kShared) {
      v = tab[idx];
    } else if (kSource == kL2) {
      v = __ldcg(t + idx);
    } else {
      v = __ldg(t + idx);
    }
    if (kStep == kFloor) {
      idx = v;
    } else if (kStep == kMask) {
      idx = (v * 7 + 1) & (T - 1);
    } else {
      idx = mod_reciprocal(v * 7 + 1, T, magic, l);
    }
  }
  out[0] = idx;
}

template <int kStep>
cudaError_t launch_chain(const int32_t* t, const int32_t* seed, int32_t* out,
                         int T, int steps, int source, unsigned magic, int l,
                         cudaStream_t stream) {
  if (source == kShared) {
    if (T > kMaxTable) return cudaErrorInvalidValue;
    chain_kernel<kShared, kStep><<<1, kThreads, T * sizeof(int32_t), stream>>>(
        t, seed, out, T, steps, magic, l);
  } else if (source == kL2) {
    chain_kernel<kL2, kStep><<<1, 32, 0, stream>>>(t, seed, out, T, steps,
                                                   magic, l);
  } else if (source == kReadOnly) {
    chain_kernel<kReadOnly, kStep><<<1, 32, 0, stream>>>(t, seed, out, T,
                                                         steps, magic, l);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

namespace {

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kGroup>
cudaError_t launch_rows(const int32_t* t, const int32_t* idx, int32_t* out,
                        int R, int T, int K, int blocks, bool vec_idx,
                        cudaStream_t stream) {
  const size_t smem = (kThreads / kGroup) * T * sizeof(int32_t);
  if (vec_idx) {
    gather_rows_kernel<kGroup, true><<<blocks, kThreads, smem, stream>>>(
        t, idx, out, R, T, K);
  } else {
    gather_rows_kernel<kGroup, false><<<blocks, kThreads, smem, stream>>>(
        t, idx, out, R, T, K);
  }
  return cudaGetLastError();
}

}  // namespace

// t int32 [R, T], idx int32 [R, K] (values in [0, T)) -> out int32 [R, K],
// out[r, j] = t[r, idx[r, j]].  T <= 12288.  `blocks` blocks of 256
// threads walk the rows, `group` threads a row (32 where T <= 1536, or
// 256): ops/probes.gather_rows_geometry.  out must start on 16 bytes.
extern "C" int tpj_gather_rows(const int32_t* t, const int32_t* idx,
                               int32_t* out, int R, int T, int K, int blocks,
                               int group, cudaStream_t stream) {
  if (T > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_idx = aligned16(idx);
  if (group == 32 && T <= kWarpRowsMaxTable) {
    return static_cast<int>(
        launch_rows<32>(t, idx, out, R, T, K, blocks, vec_idx, stream));
  }
  if (group == kThreads) {
    return static_cast<int>(
        launch_rows<kThreads>(t, idx, out, R, T, K, blocks, vec_idx, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// t int32 [T], idx int32 [N] (values in [0, T)) -> out int32 [N],
// out[j] = t[idx[j]].  T <= 12288.  `blocks` blocks of 256 threads
// (ops/probes.gather_table_blocks).  out must start on 16 bytes.
extern "C" int tpj_gather_table(const int32_t* t, const int32_t* idx,
                                int32_t* out, int T, int N, int blocks,
                                cudaStream_t stream) {
  if (T > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  if (blocks < 1 || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vectors = N / 4, tail = N % 4;
  const size_t smem = T * sizeof(int32_t);
  if (aligned16(idx)) {
    gather_table_kernel<true><<<blocks, kThreads, smem, stream>>>(
        t, idx, out, T, vectors, tail);
  } else {
    gather_table_kernel<false><<<blocks, kThreads, smem, stream>>>(
        t, idx, out, T, vectors, tail);
  }
  return static_cast<int>(cudaGetLastError());
}

// t int32 [T] (values >= 0, small enough that v * 7 + 1 fits int32), seed
// int32 [1] in [0, T) -> out int32 [1]: `steps` dependent lookups
// idx = (t[idx] * 7 + 1) % T.  source: 0 = L2, 1 = shared memory
// (T <= 12288), 2 = the read-only cache path.  magic == 0: T is a power
// of two and the step masks; else (magic, l) = ops/probes.chain_reciprocal
// (T) and the step multiplies by the reciprocal.
extern "C" int tpj_chain(const int32_t* t, const int32_t* seed,
                         int32_t* out, int T, int steps, int source,
                         unsigned magic, int l, cudaStream_t stream) {
  if (T < 1 || l < 0 || l > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (magic == 0) {
    if (T & (T - 1)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_chain<kMask>(t, seed, out, T, steps, source, 0, 0, stream));
  }
  return static_cast<int>(launch_chain<kReciprocal>(t, seed, out, T, steps,
                                                    source, magic, l, stream));
}

// The latency floor of tpj_chain: the same walk and launch with the step
// taken out, idx = t[idx] (t a permutation of [0, T) for a walk of one
// cycle).  Measurement only (tools/bench_torch_gather.py): no wrapper, no
// launch count.
extern "C" int tpj_chain_floor(const int32_t* t, const int32_t* seed,
                               int32_t* out, int T, int steps, int source,
                               cudaStream_t stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_chain<kFloor>(t, seed, out, T, steps, source, 0, 0, stream));
}
