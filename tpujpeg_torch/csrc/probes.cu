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
// overlaps, so its time is steps x (load latency + three integer ops).
//
// Design:
//   * gather_rows: one block per table row; the row's T entries are staged
//     in shared memory once, then each thread takes indices j, j + 256,
//     ... of the row (coalesced index reads and output writes, random
//     shared-memory reads).
//   * gather_table: every block stages the whole table in shared memory
//     and walks the indices with a grid stride.
//   * chain: one block; thread 0 walks the chain.  Three compile-time
//     variants read the table from L2 (ld.global.cg, which bypasses L1),
//     from shared memory (all threads of the block stage it first), and
//     through the read-only cache path (ld.global.nc, the load the scan
//     kernel uses for its symbol table), so a tool can print the time per
//     dependent step of each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 12288;  // int32 entries that fit 48 KB of shared

__global__ void gather_rows_kernel(const int32_t* __restrict__ t,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int T, int K) {
  extern __shared__ int32_t row[];
  const int r = blockIdx.x;
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    row[j] = t[static_cast<size_t>(r) * T + j];
  }
  __syncthreads();
  const int32_t* ir = idx + static_cast<size_t>(r) * K;
  int32_t* orow = out + static_cast<size_t>(r) * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    orow[j] = row[__ldg(ir + j)];
  }
}

__global__ void gather_table_kernel(const int32_t* __restrict__ t,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int T,
                                    int N) {
  extern __shared__ int32_t tab[];
  for (int j = threadIdx.x; j < T; j += blockDim.x) tab[j] = t[j];
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < N; j += stride) {
    out[j] = tab[__ldg(idx + j)];
  }
}

enum ChainSource { kL2 = 0, kShared = 1, kReadOnly = 2 };

template <int kSource>
__global__ void chain_kernel(const int32_t* __restrict__ t,
                             const int32_t* __restrict__ seed,
                             int32_t* __restrict__ out, int T, int steps) {
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
    idx = (v * 7 + 1) % T;
  }
  out[0] = idx;
}

}  // namespace

// t int32 [R, T], idx int32 [R, K] (values in [0, T)) -> out int32 [R, K],
// out[r, j] = t[r, idx[r, j]].  T <= 12288.
extern "C" int tpj_gather_rows(const int32_t* t, const int32_t* idx,
                               int32_t* out, int R, int T, int K,
                               cudaStream_t stream) {
  if (T > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0 || K == 0) return static_cast<int>(cudaGetLastError());
  gather_rows_kernel<<<R, kThreads, T * sizeof(int32_t), stream>>>(
      t, idx, out, T, K);
  return static_cast<int>(cudaGetLastError());
}

// t int32 [T], idx int32 [N] (values in [0, T)) -> out int32 [N],
// out[j] = t[idx[j]].  T <= 12288.
extern "C" int tpj_gather_table(const int32_t* t, const int32_t* idx,
                                int32_t* out, int T, int N,
                                cudaStream_t stream) {
  if (T > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const int want = (N + kThreads - 1) / kThreads;
  const int blocks = want < 1056 ? want : 1056;  // 8 blocks per SM
  gather_table_kernel<<<blocks, kThreads, T * sizeof(int32_t), stream>>>(
      t, idx, out, T, N);
  return static_cast<int>(cudaGetLastError());
}

// t int32 [T] (values >= 0, small enough that v * 7 + 1 fits int32), seed
// int32 [1] in [0, T) -> out int32 [1]: `steps` dependent lookups
// idx = (t[idx] * 7 + 1) % T.  source: 0 = L2, 1 = shared memory
// (T <= 12288), 2 = the read-only cache path.
extern "C" int tpj_chain(const int32_t* t, const int32_t* seed,
                         int32_t* out, int T, int steps, int source,
                         cudaStream_t stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (source == kShared) {
    if (T > kMaxTable) return static_cast<int>(cudaErrorInvalidValue);
    chain_kernel<kShared><<<1, kThreads, T * sizeof(int32_t), stream>>>(
        t, seed, out, T, steps);
  } else if (source == kL2) {
    chain_kernel<kL2><<<1, 32, 0, stream>>>(t, seed, out, T, steps);
  } else if (source == kReadOnly) {
    chain_kernel<kReadOnly><<<1, 32, 0, stream>>>(t, seed, out, T, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
