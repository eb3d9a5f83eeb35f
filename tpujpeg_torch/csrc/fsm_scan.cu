// Restart-lane Huffman symbol FSM scan (kernel 1 of tpujpeg_torch).
//
// Replaces: tpujpeg/ops/fsm.py::_fsm_scan (an XLA lax.scan on the TPU,
// restart mode).  Contract: tpujpeg_torch/ops/fsm.py::fsm_scan_plain.
//
// What bounds it on Hopper: the scan is a serial chain per lane — every
// symbol step needs the previous step's bit position — so one lane's
// latency (a dependent table load plus ~40 integer ops per step, K steps
// per byte) sets the time, not bandwidth: a production chunk's 10,240
// lanes are only ~320 warps, a few per SM.
//
// Design: one thread per lane, the whole decoder state (bit buffer,
// bits available, in-block position k, block count, MCU phase, done and
// the two error latches) in registers.  (length, symbol) comes from a
// flat int32 LUT [4 tables][65536 peeks] in global memory: one load per
// step, exact by construction, 1 MB that stays resident in the 50 MB L2
// (chosen over a binary search of the ~130-piece list in shared memory,
// which costs eight dependent shared loads and divergent branches per
// step).  Each lane reads its own row of the row-major [L, stride] plan
// matrix four bytes at a time, so no transpose is needed; events are
// written lane-minor to [n_cols, K, L], coalesced across a warp.  The
// bit position is dead state in restart mode and is not kept.
//
// Bit-exactness with the JAX scan: the buffer is uint32_t and every read
// of it is masked below `navail`, so logical shifts give the bits of the
// JAX int32 arithmetic shifts; every shift amount stays in [0, 31].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFlushCols = 6;   // ops/fsm.py FLUSH_COLS
constexpr int kMaxBpm = 16;

// Table constants, all in registers: a runtime index into an array would
// spill the struct to local memory, so the per-block table set is a bit
// mask and each per-set constant a pair selected by the set bit.
struct ScanMeta {
  int bpm;
  uint32_t tsel_mask;     // bit bim = table set (0/1) of MCU block bim
  int eob_len0, eob_len1, eob_code0, eob_code1;
  int dc0_len0, dc0_len1, dc0_code0, dc0_code1;
};

__global__ void fsm_scan_kernel(const uint8_t* __restrict__ xs,
                                const int32_t* __restrict__ seg_n,
                                const int32_t* __restrict__ lut,
                                ScanMeta meta,
                                int32_t* __restrict__ events,
                                uint8_t* __restrict__ err_mal_out,
                                uint8_t* __restrict__ err_env_out,
                                int L, int stride, int K) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint32_t* row =
      reinterpret_cast<const uint32_t*>(xs + static_cast<size_t>(lane) * stride);
  const int n_cols = stride + kFlushCols;
  const int quota = seg_n[lane];

  uint32_t buf = 0;
  uint32_t word = 0;
  int navail = 0, k = 0, blk = 0, bim = 0;
  bool done = quota == 0, err_mal = false, err_env = false;

  for (int col = 0; col < n_cols; ++col) {
    // ---- refill one byte (none in the flush tail)
    if (col < stride) {
      if ((col & 3) == 0) word = __ldg(row + (col >> 2));
      const uint32_t byte = (word >> (8 * (col & 3))) & 0xFFu;
      if (!done && !err_mal && !err_env) {
        if (navail + 8 > 32) {
          err_env = true;  // buffer would overflow: outside the envelope
        } else {
          buf = (buf << 8) | byte;
          navail += 8;
        }
      }
    }
    int32_t* out = events + static_cast<size_t>(col) * K * L + lane;
    for (int s = 0; s < K; ++s) {
      int32_t ev = -1;
      if (!done && !err_mal && !err_env) {
        // peek 16 bits, padding past the end of the buffer with ones
        uint32_t peek;
        if (navail >= 16) {
          peek = (buf >> (navail - 16)) & 0xFFFFu;
        } else {
          const int sb = 16 - navail;
          peek = ((buf << sb) | ((1u << sb) - 1u)) & 0xFFFFu;
        }
        const bool is_dc = k == 0;
        const int tsel = (meta.tsel_mask >> bim) & 1u;
        const int tbl = is_dc ? tsel : tsel + 2;
        const int lv = __ldg(lut + (tbl << 16) + static_cast<int>(peek));
        const int length = lv >> 8;
        const int sym = lv & 0xFF;
        const int size = sym & 15;
        const int run = sym >> 4;
        const int need = length + size;
        if (length > 16) {
          // invalid code; it only counts once 16 real bits are buffered
          if (navail >= 16) err_mal = true;
        } else if (navail >= need) {
          // magnitude bits + EXTEND
          const uint32_t mag = (buf >> (navail - need)) & ((1u << size) - 1u);
          const int half = 1 << (size > 0 ? size - 1 : 0);
          const int val = static_cast<int>(mag) >= half
                              ? static_cast<int>(mag)
                              : static_cast<int>(mag) - 2 * half + 1;
          const bool eob = !is_dc && sym == 0;
          const int z = is_dc ? 0 : k + run;
          if (size > 0) {
            if (!is_dc && z > 63) {
              err_mal = true;  // coefficient index overrun
            } else {
              ev = (blk << 18) | (z << 12) | (val + 2048);
            }
          }
          const int k2 = is_dc ? 1 : (eob ? 64 : z + 1);
          navail -= need;
          // trailing EOB of this table set
          bool eob_fire = false;
          const int el = tsel ? meta.eob_len1 : meta.eob_len0;
          if (k2 < 64 && el > 0 && navail >= el) {
            const uint32_t b = (buf >> (navail - el)) & ((1u << el) - 1u);
            eob_fire = b == static_cast<uint32_t>(tsel ? meta.eob_code1
                                                       : meta.eob_code0);
            if (eob_fire) navail -= el;
          }
          if (k2 >= 64 || eob_fire) {
            // block end
            blk += 1;
            bim = bim + 1 == meta.bpm ? 0 : bim + 1;
            k = 0;
            if (blk >= quota) done = true;
            if (!done) {
              // trailing size-0 DC of the next block
              const int ts2 = (meta.tsel_mask >> bim) & 1u;
              const int dl = ts2 ? meta.dc0_len1 : meta.dc0_len0;
              if (dl > 0 && navail >= dl) {
                const uint32_t b = (buf >> (navail - dl)) & ((1u << dl) - 1u);
                if (b == static_cast<uint32_t>(ts2 ? meta.dc0_code1
                                                   : meta.dc0_code0)) {
                  navail -= dl;
                  k = 1;
                }
              }
            }
          } else {
            k = k2;
          }
        }
      }
      out[static_cast<size_t>(s) * L] = ev;
    }
  }
  // a lane undone at the end is truncated, or starved of symbol steps
  // with whole bytes still buffered (an envelope condition)
  const bool undone = !done;
  const bool starved = undone && navail >= 8;
  err_mal_out[lane] = (err_mal || (undone && !starved)) ? 1 : 0;
  err_env_out[lane] = (err_env || starved) ? 1 : 0;
}

}  // namespace

// meta_host: int32 [25] = bpm, tsel[16], eob_len[2], eob_code[2],
// dc0_len[2], dc0_code[2] (ops/fsm.py::scan_meta), read on the host.
extern "C" int tpj_fsm_scan(const uint8_t* xs, const int32_t* seg_n,
                            const int32_t* lut, const int32_t* meta_host,
                            int32_t* events, uint8_t* err_mal,
                            uint8_t* err_env, int L, int stride, int steps,
                            cudaStream_t stream) {
  ScanMeta meta;
  meta.bpm = meta_host[0];
  meta.tsel_mask = 0;
  for (int i = 0; i < kMaxBpm; ++i) {
    meta.tsel_mask |= static_cast<uint32_t>(meta_host[1 + i] & 1) << i;
  }
  meta.eob_len0 = meta_host[17];
  meta.eob_len1 = meta_host[18];
  meta.eob_code0 = meta_host[19];
  meta.eob_code1 = meta_host[20];
  meta.dc0_len0 = meta_host[21];
  meta.dc0_len1 = meta_host[22];
  meta.dc0_code0 = meta_host[23];
  meta.dc0_code1 = meta_host[24];
  // one warp per block spreads the few hundred lane warps over all SMs
  constexpr int kThreads = 32;
  const int blocks = (L + kThreads - 1) / kThreads;
  fsm_scan_kernel<<<blocks, kThreads, 0, stream>>>(
      xs, seg_n, lut, meta, events, err_mal, err_env, L, stride, steps);
  return static_cast<int>(cudaGetLastError());
}
