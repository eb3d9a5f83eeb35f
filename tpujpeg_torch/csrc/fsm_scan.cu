// Huffman symbol FSM scan (kernel 1 of tpujpeg_torch).
//
// Replaces: tpujpeg/ops/fsm.py::_fsm_scan (an XLA lax.scan on the TPU)
// in its five uses: restart lanes, restart lanes with bucket-raster
// emission (pad_info), the speculative count pass (start state +
// chunk-end stop), the stitch pass, and the cold pass that logs
// block-boundary anchors.  Contract: tpujpeg_torch/ops/fsm.py::
// _scan_plain (fsm_scan_plain / fsm_scan_spec_plain).
//
// What bounds it on Hopper: the scan is a serial chain per lane — every
// symbol step needs the previous step's bit position — so one lane's
// latency (a dependent table load plus ~40 integer ops per step, K steps
// per byte) sets the time, not bandwidth: a production chunk's ~10-16k
// lanes are only a few hundred warps, a few per SM.
//
// Design: one thread per lane, the whole decoder state (bit buffer,
// bits available, bit position, in-block position k, block count, MCU
// phase, done, the error latches, the recovery markers) in registers.
// (length, symbol) comes from a flat int32 LUT [4 tables][65536 peeks]
// in global memory: one load per step, exact by construction, 1 MB that
// stays resident in the 50 MB L2 (chosen over a binary search of the
// ~130-piece list in shared memory, which costs eight dependent shared
// loads and divergent branches per step).  Each lane reads its own row
// of the row-major [L, pitch] byte matrix four bytes at a time, so no
// transpose is needed and a column prefix (the stitch window) is read in
// place; outputs are written lane-minor to [n_cols, K, L], coalesced
// across a warp.
//
// The modes are compile-time variants of one kernel: kSpec adds the bit
// position, the per-lane start state (a partial first byte), the
// chunk-end stop and the final state; kAnchors adds the anchor logs and
// turns error latches into recoveries; kPad (restart lanes of a
// size-class bucket chunk) adds two counters per lane: an event's block
// field becomes the output position that skips `skip` slots after every
// `wrap_at` completed blocks (one padded MCU row of the bucket grid),
// while quotas and latches go on counting real blocks.  The restart
// variant compiles none of that and keeps its registers for the
// latency-bound chain.
//
// Bit-exactness with the JAX scan: the buffer is uint32_t and every read
// of it is masked below `navail`, so logical shifts give the bits of the
// JAX int32 arithmetic shifts; every shift amount stays in [0, 31].

#include <climits>
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

// Per-lane inputs and outputs of the speculative modes (null = unused).
struct SpecIo {
  const int32_t* start_bits;  // [L] bit offset into the lane's row
  const int32_t* start_bim;   // [L] MCU phase at that offset
  const int32_t* chunk_bits;  // [L] stop at the first block end >= this
  int32_t* anchors;           // [n_cols, K, L] (bitpos << 3) | bim, or -1
  int32_t* ablk;              // [n_cols, K, L] block count at the anchor
  int32_t* recm;              // [n_cols, K, L] recovery marker, or -1
  int32_t* state;             // [4, L] blk, end_bits, end_bim, rec_last
};

template <bool kSpec, bool kAnchors, bool kPad>
__global__ void fsm_scan_kernel(const uint8_t* __restrict__ xs, int pitch,
                                int n_data,
                                const int32_t* __restrict__ seg_n,
                                const int32_t* __restrict__ lut,
                                ScanMeta meta, SpecIo io,
                                const int32_t* __restrict__ pad_wrap,
                                const int32_t* __restrict__ pad_skip,
                                int32_t* __restrict__ events,
                                uint8_t* __restrict__ err_mal_out,
                                uint8_t* __restrict__ err_env_out,
                                int L, int K) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(
      xs + static_cast<size_t>(lane) * pitch);
  const int n_cols = n_data + kFlushCols;
  const int quota = seg_n[lane];

  uint32_t buf = 0;
  uint32_t word = 0;
  int navail = 0, k = 0, blk = 0, bim = 0;
  bool done = quota == 0, err_mal = false, err_env = false;
  // speculative state (dead in the restart variant)
  int sbits = 0, cbits = INT_MAX, bitpos = 0, end_bits = 0, end_bim = 0;
  int rec = -1, rec_pend = -1;
  if (kSpec) {
    if (io.start_bits != nullptr) sbits = io.start_bits[lane];
    if (io.start_bim != nullptr) bim = io.start_bim[lane];
    if (io.chunk_bits != nullptr) cbits = io.chunk_bits[lane];
    bitpos = sbits;
    end_bim = bim;
  }
  // bucket-raster output counters (dead outside the pad variant)
  int wrap_at = 1, skip_n = 0, ocol = 0, oblk = 0;
  if (kPad) {
    wrap_at = pad_wrap[lane];
    skip_n = pad_skip[lane];
  }

  for (int col = 0; col < n_cols; ++col) {
    // ---- refill one byte (none in the flush tail)
    if (col < n_data) {
      if ((col & 3) == 0) word = __ldg(row + (col >> 2));
      const uint32_t byte = (word >> (8 * (col & 3))) & 0xFFu;
      if (!done && !err_mal && !err_env) {
        int take = 8;
        if (kSpec) {
          // speculative entry: the bits before start_bits are skipped,
          // a partial first byte contributes its low bits
          const int skip = min(max(sbits - col * 8, 0), 8);
          take = 8 - skip;
        }
        if (navail + take > 32) {
          if (kAnchors) {
            // recover: drop the backlog, resume at the refill frontier
            bitpos += navail;
            navail = 0;
            k = 0;
            rec = max(rec, bitpos);
            rec_pend = max(rec_pend, bitpos);
          } else {
            err_env = true;  // buffer would overflow: outside the envelope
            take = 0;
          }
        }
        if (take > 0) {
          buf = (buf << take) | (byte & ((1u << take) - 1u));
          navail += take;
        }
      }
    }
    const size_t out0 = static_cast<size_t>(col) * K * L + lane;
    for (int s = 0; s < K; ++s) {
      int32_t ev = -1, anc = -1, abk = 0;
      bool rec_now = false;
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
          if (navail >= 16) {
            if (kAnchors) rec_now = true;
            else err_mal = true;
          }
        } else if (navail >= need) {
          // magnitude bits + EXTEND
          const uint32_t mag = (buf >> (navail - need)) & ((1u << size) - 1u);
          const int half = 1 << (size > 0 ? size - 1 : 0);
          const int val = static_cast<int>(mag) >= half
                              ? static_cast<int>(mag)
                              : static_cast<int>(mag) - 2 * half + 1;
          const bool eob = !is_dc && sym == 0;
          const int z = is_dc ? 0 : k + run;
          const bool bad_z = !is_dc && z > 63;  // coefficient index overrun
          if (size > 0) {
            if (bad_z) {
              if (!kAnchors) err_mal = true;
            } else {
              ev = ((kPad ? oblk : blk) << 18) | (z << 12) | (val + 2048);
            }
          }
          if (kAnchors && bad_z) rec_now = true;
          const int k2 = is_dc ? 1 : (eob ? 64 : z + 1);
          navail -= need;
          if (kSpec) bitpos += need;
          // trailing EOB of this table set
          bool eob_fire = false;
          const int el = tsel ? meta.eob_len1 : meta.eob_len0;
          if (k2 < 64 && el > 0 && navail >= el) {
            const uint32_t b = (buf >> (navail - el)) & ((1u << el) - 1u);
            eob_fire = b == static_cast<uint32_t>(tsel ? meta.eob_code1
                                                       : meta.eob_code0);
            if (eob_fire) {
              navail -= el;
              if (kSpec) bitpos += el;
            }
          }
          if (k2 >= 64 || eob_fire) {
            // block end
            blk += 1;
            if (kPad) {
              // after wrap_at blocks of a row, jump the bucket's padding
              ocol += 1;
              if (ocol >= wrap_at) {
                ocol = 0;
                oblk += skip_n + 1;
              } else {
                oblk += 1;
              }
            }
            bim = bim + 1 == meta.bpm ? 0 : bim + 1;
            k = 0;
            if (kAnchors) {
              anc = (bitpos << 3) | bim;
              abk = blk;
            }
            bool stop = blk >= quota;
            if (kSpec && bitpos >= cbits) stop = true;
            if (stop) {
              done = true;
              if (kSpec) {
                end_bits = bitpos;
                end_bim = bim;
              }
            } else {
              // trailing size-0 DC of the next block
              const int ts2 = (meta.tsel_mask >> bim) & 1u;
              const int dl = ts2 ? meta.dc0_len1 : meta.dc0_len0;
              if (dl > 0 && navail >= dl) {
                const uint32_t b = (buf >> (navail - dl)) & ((1u << dl) - 1u);
                if (b == static_cast<uint32_t>(ts2 ? meta.dc0_code1
                                                   : meta.dc0_code0)) {
                  navail -= dl;
                  if (kSpec) bitpos += dl;
                  k = 1;
                }
              }
            }
          } else {
            k = k2;
          }
        }
      }
      if (events != nullptr) events[out0 + static_cast<size_t>(s) * L] = ev;
      if (kAnchors) {
        // one recovery marker per step slot: a step recovery takes it, a
        // refill recovery waits for the next step without one
        int32_t mark;
        if (rec_now) {
          bitpos += navail;
          navail = 0;
          k = 0;
          rec = max(rec, bitpos);
          mark = bitpos;
        } else {
          mark = rec_pend;
          rec_pend = -1;
        }
        const size_t o = out0 + static_cast<size_t>(s) * L;
        io.anchors[o] = anc;
        io.ablk[o] = abk;
        io.recm[o] = mark;
      }
    }
  }
  // a lane undone at the end is truncated, or starved of symbol steps
  // with whole bytes still buffered (an envelope condition); anchor mode
  // latches nothing
  const bool undone = !done;
  const bool starved = undone && navail >= 8;
  if (kAnchors) {
    err_mal_out[lane] = err_mal ? 1 : 0;
    err_env_out[lane] = err_env ? 1 : 0;
  } else {
    err_mal_out[lane] = (err_mal || (undone && !starved)) ? 1 : 0;
    err_env_out[lane] = (err_env || starved) ? 1 : 0;
  }
  if (kSpec && io.state != nullptr) {
    io.state[lane] = blk;
    io.state[L + lane] = end_bits;
    io.state[2 * L + lane] = end_bim;
    io.state[3 * L + lane] = rec;
  }
}

}  // namespace

// meta_host: int32 [25] = bpm, tsel[16], eob_len[2], eob_code[2],
// dc0_len[2], dc0_code[2] (ops/fsm.py::scan_meta), read on the host.
// xs is [L, pitch] row-major; the scan reads the first n_data bytes of
// each row.  mode: 0 restart, 1 speculative, 2 speculative with anchors,
// 3 restart with bucket-raster emission (start_bits, start_bim,
// chunk_bits, state may be null in modes 1-2; anchors, ablk, recm are used
// in mode 2 only; wrap_at and skip, int32 [L], in mode 3 only; events may
// be null).
extern "C" int tpj_fsm_scan(const uint8_t* xs, const int32_t* seg_n,
                            const int32_t* lut, const int32_t* meta_host,
                            int32_t* events, uint8_t* err_mal,
                            uint8_t* err_env, int L, int pitch, int n_data,
                            int steps, int mode, const int32_t* start_bits,
                            const int32_t* start_bim,
                            const int32_t* chunk_bits, int32_t* anchors,
                            int32_t* ablk, int32_t* recm, int32_t* state,
                            const int32_t* wrap_at, const int32_t* skip,
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
  SpecIo io{start_bits, start_bim, chunk_bits, anchors, ablk, recm, state};
  // one warp per block spreads the few hundred lane warps over all SMs
  constexpr int kThreads = 32;
  const int blocks = (L + kThreads - 1) / kThreads;
  if (mode == 0) {
    fsm_scan_kernel<false, false, false><<<blocks, kThreads, 0, stream>>>(
        xs, pitch, n_data, seg_n, lut, meta, io, nullptr, nullptr, events,
        err_mal, err_env, L, steps);
  } else if (mode == 1) {
    fsm_scan_kernel<true, false, false><<<blocks, kThreads, 0, stream>>>(
        xs, pitch, n_data, seg_n, lut, meta, io, nullptr, nullptr, events,
        err_mal, err_env, L, steps);
  } else if (mode == 2) {
    fsm_scan_kernel<true, true, false><<<blocks, kThreads, 0, stream>>>(
        xs, pitch, n_data, seg_n, lut, meta, io, nullptr, nullptr, events,
        err_mal, err_env, L, steps);
  } else if (mode == 3) {
    if (wrap_at == nullptr || skip == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    fsm_scan_kernel<false, false, true><<<blocks, kThreads, 0, stream>>>(
        xs, pitch, n_data, seg_n, lut, meta, io, wrap_at, skip, events,
        err_mal, err_env, L, steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
