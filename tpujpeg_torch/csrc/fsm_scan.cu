// Huffman symbol FSM scan (kernel 1 of tpujpeg_torch).
//
// Replaces: tpujpeg/ops/fsm.py::_fsm_scan (an XLA lax.scan on the TPU)
// in its five uses: restart lanes, restart lanes with bucket-raster
// emission (pad_info), the speculative count pass (start state +
// chunk-end stop), the stitch pass, and the cold pass that logs
// block-boundary anchors.  Contract: tpujpeg_torch/ops/fsm.py::
// _scan_plain (fsm_scan_plain / fsm_scan_spec_plain).
//
// What bounds it on Hopper: latency, not bytes or operations.  A lane is
// a serial chain (every symbol step needs the previous step's bit
// position), so one thread per lane is the decomposition, and a
// production chunk's 5-16k lanes are only 160-500 warps, each alone on
// its scheduler: nothing hides a load's or an instruction's latency.
// All warps run at once, so the kernel takes the time of its slowest
// warp: (columns of the longest lane) x (what one column costs a warp).
// Only the second factor can shrink.  What the design does about it:
//
//  - A symbol step without a branch.  The 32 lanes of a warp are each in
//    another state (DC or AC, mid-block or at a block end, stalled or
//    done), so a warp walks every side of every branch anyway and pays
//    for the divergence on top.  The step computes every outcome as
//    predicates and selects; all its bit fields (the peek, the magnitude,
//    the trailing EOB and size-0 DC codes) are shifts of one register
//    that holds the buffered bits left-aligned, padded with ones.
//  - The Huffman tables in shared memory, exact.  ops/fsm.py::scan_table
//    packs the four tables into a first level indexed by the top 10 bits
//    of the 16-bit peek and 64-entry second-level tables for the codes
//    longer than 10 bits (about 19 KB for the usual tables; every entry
//    is the flat per-peek map's entry, with length + size packed beside
//    it).  A step costs one shared load, two for a long code.
//  - Bytes through shared memory.  A warp stages tiles of its 32 rows x
//    kTile bytes with 16-byte cp.async copies that are contiguous along
//    each row, two stages deep, so the next tile arrives while this one
//    is decoded.  Rows sit at a pitch of kTile + 16 bytes and a lane
//    reads its row 16 bytes at a time, which is free of bank conflicts
//    (an odd number of 16-byte units between neighbouring lanes).  A
//    column prefix of a wider matrix (the stitch window) is staged in
//    place; a row start or pitch that is only 4-byte aligned takes 4-byte
//    copies.
//
// Every step slot is stored (a full 128-byte line per warp and slot, off
// the chain) and every warp walks all columns.  Filling the planes first
// and storing only real events, leaving the loop when a warp's lanes are
// all done, and ending a column at a step that found too few bits were
// all measured on this card and lost or changed nothing: the longest
// lane's warp sets the time, and a divergent exit costs the other lanes
// of the warp more than the skipped work saves (PERF.md).
//
// The modes are compile-time variants of one kernel: kSpec adds the bit
// position, the per-lane start state (a partial first byte), the
// chunk-end stop and the final state; kAnchors adds the anchor logs and
// turns error latches into recoveries; kPad (restart lanes of a
// size-class bucket chunk) adds two counters per lane: an event's block
// field becomes the output position that skips `skip` slots after every
// `wrap_at` completed blocks (one padded MCU row of the bucket grid),
// while quotas and latches go on counting real blocks.  The restart
// variant compiles none of that.
//
// Multi-byte columns (kBpc = 2..4, restart and pad modes; the JAX scan's
// steps spec (bpc, K)): a column is kBpc bytes, each refilled on its own
// and followed by its share of the column's K step slots, front-loaded
// (K / kBpc, one more for the first K % kBpc bytes); rows are padded with
// zero bytes to whole columns, and those bytes are refilled as data.  The
// kernel still walks one byte column at a time: only the refill's bound,
// a zero for a pad byte, the steps after each byte and the running slot
// offset change, and each is a compile-time no-op at kBpc = 1, so the
// production (1, K) variant is the code it was.
//
// Bit-exactness with the JAX scan: the buffer is uint32_t and every read
// of it lies below `navail`, so the bits are those of the JAX int32
// arithmetic shifts; every shift amount stays in [0, 31].

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFlushCols = 6;   // ops/fsm.py FLUSH_COLS
constexpr int kMaxBpm = 16;
constexpr int kWarp = 32;
constexpr int kTile = 128;            // staged bytes per row and tile
constexpr int kPitch = kTile + 16;    // shared row pitch: 9 x 16 bytes
constexpr int kStageBytes = kWarp * kPitch;
constexpr int kL1Words = 4 << 10;     // ops/fsm.py scan_table first level

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stage tile `tile` of the warp's 32 rows: bytes [tile * kTile, + kTile)
// of each row that lie below n_read (n_data rounded up to whole words).
// Eight consecutive threads copy one row's 128 bytes, so a warp's copy
// instruction covers four rows of contiguous 128-byte runs.
__device__ __forceinline__ void stage_tile(uint8_t* stage,
                                           const uint8_t* xs, int pitch,
                                           int n_read, int lane0, int L,
                                           int tile, bool aligned16) {
  constexpr int kChunks = kTile / 16;
  for (int id = threadIdx.x; id < kWarp * kChunks; id += kWarp) {
    const int r = id / kChunks;
    const int col0 = tile * kTile + (id % kChunks) * 16;
    if (col0 >= n_read) continue;
    const uint8_t* src =
        xs + static_cast<size_t>(min(lane0 + r, L - 1)) * pitch + col0;
    uint8_t* dst = stage + r * kPitch + (id % kChunks) * 16;
    if (aligned16 && col0 + 16 <= n_read) {
      cp_async16(dst, src);
    } else {
      for (int b = 0; b < 16 && col0 + b < n_read; b += 4) {
        cp_async4(dst + b, src + b);
      }
    }
  }
}

template <bool kSpec, bool kAnchors, bool kPad, int kBpc>
__global__ void __launch_bounds__(kWarp)
fsm_scan_kernel(const uint8_t* __restrict__ xs, int pitch, int n_data,
                const int32_t* __restrict__ seg_n,
                const uint32_t* __restrict__ table, int table_words,
                ScanMeta meta, SpecIo io,
                const int32_t* __restrict__ pad_wrap,
                const int32_t* __restrict__ pad_skip,
                int32_t* __restrict__ events,
                uint8_t* __restrict__ err_mal_out,
                uint8_t* __restrict__ err_env_out, int L, int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* stages = smem + static_cast<size_t>(table_words) * 4;

  const int lane0 = blockIdx.x * kWarp;
  const int lane = lane0 + threadIdx.x;
  const bool in_range = lane < L;
  const int row_id = min(lane, L - 1);
  // byte columns refilled (the data, padded to whole columns) and walked
  const int n_refill = kBpc == 1 ? n_data : (n_data + kBpc - 1) / kBpc * kBpc;
  const int n_cols = n_refill + kFlushCols * kBpc;
  // multi-byte: the steps after each byte of a column
  const int k_base = K / kBpc, k_extra = K % kBpc;

  // the tables: one 16-byte copy per thread and turn
  for (int i = threadIdx.x * 4; i < table_words; i += kWarp * 4) {
    *reinterpret_cast<uint4*>(tab + i) =
        __ldg(reinterpret_cast<const uint4*>(table + i));
  }

  const int quota = seg_n[row_id];
  uint32_t buf = 0;
  int navail = 0, k = 0, blk = 0, bim = 0;
  bool done = quota == 0, err_mal = false, err_env = false;
  // speculative state (dead in the restart variant)
  int sbits = 0, cbits = INT_MAX, bitpos = 0, end_bits = 0, end_bim = 0;
  int rec = -1, rec_pend = -1;
  if (kSpec) {
    if (io.start_bits != nullptr) sbits = io.start_bits[row_id];
    if (io.start_bim != nullptr) bim = io.start_bim[row_id];
    if (io.chunk_bits != nullptr) cbits = io.chunk_bits[row_id];
    bitpos = sbits;
    end_bim = bim;
  }
  // bucket-raster output counters (dead outside the pad variant)
  int wrap_at = 1, skip_n = 0, ocol = 0, oblk = 0;
  if (kPad) {
    wrap_at = pad_wrap[row_id];
    skip_n = pad_skip[row_id];
  }

  // running output offset of this lane's step slot 0 of the column (a
  // thread past the last lane rewrites lane L - 1's slots with the same
  // values)
  const size_t col_step = static_cast<size_t>(K) * L;
  size_t out_col = row_id;
  size_t out_run = row_id;   // multi-byte: the next step slot's offset

  const int n_read = (n_data + 3) & ~3;
  const bool aligned16 =
      (reinterpret_cast<uintptr_t>(xs) & 15) == 0 && (pitch & 15) == 0;
  stage_tile(stages, xs, pitch, n_read, lane0, L, 0, aligned16);
  cp_async_commit();
  __syncwarp();

  const int n_tiles = (n_cols + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the next tile travels while this one is decoded
    stage_tile(stages + ((tile + 1) & 1) * kStageBytes, xs, pitch, n_read,
               lane0, L, tile + 1, aligned16);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const uint8_t* my_row =
        stages + (tile & 1) * kStageBytes + threadIdx.x * kPitch;
    uint4 q = make_uint4(0, 0, 0, 0);
    uint32_t word = 0;
    const int c_end = min(kTile, n_cols - tile * kTile);
    for (int c = 0; c < c_end; ++c, out_col += col_step) {
      const int col = tile * kTile + c;
      if ((c & 3) == 0) {
        if ((c & 15) == 0) {
          q = *reinterpret_cast<const uint4*>(my_row + c);
        } else {
          q.x = q.y;
          q.y = q.z;
          q.z = q.w;
        }
        word = q.x;
      }
      uint32_t byte = word & 0xFFu;
      word >>= 8;
      if (kBpc > 1 && col >= n_data) byte = 0;   // a pad byte of a column
      // ---- refill one byte (none in the flush tail)
      if (col < n_refill && !done && !err_mal && !err_env) {
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
      size_t out = kBpc == 1 ? out_col : out_run;
      const int n_steps =
          kBpc == 1 ? K : k_base + (col % kBpc < k_extra ? 1 : 0);
#pragma unroll 1
      for (int s = 0; s < n_steps; ++s, out += L) {
        // One symbol step without a branch: every lane of the warp is in
        // another state, so the warp would walk every side of a branch
        // anyway.  `top` holds the buffered bits left-aligned, padded
        // with ones past the end; every field of the step is a shift of
        // it by the bits used so far.
        const bool act = !done && !err_mal && !err_env;
        const uint32_t top =
            __funnelshift_lc(0xFFFFFFFFu, buf, 32 - navail);
        const uint32_t peek = top >> 16;
        const bool is_dc = k == 0;
        const uint32_t tsel = (meta.tsel_mask >> bim) & 1u;
        const uint32_t tbl = is_dc ? tsel : tsel + 2u;
        uint32_t e = tab[(tbl << 10) | (peek >> 6)];
        if (e >> 31) e = tab[(e & 0xFFFFu) + (peek & 63u)];
        const int sym = e & 0xFF;
        const int length = (e >> 8) & 31;
        const int need = (e >> 13) & 31;    // length + size
        const int size = sym & 15;
        const int run = sym >> 4;
        const bool valid = length <= 16;
        const bool complete = act & valid & (navail >= need);
        // an invalid code only counts once 16 real bits are buffered
        const bool bad_code = act & !valid & (navail >= 16);
        // magnitude bits + EXTEND (size 0: mag 0, unused)
        const int mag =
            static_cast<int>(((top << (length & 31)) >> 1) >> (31 - size));
        const int val = mag + (mag < ((1 << size) >> 1) ? 1 - (1 << size) : 0);
        const int z = is_dc ? 0 : k + run;
        const bool bad_z = complete & (z > 63);   // index overrun (AC only)
        const bool emit = complete & (size > 0) & !bad_z;
        const int32_t ev =
            emit ? ((kPad ? oblk : blk) << 18) | (z << 12) | (val + 2048)
                 : -1;
        const int k2 = is_dc ? 1 : (sym == 0 ? 64 : z + 1);
        int used = complete ? need : 0;
        // trailing EOB of this table set
        const int el = tsel ? meta.eob_len1 : meta.eob_len0;
        const uint32_t ec = tsel ? meta.eob_code1 : meta.eob_code0;
        const bool eob_fire =
            complete & (k2 < 64) & (el > 0) & (navail - need >= el) &
            (((top << (need & 31)) >> ((32 - el) & 31)) == ec);
        used += eob_fire ? el : 0;
        const bool block_end = (complete & (k2 >= 64)) | eob_fire;
        blk += block_end;
        if (kPad) {
          // after wrap_at blocks of a row, jump the bucket's padding
          ocol += block_end;
          const bool wrapped = ocol >= wrap_at;
          oblk += block_end ? (wrapped ? skip_n + 1 : 1) : 0;
          ocol = wrapped ? 0 : ocol;
        }
        const int bim1 = bim + 1 == meta.bpm ? 0 : bim + 1;
        bim = block_end ? bim1 : bim;
        bool stop = block_end & (blk >= quota);
        if (kSpec) stop |= block_end & (bitpos + used >= cbits);
        // trailing size-0 DC of the next block
        const uint32_t ts2 = (meta.tsel_mask >> bim) & 1u;
        const int dl = ts2 ? meta.dc0_len1 : meta.dc0_len0;
        const uint32_t dcode = ts2 ? meta.dc0_code1 : meta.dc0_code0;
        const bool dc0_fire =
            block_end & !stop & (dl > 0) & (navail - used >= dl) &
            (((top << min(used, 31)) >> ((32 - dl) & 31)) == dcode);
        if (kSpec) {
          bitpos += used;
          if (stop) {
            end_bits = bitpos;
            end_bim = bim;
          }
          bitpos += dc0_fire ? dl : 0;
        }
        int32_t anc = -1, abk = 0;
        if (kAnchors && block_end) {
          anc = ((bitpos - (dc0_fire ? dl : 0)) << 3) | bim;
          abk = blk;
        }
        used += dc0_fire ? dl : 0;
        navail -= used;
        k = dc0_fire ? 1 : (block_end ? 0 : (complete ? k2 : k));
        done |= stop;
        if (!kAnchors) err_mal |= bad_code | (bad_z & (size > 0));
        if (events != nullptr) events[out] = ev;
        if (kAnchors) {
          // one recovery marker per step slot: a step recovery takes it, a
          // refill recovery waits for the next step without one
          const bool rec_now = bad_code | bad_z;
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
          io.anchors[out] = anc;
          io.ablk[out] = abk;
          io.recm[out] = mark;
        }
      }
      if (kBpc > 1) out_run = out;
    }
    __syncwarp();   // all lanes are off this stage before it is refilled
  }
  cp_async_wait<0>();
  if (!in_range) return;
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

template <bool kSpec, bool kAnchors, bool kPad, int kBpc = 1>
cudaError_t launch_scan(int blocks, size_t smem_bytes, cudaStream_t stream,
                        const uint8_t* xs, int pitch, int n_data,
                        const int32_t* seg_n, const uint32_t* table,
                        int table_words, const ScanMeta& meta,
                        const SpecIo& io, const int32_t* wrap_at,
                        const int32_t* skip, int32_t* events,
                        uint8_t* err_mal, uint8_t* err_env, int L, int K) {
  auto kernel = fsm_scan_kernel<kSpec, kAnchors, kPad, kBpc>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<blocks, kWarp, smem_bytes, stream>>>(
      xs, pitch, n_data, seg_n, table, table_words, meta, io, wrap_at, skip,
      events, err_mal, err_env, L, K);
  return cudaGetLastError();
}

// The restart variants (kSpec, kAnchors off) at bpc bytes a column.
template <bool kPad>
cudaError_t launch_restart(int bpc, int blocks, size_t smem_bytes,
                           cudaStream_t stream, const uint8_t* xs, int pitch,
                           int n_data, const int32_t* seg_n,
                           const uint32_t* table, int table_words,
                           const ScanMeta& meta, const SpecIo& io,
                           const int32_t* wrap_at, const int32_t* skip,
                           int32_t* events, uint8_t* err_mal,
                           uint8_t* err_env, int L, int K) {
  switch (bpc) {
    case 1:
      return launch_scan<false, false, kPad, 1>(
          blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
          table_words, meta, io, wrap_at, skip, events, err_mal, err_env, L,
          K);
    case 2:
      return launch_scan<false, false, kPad, 2>(
          blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
          table_words, meta, io, wrap_at, skip, events, err_mal, err_env, L,
          K);
    case 3:
      return launch_scan<false, false, kPad, 3>(
          blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
          table_words, meta, io, wrap_at, skip, events, err_mal, err_env, L,
          K);
    case 4:
      return launch_scan<false, false, kPad, 4>(
          blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
          table_words, meta, io, wrap_at, skip, events, err_mal, err_env, L,
          K);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// meta_host: int32 [25] = bpm, tsel[16], eob_len[2], eob_code[2],
// dc0_len[2], dc0_code[2] (ops/fsm.py::scan_meta), read on the host.
// table: the packed Huffman tables of ops/fsm.py::scan_table, table_words
// 32-bit words (a multiple of 4, 16-byte aligned), copied to shared
// memory by every block.  xs is [L, pitch] row-major; the scan reads the
// first n_data bytes of each row.  steps: symbol steps a column of bpc
// bytes (1 <= bpc <= steps, bpc <= 4; bpc > 1 in modes 0 and 3 only;
// events then hold ceil(n_data / bpc) + 6 columns).  mode: 0 restart, 1 speculative,
// 2 speculative with anchors, 3 restart with bucket-raster emission
// (start_bits, start_bim, chunk_bits, state may be null in modes 1-2;
// anchors, ablk, recm are used in mode 2 only; wrap_at and skip, int32
// [L], in mode 3 only; events may be null).
extern "C" int tpj_fsm_scan(const uint8_t* xs, const int32_t* seg_n,
                            const uint32_t* table, int table_words,
                            const int32_t* meta_host,
                            int32_t* events, uint8_t* err_mal,
                            uint8_t* err_env, int L, int pitch, int n_data,
                            int steps, int bpc, int mode,
                            const int32_t* start_bits,
                            const int32_t* start_bim,
                            const int32_t* chunk_bits, int32_t* anchors,
                            int32_t* ablk, int32_t* recm, int32_t* state,
                            const int32_t* wrap_at, const int32_t* skip,
                            cudaStream_t stream) {
  if (L < 1 || bpc < 1 || bpc > 4 || steps < bpc ||
      (bpc > 1 && mode != 0 && mode != 3) || table_words < kL1Words ||
      (table_words & 3) || (reinterpret_cast<uintptr_t>(table) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const int blocks = (L + kWarp - 1) / kWarp;
  const size_t smem_bytes =
      static_cast<size_t>(table_words) * 4 + 2 * kStageBytes;
  cudaError_t rc;
  if (mode == 0) {
    rc = launch_restart<false>(
        bpc, blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
        table_words, meta, io, nullptr, nullptr, events, err_mal, err_env, L,
        steps);
  } else if (mode == 1) {
    rc = launch_scan<true, false, false>(
        blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
        table_words, meta, io, nullptr, nullptr, events, err_mal, err_env, L,
        steps);
  } else if (mode == 2) {
    if (anchors == nullptr || ablk == nullptr || recm == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rc = launch_scan<true, true, false>(
        blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
        table_words, meta, io, nullptr, nullptr, events, err_mal, err_env, L,
        steps);
  } else if (mode == 3) {
    if (wrap_at == nullptr || skip == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    rc = launch_restart<true>(
        bpc, blocks, smem_bytes, stream, xs, pitch, n_data, seg_n, table,
        table_words, meta, io, wrap_at, skip, events, err_mal, err_env, L,
        steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}
