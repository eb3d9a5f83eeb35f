// Fused 4:4:4 pixel stage (kernel 3 of tpujpeg_torch): zigzag int16
// coefficients where the chain leaves them -> raster RGB.  Dequant, DC
// substitution, the two-pass integer IDCT, YCbCr -> RGB, and the crop to
// the image; in the f32 mode also the exactness-risk flags, packed.
//
// Replaces: tpujpeg/ops/pixels_pallas.py::_pixel_kernel
// (pixels_pallas.py:84) together with the torch prologue and epilogue
// that surrounded its first port (assembly gather, SoA permute and
// padding, unpack, block -> raster transpose, mask packing).  Contract:
// tpujpeg_torch/ops/pixels.py::rgb_444_plain.
//
// Inputs.  A lane table int32 [T, 4] of (image b, first MCU m0, MCU
// count n, src): table entry t holds MCUs m0 .. m0+n-1 (raster order) of
// image b, consecutive in one run of coefficients; b < 0 marks an unused
// entry, src < 0 a run of zero coefficients (padding images).  Two
// coefficient layouts, one compile-time variant each:
//   * kLane, the chains' dense lane matrix int16 [max_blk*64, L]: the
//     run is lane `src`, block j of it at rows j*64 .. j*64+63, the lane
//     axis fastest; resolved DC dc int32 [L, dc_lane] at src*dc_lane + j;
//   * kBlk, int16 [B, n_blocks, 64]: the run starts at block `src` of
//     the flattened block axis; DC at dc[src + j] ([B, n_blocks]).
// dc may be null: DC is then the coefficient row itself.  ext (int32
// [B, 2], true (mcus_y, mcus_x)), when given, zeroes DC outside each
// image's extent (the bucket-raster chain's padding).
//
// Outputs: rgb uint8 [B, 3, H, W] and, in the f32 mode, risk uint8
// [B, H, ceil(W/8)] (bit x%8 of byte x/8, LSB first; bits past W clear).
// Every MCU of [H, W] must be covered by the table.
//
// What bounds it on Hopper: memory.  Per MCU it reads 192 int16
// coefficients and 3 DC words (396 B) and writes 192 bytes, against ~3,000
// integer operations and ~30 f32 or ~30 f64 operations per pixel row.
//
// Design: a block holds 32 table entries ("lanes") x kSlots MCUs and 256
// threads.  Per MCU slot the block stages its 32 MCUs' coefficients in
// shared memory with whole-sector reads: in kLane a warp reads one
// coefficient row of 32 neighbouring lanes (64 contiguous bytes), in kBlk
// each lane's 192 coefficients are 384 contiguous bytes read as 16-byte
// vectors.  Thread (lane, rr) then dequantizes row rr of each component,
// substitutes DC and runs the row pass into shared memory; after one
// barrier the same thread takes column cc = rr, runs the column pass and
// the colour of its 8 pixels, and leaves bytes in a raster tile.  At the
// end the tile goes out as whole pixel rows: kSlots*8 bytes of each lane,
// channel and pixel row (8-byte stores when W % 8 == 0, else bytes).
//
// Bit-exactness: the IDCT passes and both colour modes are
// csrc/pixel_math.cuh (shared with the subsampled kernel csrc/planes.cu),
// which says how each keeps the bits of its plain version: uint32_t
// wraparound with an arithmetic shift per int32 shift, uncontracted f32
// colour with the constants of ops/color.py KERNEL_CONSTS, and the
// reference's mixed-precision exact colour.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_math.cuh"

namespace {

constexpr int kLanes = 32;             // table entries per block
constexpr int kSlots = 4;              // MCUs per lane per block
constexpr int kThreads = 8 * kLanes;   // (lane, block row)
constexpr int kCoefRow = kLanes + 2;   // staged int16 row (bank spread)
constexpr int kTileRow = kSlots * 8 + 4;  // raster tile bytes per lane row

struct Args {
  const int16_t* coef;
  const int32_t* quant;   // [B, 3, 64] zigzag
  const int32_t* dc;      // null: DC from the coefficient row
  const int4* lanes;      // [T] (b, m0, n, src)
  const int32_t* ext;     // null, or [B, 2] true (mcus_y, mcus_x)
  uint8_t* rgb;           // [B, 3, H, W]
  uint8_t* risk;          // [B, H, RW] (f32 mode)
  int T, L, dc_lane, H, W, RW, mcus_x;
  ColorConsts f;
  ExactConsts d;
};

// shared memory of one block (dynamic: above the 48 KB static limit)
struct Smem {
  int16_t coef[192][kCoefRow];            // one slot's coefficients
  int32_t rows[3][8][8][kLanes];          // row-pass results
  uint8_t tile[4][8][kLanes][kTileRow];   // R, G, B, risk by pixel row
  int4 lane[kLanes];
};

template <bool kLane, bool kExact>
__global__ void __launch_bounds__(kThreads)
pixels_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int li = t & (kLanes - 1);   // lane of the compute passes
  const int rr = t / kLanes;         // block row, then column
  const int lane0 = blockIdx.x * kLanes;
  const int slot0 = blockIdx.y * kSlots;

  if (t < kLanes) {
    int4 e = make_int4(-1, 0, 0, -1);
    if (lane0 + t < a.T) e = a.lanes[lane0 + t];
    if (e.x >= 0 && e.z <= slot0) e.x = -1;   // nothing in this block
    sm.lane[t] = e;
  }
  if (!__syncthreads_or(t < kLanes && sm.lane[t].x >= 0)) return;

  const int4 me = sm.lane[li];
  // quant of this thread's row: q[c][k] for natural (rr, k)
  uint32_t q[3][8];
  {
    const int32_t* qb = a.quant + static_cast<size_t>(me.x < 0 ? 0 : me.x) * 192;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        q[c][k] = static_cast<uint32_t>(__ldg(qb + c * 64 + kZigzag[8 * rr + k]));
  }

  for (int s = 0; s < kSlots; ++s) {
    const int slot = slot0 + s;
    // ---- stage this slot's coefficients: sm.coef[c*64 + z][lane]
    if (kLane) {
      const int4 e = sm.lane[li];
      const bool live = e.x >= 0 && slot < e.z && e.w >= 0;
      const int16_t* src = a.coef + static_cast<size_t>(live ? e.w : 0) +
                           static_cast<size_t>(slot) * 192 * a.L;
#pragma unroll 8
      for (int r = rr; r < 192; r += 8)
        sm.coef[r][li] = live ? src[static_cast<size_t>(r) * a.L] : int16_t(0);
    } else {
      const int l = t >> 3;     // lane whose coefficients this thread reads
      const int part = t & 7;   // 24 of its 192 coefficients
      const int4 e = sm.lane[l];
      const bool live = e.x >= 0 && slot < e.z && e.w >= 0;
      int4 v[3] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0),
                   make_int4(0, 0, 0, 0)};
      if (live) {
        const int4* src = reinterpret_cast<const int4*>(
            a.coef + (static_cast<size_t>(e.w) + static_cast<size_t>(slot) * 3) * 64 +
            part * 24);
#pragma unroll
        for (int i = 0; i < 3; ++i) v[i] = __ldg(src + i);
      }
      const int16_t* h = reinterpret_cast<const int16_t*>(v);
#pragma unroll
      for (int i = 0; i < 24; ++i) sm.coef[part * 24 + i][l] = h[i];
    }
    __syncthreads();

    // ---- row pass: thread (li, rr), every component
    const int4 e = sm.lane[li];
    const bool live = e.x >= 0 && slot < e.z;
    if (live) {
      for (int c = 0; c < 3; ++c) {
        uint32_t x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          x[k] = static_cast<uint32_t>(
                     static_cast<int32_t>(sm.coef[c * 64 + kZigzag[8 * rr + k]][li])) *
                 q[c][k];
        if (rr == 0) {
          int32_t d = 0;
          if (e.w >= 0) {
            const int blk = slot * 3 + c;
            if (a.dc == nullptr) {
              d = sm.coef[c * 64][li];
            } else if (kLane) {
              d = __ldg(a.dc + static_cast<size_t>(e.w) * a.dc_lane + blk);
            } else {
              d = __ldg(a.dc + static_cast<size_t>(e.w) + blk);
            }
            if (a.ext != nullptr) {
              const int m = e.y + slot;
              const int my = m / a.mcus_x, mx = m - my * a.mcus_x;
              if (my >= __ldg(a.ext + 2 * e.x) || mx >= __ldg(a.ext + 2 * e.x + 1))
                d = 0;
            }
          }
          x[0] = static_cast<uint32_t>(d) * q[c][0];
        }
        int32_t r[8];
        rowpass(x, r);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) sm.rows[c][rr][cc][li] = r[cc];
      }
    }
    __syncthreads();

    // ---- column pass and colour: thread (li, column rr)
    if (live) {
      const int col = rr;
      int32_t pix[3][8];
      for (int c = 0; c < 3; ++c) {
        uint32_t z[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) z[j] = static_cast<uint32_t>(sm.rows[c][j][col][li]);
        colpass(z, pix[c]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int rgb[3];
        bool risky = false;
        color<kExact>(pix[0][j], pix[1][j], pix[2][j], a, rgb, &risky);
        uint8_t* px = &sm.tile[0][j][li][s * 8 + col];
        px[0] = static_cast<uint8_t>(rgb[0]);
        px[8 * kLanes * kTileRow] = static_cast<uint8_t>(rgb[1]);
        px[16 * kLanes * kTileRow] = static_cast<uint8_t>(rgb[2]);
        if (!kExact) px[24 * kLanes * kTileRow] = risky ? 1 : 0;
      }
    }
    // the next slot's staging writes sm.coef only; its row pass writes
    // sm.rows after the staging barrier, when every column pass is done
  }
  __syncthreads();

  // ---- write the tile as raster rows: segment (ch, j, lane, slot)
  const bool vec = (a.W & 7) == 0;
  for (int idx = t; idx < 3 * 8 * kLanes * kSlots; idx += kThreads) {
    const int s = idx % kSlots;
    const int l = (idx / kSlots) % kLanes;
    const int j = (idx / (kSlots * kLanes)) % 8;
    const int ch = idx / (kSlots * kLanes * 8);
    const int4 e = sm.lane[l];
    const int slot = slot0 + s;
    if (e.x < 0 || slot >= e.z) continue;
    const int m = e.y + slot;
    const int my = m / a.mcus_x, mx = m - my * a.mcus_x;
    const int y = my * 8 + j, x0 = mx * 8;
    if (y >= a.H || x0 >= a.W) continue;
    const uint8_t* src = &sm.tile[ch][j][l][s * 8];
    uint8_t* dst = a.rgb + ((static_cast<size_t>(e.x) * 3 + ch) * a.H + y) *
                               static_cast<size_t>(a.W) + x0;
    if (vec) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(src);
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      const int n = min(8, a.W - x0);
      for (int i = 0; i < n; ++i) dst[i] = src[i];
    }
  }
  if (!kExact) {
    for (int idx = t; idx < 8 * kLanes * kSlots; idx += kThreads) {
      const int s = idx % kSlots;
      const int l = (idx / kSlots) % kLanes;
      const int j = idx / (kSlots * kLanes);
      const int4 e = sm.lane[l];
      const int slot = slot0 + s;
      if (e.x < 0 || slot >= e.z) continue;
      const int m = e.y + slot;
      const int my = m / a.mcus_x, mx = m - my * a.mcus_x;
      const int y = my * 8 + j, x0 = mx * 8;
      if (y >= a.H || x0 >= a.W) continue;
      const uint8_t* src = &sm.tile[3][j][l][s * 8];
      const int n = min(8, a.W - x0);
      uint32_t bits = 0;
      for (int i = 0; i < n; ++i) bits |= static_cast<uint32_t>(src[i]) << i;
      a.risk[(static_cast<size_t>(e.x) * a.H + y) * a.RW + mx] =
          static_cast<uint8_t>(bits);
    }
  }
}

template <bool kLane, bool kExact>
int launch(const Args& a, int max_n, cudaStream_t stream) {
  const size_t bytes = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      pixels_kernel<kLane, kExact>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.T + kLanes - 1) / kLanes, (max_n + kSlots - 1) / kSlots);
  pixels_kernel<kLane, kExact><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef: int16 lane matrix [*, L] (lane_layout 1) or [B, n_blocks, 64]
// (0); quant int32 [B, 3, 64]; dc int32 or null; lanes int32 [T, 4];
// ext int32 [B, 2] or null; rgb uint8 [B, 3, H, W]; risk uint8
// [B, H, ceil(W/8)] (unused when exact).  max_n: the largest MCU count
// of a table entry.  fconsts: f32 [6] = red, blue, gy_b, gy_r, gy_inv,
// eps; dconsts: f64 [5] = red, blue, gy_b, gy_r, gy_div.
extern "C" int tpj_pixels(const int16_t* coef, const int32_t* quant,
                          const int32_t* dc, const int32_t* lanes,
                          const int32_t* ext, uint8_t* rgb, uint8_t* risk,
                          int T, int max_n, int L, int dc_lane, int H, int W,
                          int mcus_x, int lane_layout, int exact,
                          const float* fconsts, const double* dconsts,
                          cudaStream_t stream) {
  Args a;
  a.coef = coef;
  a.quant = quant;
  a.dc = dc;
  a.lanes = reinterpret_cast<const int4*>(lanes);
  a.ext = ext;
  a.rgb = rgb;
  a.risk = risk;
  a.T = T;
  a.L = L;
  a.dc_lane = dc_lane;
  a.H = H;
  a.W = W;
  a.RW = (W + 7) / 8;
  a.mcus_x = mcus_x;
  a.f = ColorConsts{fconsts[0], fconsts[1], fconsts[2],
                    fconsts[3], fconsts[4], fconsts[5]};
  a.d = ExactConsts{dconsts[0], dconsts[1], dconsts[2], dconsts[3],
                    dconsts[4]};
  if (T <= 0 || max_n <= 0) return 0;
  if (lane_layout) {
    return exact ? launch<true, true>(a, max_n, stream)
                 : launch<true, false>(a, max_n, stream);
  }
  return exact ? launch<false, true>(a, max_n, stream)
               : launch<false, false>(a, max_n, stream);
}
