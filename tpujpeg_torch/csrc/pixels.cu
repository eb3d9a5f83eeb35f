// Fused pixel stage for 4:4:4 MCU planes (kernel 3 of tpujpeg_torch):
// dequant, DC substitution, two-pass integer IDCT, f32 YCbCr -> RGB, the
// exactness-risk flag, and the packing rg = r | g<<8, bk = b | risky<<8.
//
// Replaces: tpujpeg/ops/pixels_pallas.py::_pixel_kernel
// (pixels_pallas.py:84).  Contract:
// tpujpeg_torch/ops/pixels.py::rgb_soa_fused_plain.
//
// What bounds it on Hopper: memory.  Per MCU it reads 3 x 64 int16
// coefficients (384 B) and writes 2 x 64 int16 (256 B), against ~3,000
// integer and ~300 f32 operations — far below the card's
// operations-per-byte balance point.
//
// Design: a block holds 32 MCUs of one image and 256 threads, one per
// (MCU, block row rr).  Each thread reads its row of each component's
// k-major planes (coalesced: the 32 threads of a warp are 32 neighbouring
// MCUs), dequantizes, substitutes DC, runs the row pass, and leaves the
// result in shared memory (24 KB).  After one barrier the same thread
// takes column cc = rr of each component, runs the column pass, and
// converts its 8 pixels to RGB.  No intermediate touches device memory.
//
// Bit-exactness: integer adds, multiplies and left shifts run in uint32_t
// (the int32 wraparound of the reference; signed overflow is undefined in
// C++) and are cast to int32_t for each arithmetic right shift.  The
// colour math uses __fmul_rn/__fadd_rn/__fsub_rn so no FMA contraction
// changes g = (y - k1*b - k2*r) * inv, and truncf/rintf (half-even)/fabsf
// for trunc/round/abs.  The f32 constants come from the caller
// (ops/color.py KERNEL_CONSTS), the same values the plain version uses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t C1 = 2841, C2 = 2676, C3 = 2408, C5 = 1609, C6 = 1108,
                   C7 = 565;
constexpr int kMcus = 32;  // MCUs per block

struct ColorConsts {
  float red, blue, gy_b, gy_r, gy_inv, eps;
};

__device__ __forceinline__ int32_t sra(uint32_t v, int s) {
  return static_cast<int32_t>(v) >> s;
}

__device__ __forceinline__ void rowpass(const uint32_t in[8], int32_t out[8]) {
  // argument order of ops/idct.py: (c0, c4, c6, c2, c1, c7, c5, c3)
  uint32_t x0 = in[0], x1 = in[4], x2 = in[6], x3 = in[2];
  uint32_t x4 = in[1], x5 = in[7], x6 = in[5], x7 = in[3];
  x0 = (x0 << 11) + 128u;
  x1 = x1 << 11;
  uint32_t x8 = C7 * (x4 + x5);
  x4 = x8 + (C1 - C7) * x4;
  x5 = x8 - (C1 + C7) * x5;
  x8 = C3 * (x6 + x7);
  x6 = x8 - (C3 - C5) * x6;
  x7 = x8 - (C3 + C5) * x7;
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = C6 * (x3 + x2);
  x2 = x1 - (C2 + C6) * x2;
  x3 = x1 + (C2 - C6) * x3;
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = static_cast<uint32_t>(sra(181u * (x4 + x5) + 128u, 8));
  x4 = static_cast<uint32_t>(sra(181u * (x4 - x5) + 128u, 8));
  out[0] = sra(x7 + x1, 8);
  out[1] = sra(x3 + x2, 8);
  out[2] = sra(x0 + x4, 8);
  out[3] = sra(x8 + x6, 8);
  out[4] = sra(x8 - x6, 8);
  out[5] = sra(x0 - x4, 8);
  out[6] = sra(x3 - x2, 8);
  out[7] = sra(x7 - x1, 8);
}

__device__ __forceinline__ int32_t clip256(int32_t v) {
  return v < -256 ? -256 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ void colpass(const uint32_t in[8], int32_t out[8]) {
  uint32_t x0 = in[0], x1 = in[4], x2 = in[6], x3 = in[2];
  uint32_t x4 = in[1], x5 = in[7], x6 = in[5], x7 = in[3];
  x0 = (x0 << 8) + 8192u;
  x1 = x1 << 8;
  uint32_t x8 = C7 * (x4 + x5) + 4u;
  x4 = static_cast<uint32_t>(sra(x8 + (C1 - C7) * x4, 3));
  x5 = static_cast<uint32_t>(sra(x8 - (C1 + C7) * x5, 3));
  x8 = C3 * (x6 + x7) + 4u;
  x6 = static_cast<uint32_t>(sra(x8 - (C3 - C5) * x6, 3));
  x7 = static_cast<uint32_t>(sra(x8 - (C3 + C5) * x7, 3));
  x8 = x0 + x1;
  x0 = x0 - x1;
  x1 = C6 * (x3 + x2) + 4u;
  x2 = static_cast<uint32_t>(sra(x1 - (C2 + C6) * x2, 3));
  x3 = static_cast<uint32_t>(sra(x1 + (C2 - C6) * x3, 3));
  x1 = x4 + x6;
  x4 = x4 - x6;
  x6 = x5 + x7;
  x5 = x5 - x7;
  x7 = x8 + x3;
  x8 = x8 - x3;
  x3 = x0 + x2;
  x0 = x0 - x2;
  x2 = static_cast<uint32_t>(sra(181u * (x4 + x5) + 128u, 8));
  x4 = static_cast<uint32_t>(sra(181u * (x4 - x5) + 128u, 8));
  out[0] = clip256(sra(x7 + x1, 14));
  out[1] = clip256(sra(x3 + x2, 14));
  out[2] = clip256(sra(x0 + x4, 14));
  out[3] = clip256(sra(x8 + x6, 14));
  out[4] = clip256(sra(x8 - x6, 14));
  out[5] = clip256(sra(x0 - x4, 14));
  out[6] = clip256(sra(x3 - x2, 14));
  out[7] = clip256(sra(x7 - x1, 14));
}

// One channel: (clipped truncation in [0, 255], within EPS of an integer)
__device__ __forceinline__ int channel(float v, float eps, bool* risky) {
  const float shifted = __fadd_rn(v, 128.0f);
  const float t = truncf(shifted);
  const float dist = fabsf(__fsub_rn(shifted, rintf(shifted)));
  if (dist < eps) *risky = true;
  const int i = static_cast<int>(t);
  return i < 0 ? 0 : (i > 255 ? 255 : i);
}

__global__ void __launch_bounds__(256)
pixels_kernel(const int16_t* __restrict__ zp, const int32_t* __restrict__ quant,
              const int32_t* __restrict__ dc, int16_t* __restrict__ rg,
              int16_t* __restrict__ bk, int P, ColorConsts cc_) {
  // [component][row rr][column cc][MCU in block]
  __shared__ int32_t rows[3][8][8][kMcus];
  const int ml = threadIdx.x & (kMcus - 1);
  const int rr = threadIdx.x / kMcus;     // block row (row pass), then
                                          // column (column pass)
  const int b = blockIdx.y;
  const int m = blockIdx.x * kMcus + ml;
  const int16_t* zb = zp + static_cast<size_t>(b) * 3 * 64 * P;
  const int32_t* qb = quant + static_cast<size_t>(b) * 3 * 64;
  const int32_t* db = dc + static_cast<size_t>(b) * 3 * P;

  for (int c = 0; c < 3; ++c) {
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // k-major: plane row 8k+rr holds natural coefficient (rr, k)
      const int row = 8 * k + rr;
      const int32_t coef = zb[static_cast<size_t>(c * 64 + row) * P + m];
      x[k] = static_cast<uint32_t>(coef) *
             static_cast<uint32_t>(__ldg(qb + c * 64 + row));
    }
    if (rr == 0) {
      // resolved DC replaces the dense tensor's DC row
      x[0] = static_cast<uint32_t>(db[static_cast<size_t>(c) * P + m]) *
             static_cast<uint32_t>(__ldg(qb + c * 64));
    }
    int32_t r[8];
    rowpass(x, r);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) rows[c][rr][cc][ml] = r[cc];
  }
  __syncthreads();

  const int col = rr;
  int32_t pix[3][8];
  for (int c = 0; c < 3; ++c) {
    uint32_t z[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j] = static_cast<uint32_t>(rows[c][j][col][ml]);
    colpass(z, pix[c]);
  }
  int16_t* rgb_ = rg + static_cast<size_t>(b) * 64 * P;
  int16_t* bkb = bk + static_cast<size_t>(b) * 64 * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float yf = static_cast<float>(pix[0][j]);
    const float cbf = static_cast<float>(pix[1][j]);
    const float crf = static_cast<float>(pix[2][j]);
    const float rf = __fadd_rn(__fmul_rn(cc_.red, crf), yf);
    const float bf = __fadd_rn(__fmul_rn(cc_.blue, cbf), yf);
    const float gf = __fmul_rn(
        __fsub_rn(__fsub_rn(yf, __fmul_rn(cc_.gy_b, bf)),
                  __fmul_rn(cc_.gy_r, rf)),
        cc_.gy_inv);
    bool risky = false;
    const int R = channel(rf, cc_.eps, &risky);
    const int G = channel(gf, cc_.eps, &risky);
    const int B = channel(bf, cc_.eps, &risky);
    const size_t o = static_cast<size_t>(8 * j + col) * P + m;
    rgb_[o] = static_cast<int16_t>(static_cast<uint16_t>(R | (G << 8)));
    bkb[o] = static_cast<int16_t>(
        static_cast<uint16_t>(B | (risky ? 1 << 8 : 0)));
  }
}

}  // namespace

// zp int16 [B, 3, 64, P] k-major, quant int32 [B, 3, 64], dc int32
// [B, 3, P]; rg/bk int16 [B, 64, P].  P must be a multiple of 32.
// consts_host: f32 [6] = red, blue, gy_b, gy_r, gy_inv, eps.
extern "C" int tpj_pixels(const int16_t* zp, const int32_t* quant,
                          const int32_t* dc, int16_t* rg, int16_t* bk, int B,
                          int P, const float* consts_host,
                          cudaStream_t stream) {
  ColorConsts c{consts_host[0], consts_host[1], consts_host[2],
                consts_host[3], consts_host[4], consts_host[5]};
  dim3 grid(P / kMcus, B);
  pixels_kernel<<<grid, 8 * kMcus, 0, stream>>>(zp, quant, dc, rg, bk, P, c);
  return static_cast<int>(cudaGetLastError());
}
