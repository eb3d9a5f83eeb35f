// The pixel arithmetic of the two pixel-stage kernels, csrc/pixels.cu
// (4:4:4) and csrc/planes.cu (every subsampled geometry): one copy of
// the reference's integer IDCT and of both colour modes.
//
// rowpass / colpass: the two passes of the reference's fixed-point IDCT
// (cpp-decoder/src/idct.cpp:33-133; ops/idct.py), row pass >> 8, column
// pass >> 14 with a clip to [-256, 255].  Integer adds, multiplies and
// left shifts run in uint32_t (the int32 wraparound of the reference)
// and are cast to int32_t for each arithmetic right shift (`sra`).
//
// color<kExact>: YCbCr -> RGB of one pixel from centred int samples.
// f32 mode: __fmul_rn/__fadd_rn/__fsub_rn keep g = (y - k1*b - k2*r) *
// inv uncontracted, with the f32 constants of ops/color.py
// KERNEL_CONSTS, like color.color_core, and flag a value within EPS of
// an integer (`channel`).  Exact mode: the reference's mixed precision
// (oracle.decoder.ycbcr_to_rgb_exact) with __dmul_rn/__dadd_rn/__dsub_rn/
// __ddiv_rn/__double2float_rn/__fadd_rn, like color.color_exact; no
// flags.  `a` is any kernel's argument struct with members f
// (ColorConsts) and d (ExactConsts).  The library is built with
// -fmad=false as well.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t C1 = 2841, C2 = 2676, C3 = 2408, C5 = 1609, C6 = 1108,
                   C7 = 565;

// natural position p -> zigzag index (constants.ZIGZAG_TO_NATURAL)
__constant__ uint8_t kZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

struct ColorConsts {
  float red, blue, gy_b, gy_r, gy_inv, eps;
};

struct ExactConsts {
  double red, blue, gy_b, gy_r, gy_div;
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

// +128 in f32, truncation, clamp to [0, 255]
__device__ __forceinline__ int to_byte(float v) {
  const int i = static_cast<int>(truncf(__fadd_rn(v, 128.0f)));
  return i < 0 ? 0 : (i > 255 ? 255 : i);
}

// f32 mode, one channel: flags a value within EPS of an integer
__device__ __forceinline__ int channel(float v, float eps, bool* risky) {
  const float shifted = __fadd_rn(v, 128.0f);
  const float dist = fabsf(__fsub_rn(shifted, rintf(shifted)));
  if (dist < eps) *risky = true;
  const int i = static_cast<int>(truncf(shifted));
  return i < 0 ? 0 : (i > 255 ? 255 : i);
}

template <bool kExact, class A>
__device__ __forceinline__ void color(int32_t y, int32_t cb, int32_t cr,
                                      const A& a, int rgb[3],
                                      bool* risky) {
  if (kExact) {
    const ExactConsts& d = a.d;
    const double yd = static_cast<double>(y);
    const float r32 = __double2float_rn(
        __dadd_rn(__dmul_rn(d.red, static_cast<double>(cr)), yd));
    const float b32 = __double2float_rn(
        __dadd_rn(__dmul_rn(d.blue, static_cast<double>(cb)), yd));
    const float g32 = __double2float_rn(__ddiv_rn(
        __dsub_rn(__dsub_rn(yd, __dmul_rn(d.gy_b, static_cast<double>(b32))),
                  __dmul_rn(d.gy_r, static_cast<double>(r32))),
        d.gy_div));
    rgb[0] = to_byte(r32);
    rgb[1] = to_byte(g32);
    rgb[2] = to_byte(b32);
  } else {
    const ColorConsts& f = a.f;
    const float yf = static_cast<float>(y);
    const float rf = __fadd_rn(__fmul_rn(f.red, static_cast<float>(cr)), yf);
    const float bf = __fadd_rn(__fmul_rn(f.blue, static_cast<float>(cb)), yf);
    const float gf = __fmul_rn(
        __fsub_rn(__fsub_rn(yf, __fmul_rn(f.gy_b, bf)), __fmul_rn(f.gy_r, rf)),
        f.gy_inv);
    rgb[0] = channel(rf, f.eps, risky);
    rgb[1] = channel(gf, f.eps, risky);
    rgb[2] = channel(bf, f.eps, risky);
  }
}

}  // namespace
