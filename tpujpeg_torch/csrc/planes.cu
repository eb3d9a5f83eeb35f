// Subsampled pixel stage (kernel "planes" of tpujpeg_torch): zigzag
// coefficients of a chunk of one geometry -> raster RGB.  Dequant, DC
// substitution, the integer IDCT, chroma upsampling (libjpeg's fancy
// triangle filter, or box replication) and YCbCr -> RGB at the geometry's
// size; in the f32 mode also the exactness-risk flags, packed.  The
// 4:2:0, 4:2:2, 4:4:0 and 4:1:1 sibling of csrc/pixels.cu.
//
// Replaces no Pallas kernel: the JAX package's plane path is XLA ops
// (tpujpeg/pipeline.py: _idct_planar, upsample_planes, planes_to_rgb).
// Its first port was the same chain in PyTorch ops, ~1,900 launches a
// chunk, whose enqueue held the host for most of a 4:2:0 decode.
// Contract: tpujpeg_torch/pipeline.py's plane path (decode_subsampled_
// planes, upsample_planes, planes_to_rgb), which ops/planes.py runs for
// CPU tensors.
//
// Inputs: coefficients int16 or int32 [B, n_blocks, 64] in scan order
// (MCU-major, the blocks of an MCU component by component, each
// component's v x h blocks row-major), quant int32 [B, n_comp, 64]
// (zigzag), dc int32 [B, n_blocks] or null (DC is then coefficient 0),
// ext int32 [B, 2] or null: each image's true (mcus_y, mcus_x) inside a
// size-class bucket, which moves the fancy filter's bottom and right
// replication edges to the image's real sample extent (the plain path's
// `_edge_next` with true_n).  One or three components; component c has
// factors (h, v) and is upsampled by (fh, fv) = (max_h / h, max_v / v):
// the triangle filter where fancy and both are at most 2, else box.
//
// Outputs: rgb uint8 [B, 3, H, W] (H, W the geometry's size: the
// upsampled planes cropped) and, in the f32 mode, risk uint8
// [B, H, ceil(W/8)] (bit x%8 of byte x/8, LSB first; bits past W clear).
// Scratch: planes int16, each image's component planes at their native
// resolution, centred IDCT output in [-256, 255] (box replication and the
// full-resolution component take it unclamped, as the plain path does).
//
// What bounds it on Hopper: memory.  At 4:2:0 a pixel needs 1.5 int16 or
// int32 coefficients (3 or 6 bytes) read and 3 bytes written, against
// ~20 integer operations per coefficient and ~30 f32 or f64 operations
// per pixel: the ImageNet-like bucket chunk (11 pictures of 544 x 544)
// is ~20 MB in and 10 MB out, ~9 us at 3.35 TB/s.  At these sizes the
// launch, not the card, is the cost the plain path paid.
//
// Design: two kernels, one C entry, one launch from the host a chunk.
//   1. planes_idct_kernel: 256 threads hold 32 blocks; thread (block,
//      row) dequantizes its natural row through the zigzag table, substitutes
//      DC and runs the row pass into shared memory; after a barrier it
//      runs the column pass of column `row`, and after another it stores
//      row `row` of the block, 8 int16 as one 16-byte store, into its
//      component's plane.
//   2. planes_colour_kernel: a thread a group of 8 pixels of one row:
//      each component's upsampled value from the planes (the neighbours the
//      filter reads come from L1 and L2: the planes, 1.5 int16 a pixel,
//      are 10 MB for the bucket chunk, inside the 50 MB L2), the colour of
//      pixel_math.cuh, 8 bytes a channel (one 8-byte store where W % 8 ==
//      0) and one risk byte.
// A single kernel that keeps the samples in shared memory would need the
// chroma halo of the MCU rows above and below and tiling of MCU rows
// wider than shared memory; the planes' round trip through L2 costs
// microseconds against the milliseconds of enqueue it replaces.
//
// Bit-exactness: pixel_math.cuh's IDCT and colour (the 4:4:4 kernel's);
// the filter is integer arithmetic on clamped samples (+128, [0, 255]) in
// ops/upsample.py's order: h2v2 takes the unrounded 3:1 column sums, then
// (3 * a + b + 8 or 7) >> 4; h2v1 and h1v2 (3 * a + b + 1 or 2) >> 2;
// then -128.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_math.cuh"

namespace {

constexpr int kMaxComp = 3;
constexpr int kBlocks = 32;                 // IDCT blocks per thread block
constexpr int kIdctThreads = 8 * kBlocks;   // (block, row)
constexpr int kColourThreads = 256;

struct Comp {
  int h, v;            // sampling factors
  int fh, fv;          // upsampling factors
  int wc, hc;          // plane width and height in samples
  int base;            // first block of the component inside an MCU
  long long off;       // plane offset inside an image's planes (samples)
};

struct Args {
  const void* coef;      // int16 or int32 [B, n_blocks, 64]
  const int32_t* quant;  // [B, n_comp, 64] zigzag
  const int32_t* dc;     // null: DC from coefficient 0
  const int32_t* ext;    // null, or [B, 2] true (mcus_y, mcus_x)
  int16_t* planes;       // [B, per_image]
  uint8_t* rgb;          // [B, 3, H, W]
  uint8_t* risk;         // [B, H, RW] (f32 mode)
  int B, n_comp, n_blocks, bpm, mcus_x, H, W, RW, fancy;
  long long per_image;   // samples of one image's planes
  Comp comp[kMaxComp];
  ColorConsts f;
  ExactConsts d;
};

template <typename T>
__global__ void __launch_bounds__(kIdctThreads)
planes_idct_kernel(const Args a) {
  // +1 column: the row pass's stores and the column pass's loads fall
  // in distinct banks
  __shared__ int32_t rows[kBlocks][8][9];
  __shared__ __align__(16) int16_t out[kBlocks][8][8];
  const int t = threadIdx.x;
  const int lb = t >> 3;   // block of this thread block
  const int r = t & 7;     // its row, then its column
  const long long g = static_cast<long long>(blockIdx.x) * kBlocks + lb;
  const bool live = g < static_cast<long long>(a.B) * a.n_blocks;
  int b = 0, c = 0, k = 0;
  if (live) {
    b = static_cast<int>(g / a.n_blocks);
    k = static_cast<int>(g - static_cast<long long>(b) * a.n_blocks);
    const int j = k % a.bpm;
    while (c + 1 < a.n_comp && j >= a.comp[c + 1].base) ++c;
    const T* src = static_cast<const T*>(a.coef) + g * 64;
    const int32_t* q = a.quant + (static_cast<size_t>(b) * a.n_comp + c) * 64;
    uint32_t x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int z = kZigzag[8 * r + i];
      x[i] = static_cast<uint32_t>(static_cast<int32_t>(src[z])) *
             static_cast<uint32_t>(__ldg(q + z));
    }
    if (r == 0 && a.dc != nullptr)
      x[0] = static_cast<uint32_t>(__ldg(a.dc + g)) *
             static_cast<uint32_t>(__ldg(q));
    int32_t o[8];
    rowpass(x, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) rows[lb][r][i] = o[i];
  }
  __syncthreads();
  if (live) {
    uint32_t z[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = static_cast<uint32_t>(rows[lb][i][r]);
    int32_t o[8];
    colpass(z, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[lb][i][r] = static_cast<int16_t>(o[i]);
  }
  __syncthreads();
  if (live) {
    const Comp& cp = a.comp[c];
    const int mcu = k / a.bpm;
    const int jj = k - mcu * a.bpm - cp.base;
    const int my = mcu / a.mcus_x, mx = mcu - my * a.mcus_x;
    const int y = (my * cp.v + jj / cp.h) * 8 + r;
    const int x0 = (mx * cp.h + jj % cp.h) * 8;
    int16_t* dst = a.planes + static_cast<size_t>(b) * a.per_image + cp.off +
                   static_cast<size_t>(y) * cp.wc + x0;
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(out[lb][r]);
  }
}

__device__ __forceinline__ int sample(const int16_t* p, int wc, int i, int j) {
  const int s = p[static_cast<size_t>(i) * wc + j] + 128;
  return s < 0 ? 0 : (s > 255 ? 255 : s);
}

// the neighbour before i, the first replicated
__device__ __forceinline__ int before(int i) { return i > 0 ? i - 1 : 0; }

// the neighbour after i, replicated at the plane's last sample and at the
// image's true last sample `last` (-1: none)
__device__ __forceinline__ int after(int i, int n, int last) {
  return (i == last || i == n - 1) ? i : i + 1;
}

// component value at output pixel (y, x), centred; p the image's plane,
// (lh, lw) the true last sample row and column (-1: none)
__device__ __forceinline__ int upsampled(const Comp& c, const int16_t* p,
                                         int fancy, int y, int x, int lh,
                                         int lw) {
  if (c.fh == 1 && c.fv == 1) return p[static_cast<size_t>(y) * c.wc + x];
  if (!fancy || c.fh > 2 || c.fv > 2)
    return p[static_cast<size_t>(y / c.fv) * c.wc + x / c.fh];
  const bool ox = x & 1, oy = y & 1;
  if (c.fh == 2 && c.fv == 2) {
    const int i = y >> 1, j = x >> 1;
    const int in = oy ? after(i, c.hc, lh) : before(i);
    const int jn = ox ? after(j, c.wc, lw) : before(j);
    const int near = 3 * sample(p, c.wc, i, j) + sample(p, c.wc, in, j);
    const int far = 3 * sample(p, c.wc, i, jn) + sample(p, c.wc, in, jn);
    return ((3 * near + far + (ox ? 7 : 8)) >> 4) - 128;
  }
  if (c.fh == 2) {   // h2v1
    const int j = x >> 1;
    const int jn = ox ? after(j, c.wc, lw) : before(j);
    return ((3 * sample(p, c.wc, y, j) + sample(p, c.wc, y, jn) +
             (ox ? 2 : 1)) >> 2) - 128;
  }
  // h1v2
  const int i = y >> 1;
  const int in = oy ? after(i, c.hc, lh) : before(i);
  return ((3 * sample(p, c.wc, i, x) + sample(p, c.wc, in, x) +
           (oy ? 2 : 1)) >> 2) - 128;
}

template <bool kExact>
__global__ void __launch_bounds__(kColourThreads)
planes_colour_kernel(const Args a) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kColourThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.B) * a.H * a.RW) return;
  const int gx = static_cast<int>(idx % a.RW);
  const long long row = idx / a.RW;
  const int y = static_cast<int>(row % a.H);
  const int b = static_cast<int>(row / a.H);
  const int x0 = gx * 8;
  const int n = min(8, a.W - x0);
  const int16_t* img = a.planes + static_cast<size_t>(b) * a.per_image;
  int lh[kMaxComp], lw[kMaxComp];
  for (int c = 0; c < a.n_comp; ++c) {
    lh[c] = lw[c] = -1;
    if (a.ext != nullptr) {
      lh[c] = __ldg(a.ext + 2 * b) * (a.comp[c].v * 8) - 1;
      lw[c] = __ldg(a.ext + 2 * b + 1) * (a.comp[c].h * 8) - 1;
    }
  }
  uint8_t px[3][8];
  uint32_t bits = 0;
  for (int i = 0; i < n; ++i) {
    int v[3] = {0, 0, 0};
    for (int c = 0; c < a.n_comp; ++c)
      v[c] = upsampled(a.comp[c], img + a.comp[c].off, a.fancy, y, x0 + i,
                       lh[c], lw[c]);
    int rgb[3];
    bool risky = false;
    color<kExact>(v[0], v[1], v[2], a, rgb, &risky);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) px[ch][i] = static_cast<uint8_t>(rgb[ch]);
    if (risky) bits |= 1u << i;
  }
  for (int ch = 0; ch < 3; ++ch) {
    uint8_t* dst = a.rgb + ((static_cast<size_t>(b) * 3 + ch) * a.H + y) *
                               static_cast<size_t>(a.W) + x0;
    if (n == 8 && (a.W & 7) == 0) {
      uint2 w;
      w.x = px[ch][0] | (px[ch][1] << 8) | (px[ch][2] << 16) |
            (static_cast<uint32_t>(px[ch][3]) << 24);
      w.y = px[ch][4] | (px[ch][5] << 8) | (px[ch][6] << 16) |
            (static_cast<uint32_t>(px[ch][7]) << 24);
      *reinterpret_cast<uint2*>(dst) = w;
    } else {
      for (int i = 0; i < n; ++i) dst[i] = px[ch][i];
    }
  }
  if (!kExact)
    a.risk[(static_cast<size_t>(b) * a.H + y) * a.RW + gx] =
        static_cast<uint8_t>(bits);
}

template <typename T>
int launch_idct(const Args& a, cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(a.B) * a.n_blocks + kBlocks - 1) / kBlocks;
  planes_idct_kernel<T>
      <<<static_cast<unsigned>(blocks), kIdctThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExact>
int launch_colour(const Args& a, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.B) * a.H * a.RW;
  const long long blocks = (threads + kColourThreads - 1) / kColourThreads;
  planes_colour_kernel<kExact>
      <<<static_cast<unsigned>(blocks), kColourThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// coef: int16 (coef_bytes 2) or int32 (4) [B, n_blocks, 64]; quant int32
// [B, n_comp, 64]; dc int32 [B, n_blocks] or null; ext int32 [B, 2] or
// null; planes int16 scratch [B, per_image], 16-byte aligned; rgb uint8
// [B, 3, H, W]; risk uint8 [B, H, ceil(W/8)] (unused when exact).
// comps: int64 [n_comp, 8] = h, v, fh, fv, wc, hc, base, off per
// component (host); fconsts: f32 [6] = red, blue, gy_b, gy_r, gy_inv,
// eps; dconsts: f64 [5] = red, blue, gy_b, gy_r, gy_div (host).
extern "C" int tpj_planes(const void* coef, const int32_t* quant,
                          const int32_t* dc, const int32_t* ext,
                          int16_t* planes, uint8_t* rgb, uint8_t* risk,
                          int coef_bytes, int B, int n_comp, int n_blocks,
                          int bpm, int mcus_x, int H, int W, int fancy,
                          int exact, long long per_image,
                          const long long* comps, const float* fconsts,
                          const double* dconsts, cudaStream_t stream) {
  if (n_comp < 1 || n_comp > kMaxComp || (coef_bytes != 2 && coef_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || n_blocks <= 0 || H <= 0 || W <= 0) return 0;
  Args a;
  a.coef = coef;
  a.quant = quant;
  a.dc = dc;
  a.ext = ext;
  a.planes = planes;
  a.rgb = rgb;
  a.risk = risk;
  a.B = B;
  a.n_comp = n_comp;
  a.n_blocks = n_blocks;
  a.bpm = bpm;
  a.mcus_x = mcus_x;
  a.H = H;
  a.W = W;
  a.RW = (W + 7) / 8;
  a.fancy = fancy;
  a.per_image = per_image;
  for (int c = 0; c < n_comp; ++c) {
    const long long* p = comps + 8 * c;
    a.comp[c] = Comp{static_cast<int>(p[0]), static_cast<int>(p[1]),
                     static_cast<int>(p[2]), static_cast<int>(p[3]),
                     static_cast<int>(p[4]), static_cast<int>(p[5]),
                     static_cast<int>(p[6]), p[7]};
  }
  a.f = ColorConsts{fconsts[0], fconsts[1], fconsts[2],
                    fconsts[3], fconsts[4], fconsts[5]};
  a.d = ExactConsts{dconsts[0], dconsts[1], dconsts[2], dconsts[3],
                    dconsts[4]};
  int rc = coef_bytes == 2 ? launch_idct<int16_t>(a, stream)
                           : launch_idct<int32_t>(a, stream);
  if (rc != 0) return rc;
  return exact ? launch_colour<true>(a, stream)
               : launch_colour<false>(a, stream);
}
