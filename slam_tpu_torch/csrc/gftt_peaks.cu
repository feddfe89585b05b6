// GFTT detection on every pyramid level of one frame step: the level's
// quantised image in, the masked corner score map out,
//
//   where(is_peak & in_margin, response, -inf),
//
// the map ops/detector.take_best sorts, bit for bit equal to the plain
// version ops/detector.gftt_peaks_plain (quantisation, the Shi-Tomasi
// min-eigenvalue response of 3x3 Sobel gradients over a 3x3 box, the
// (2 md + 1)^2 max-pool peak test with response > 0, the margin).
//
// It replaces no Pallas TPU kernel: the JAX package leaves detection to XLA
// (stages K3-K6 of its front-end). The plain version runs ~70 full-image
// elementwise passes a level, several in float64, then a max-pool and the
// mask passes, each through device memory.
//
// What bounds it on an H100: bytes. The work is a few dozen operations a
// pixel; reading each level once (float32) and writing its map once is
// 8 bytes a pixel, 71.5 MB a step at the fleet's S = 8 x 752x480 x 8 levels
// (21 us at 3.35 TB/s). A level the pyramid has just written may still sit
// in the 50 MB L2.
//
// What the design does about it:
//   - one launch for all levels of a step: a table of levels (pointers,
//     sizes, min distance, first block) passed by value; block b finds its
//     level, image and 32 x 16 output tile from the table;
//   - the tile's pixels and a halo of md + 2 (1 for the Sobel, 1 for the
//     box, md for the peak window) are read once into shared memory and
//     quantised there; gradients, box sums, trace, discriminant and
//     response over the tile and its md halo, the window maxima and the
//     mask stay in shared memory and registers. Only the masked map is
//     written;
//   - the halo grows with md, and so does the shared memory: the response
//     takes the pixels' place once the gradients are made, and the row
//     maxima take gx's once the response is made. Above 48 KB the launch
//     opts in to the card's larger limit (227 KB on an H100: md up to 56);
//     only a min distance whose tile cannot fit is refused;
//   - tiles that lie wholly outside the margin write -inf and read nothing.
//
// Bit-equality with the plain version (ops/detector.py:shi_tomasi_response):
//   - the plain code pads by replicating the edge, once for the Sobel input
//     and again for each gradient product before the box sum. Here the
//     quantised tile is loaded at clamped coordinates, and the gradient of
//     a halo position outside the image is the gradient at its clamped
//     position: that is the product array's replicated edge;
//   - on the uint8 grid every gradient, product, box sum and their
//     difference is an integer below 2^24, exact in float32 in any order;
//   - (gxx - gyy)^2 is one float32 rounding; the plain code adds 4 gxy gxy
//     in float64, where the sum is exact (below 2^53), and rounds it once to
//     float32: a float32 fused multiply-add of (4 gxy) gxy onto it rounds
//     the same exact sum once. Its square root is the float64 square root
//     rounded to float32, which is the correctly rounded float32 square
//     root (53 >= 2 x 24 + 2 bits, so rounding twice is harmless): the
//     float32 __fsqrt_rn. Then 0.5 (tr - sqrt). No float64 runs here, and
//     every rounding step is written with an _rn intrinsic, so nvcc
//     contracts nothing the plain code does not;
//   - the max-pool pads with -inf: a pixel outside the image never wins a
//     window. A NaN in a window, as in the max-pool, makes no peak.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// One level as the caller passes it (kernels/gftt_peaks.py's ctypes
// structure). Outside the anonymous namespace: the C entry point takes it,
// and a parameter of internal linkage would hide that entry point.
struct GfttLevelArg {
  const float* img;    // (images, h, w) float32, contiguous
  float* out;          // (images, h, w) float32, contiguous
  int h, w, md;
};

namespace {

constexpr int kTileW = 32;           // output tile: 32 columns
constexpr int kTileH = 16;           //   x 16 rows
constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;
constexpr int kDefaultSmem = 48 * 1024;   // a launch may take this unasked

struct Level {
  const float* img;
  float* out;
  int h, w, md, tiles_x, tiles, first_block;   // tiles: of one image
};

struct Table {
  Level lv[kMaxLevels];
  int n_levels, margin;
};

constexpr size_t smem_bytes(int md) {
  // quantised pixels (rh + 4)(rw + 4), then the response rh rw in their
  // place; gx and gy (rh + 2)(rw + 2) each, then the row maxima rh kTileW
  // in gx's place; rh = kTileH + 2 md, rw likewise
  return sizeof(float) * ((kTileH + 2 * md + 4) * (kTileW + 2 * md + 4)
                          + 2 * (kTileH + 2 * md + 2) * (kTileW + 2 * md + 2));
}

// the most shared memory a block of the current device may opt in to, or
// -1 (the error in *err)
int smem_limit(cudaError_t* err) {
  int dev = 0, limit = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return *err == cudaSuccess ? limit : -1;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// round(clamp(x, 0, 255)), half to even as torch.round; NaN stays NaN
__device__ __forceinline__ float quantise(float x) {
  return rintf(x < 0.f ? 0.f : (x > 255.f ? 255.f : x));
}

// the max-pool's maximum: a NaN wins
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// f(i, j, i * cols + j) over a rows x cols region (cols <= kThreads), the
// block's threads in row-major order, with no division in the loop
template <typename F>
__device__ __forceinline__ void for_each(int rows, int cols, F f) {
  int i = threadIdx.x / cols, j = threadIdx.x - i * cols;
  const int di = kThreads / cols, dj = kThreads - di * cols;
  while (i < rows) {
    f(i, j, i * cols + j);
    i += di;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
  }
}

__global__ void __launch_bounds__(kThreads) gftt_peaks_kernel(const Table t) {
  extern __shared__ float smem[];
  // this block's level: the last whose first block is at most blockIdx.x
  int b = blockIdx.x;
  Level L = t.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i)
    if (i < t.n_levels && b >= t.lv[i].first_block) L = t.lv[i];
  b -= L.first_block;
  const int image = b / L.tiles;
  b -= image * L.tiles;
  const int ty = b / L.tiles_x;
  const int r0 = ty * kTileH, c0 = (b - ty * L.tiles_x) * kTileW;
  const int h = L.h, w = L.w, md = L.md, m = t.margin;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* __restrict__ img = L.img + image * plane;
  float* __restrict__ out = L.out + image * plane;
  const int tid = threadIdx.x;
  const float ninf = -INFINITY;

  // a tile with no pixel inside the margin: every output is -inf
  if (r0 + kTileH <= m || r0 >= h - m || c0 + kTileW <= m || c0 >= w - m) {
    for (int k = tid; k < kTileH * kTileW; k += kThreads) {
      const int y = r0 + k / kTileW, x = c0 + k % kTileW;
      if (y < h && x < w) out[y * static_cast<size_t>(w) + x] = ninf;
    }
    return;
  }

  const int rh = kTileH + 2 * md, rw = kTileW + 2 * md;   // response
  const int gh = rh + 2, gw = rw + 2;                     // gradients
  const int qh = rh + 4, qw = rw + 4;                     // pixels
  float* q = smem;
  float* gx = q + qh * qw;
  float* gy = gx + gh * gw;
  float* resp = q;      // once the gradients are made
  float* rmax = gx;     // once the response is made
  const int qr0 = r0 - md - 2, qc0 = c0 - md - 2;   // image row of q row 0
  const int gr0 = qr0 + 1, gc0 = qc0 + 1;
  const int rr0 = gr0 + 1, rc0 = gc0 + 1;

  // the quantised pixels at clamped coordinates (the Sobel's edge padding)
  for_each(qh, qw, [&](int i, int j, int k) {
    q[k] = quantise(img[clampi(qr0 + i, h - 1) * static_cast<size_t>(w)
                        + clampi(qc0 + j, w - 1)]);
  });
  __syncthreads();

  // Sobel gradients; a position outside the image takes its clamped
  // position's (the products' edge padding before the box sum). Integers
  // below 2^12: exact.
  for_each(gh, gw, [&](int i, int j, int k) {
    const int qi = clampi(gr0 + i, h - 1) - qr0;
    const int qj = clampi(gc0 + j, w - 1) - qc0;
    const float* u = q + (qi - 1) * qw + qj;   // row above, centre column
    const float* c = u + qw;
    const float* d = c + qw;
    gx[k] = (u[1] + 2.f * c[1] + d[1]) - (u[-1] + 2.f * c[-1] + d[-1]);
    gy[k] = (d[-1] + 2.f * d[0] + d[1]) - (u[-1] + 2.f * u[0] + u[1]);
  });
  __syncthreads();

  // the min-eigenvalue response over the tile and its md halo; -inf
  // outside the image (the max-pool's padding)
  for_each(rh, rw, [&](int i, int j, int k) {
    const int y = rr0 + i, x = rc0 + j;
    float r = ninf;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      // box sums of the products: integers below 2^24, exact in any order
      float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const int g = (i + di) * gw + j + dj;
          sxx = __fadd_rn(sxx, __fmul_rn(gx[g], gx[g]));
          syy = __fadd_rn(syy, __fmul_rn(gy[g], gy[g]));
          sxy = __fadd_rn(sxy, __fmul_rn(gx[g], gy[g]));
        }
      }
      const float tr = __fadd_rn(sxx, syy);
      const float diff = __fsub_rn(sxx, syy);
      float disc = __fmaf_rn(__fmul_rn(4.f, sxy), sxy, __fmul_rn(diff, diff));
      disc = disc < 0.f ? 0.f : disc;
      r = __fmul_rn(0.5f, __fsub_rn(tr, __fsqrt_rn(disc)));
    }
    resp[k] = r;
  });
  __syncthreads();

  // the peak window's maximum, by rows then by columns
  const int win = 2 * md + 1;
  for (int k = tid; k < rh * kTileW; k += kThreads) {
    const int i = k / kTileW, j = k - i * kTileW;
    const float* row = resp + i * rw + j;
    float mx = row[0];
    for (int d = 1; d < win; ++d) mx = pool_max(mx, row[d]);
    rmax[k] = mx;
  }
  __syncthreads();

  for (int k = tid; k < kTileH * kTileW; k += kThreads) {
    const int i = k / kTileW, j = k - i * kTileW;
    const int y = r0 + i, x = c0 + j;
    if (y >= h || x >= w) continue;
    const float v = resp[(i + md) * rw + j + md];
    float mx = rmax[k];
    for (int d = 1; d < win; ++d) mx = pool_max(mx, rmax[k + d * kTileW]);
    const bool keep = v >= mx && v > 0.f && y >= m && y < h - m && x >= m
                      && x < w - m;
    out[y * static_cast<size_t>(w) + x] = keep ? v : ninf;
  }
}

}  // namespace

// The largest min distance whose tile fits in a block of the current
// device, or -1.
extern "C" int gftt_peaks_max_min_distance() {
  cudaError_t err;
  const int limit = smem_limit(&err);
  if (err != cudaSuccess) return -1;
  int md = 0;
  while (smem_bytes(md + 1) <= static_cast<size_t>(limit)) ++md;
  return md;
}

// levels: n_levels (1..16) levels of `images` images each, md from 1 to
// gftt_peaks_max_min_distance(). One launch on `stream`. Returns the
// launch's cudaError_t.
extern "C" int gftt_peaks_launch(const GfttLevelArg* levels, int n_levels,
                                 int images, int margin, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || images < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  long long blocks = 0;
  int md_max = 1;
  for (int l = 0; l < n_levels; ++l) {
    const GfttLevelArg& a = levels[l];
    if (a.h < 1 || a.w < 1 || a.md < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    Level& L = t.lv[l];
    L.img = a.img;
    L.out = a.out;
    L.h = a.h;
    L.w = a.w;
    L.md = a.md;
    L.tiles_x = (a.w + kTileW - 1) / kTileW;
    L.tiles = L.tiles_x * ((a.h + kTileH - 1) / kTileH);
    L.first_block = static_cast<int>(blocks);
    blocks += static_cast<long long>(images) * L.tiles;
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
    md_max = a.md > md_max ? a.md : md_max;
  }
  t.n_levels = n_levels;
  t.margin = margin;
  const size_t smem = smem_bytes(md_max);
  if (smem > kDefaultSmem) {
    cudaError_t err;
    const int limit = smem_limit(&err);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(limit))
      return static_cast<int>(cudaErrorInvalidValue);
    // the card's limit, not this launch's need: a launch of another
    // thread in between asks no less
    err = cudaFuncSetAttribute(gftt_peaks_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gftt_peaks_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}
