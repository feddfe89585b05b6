// ORB orientation and rotated-BRIEF descriptors of every keypoint of one
// frame step: the tracked slots and each pyramid level's detected slots in one
// launch, bit for bit equal to the plain version ops/orb.orb_features_plain
// (ops/orb.compute_orb a group, then torch.cat):
//
//   - the keypoint's centre converted toward zero (as .to(int64)) and clamped
//     19 px from the border (ops/orb.extract_patches);
//   - the intensity-centroid moments m10, m01 of the quantised level over the
//     radius-15 circle (ops/orb.ic_angles), the angle in degrees by
//     cv::fastAtan2's polynomial (ops/orb.fast_atan2_deg);
//   - the 256 learned pairs rotated by the reference's fast cos and sin and
//     rounded half to even, each pair's two samples of the quantised blurred
//     level compared, the bits packed LSB-first into eight 32-bit words
//     (ops/orb.descriptors_from_patches, ops/orb.pack_bits).
//
// It replaces no Pallas TPU kernel: it fuses the orientation and descriptor
// part of the JAX front-end's XLA stages (slam_tpu/ops/orb.py; K3-K6). The
// plain version issues ~150 tensor ops a group (two whole-level
// quantisations, two (S, N, 39, 39) patch gathers, the masked moment sums,
// the trigonometry as chains of where, the pattern's round and gather, the
// int64 packing), ~1,350 a fleet step, each a kernel of a few microseconds.
//
// What bounds it on an H100: latency and gathers, not arithmetic or bytes.
// A keypoint reads its 961 moment pixels and 512 samples (5,892 bytes in
// float32) and writes its angle and 8 words (36 bytes): 28.8 MB at the
// fleet's 4,864 keypoints a step, 8.6 us at 3.35 TB/s, much of it in L1 and
// L2 (a keypoint's samples lie in a 39 x 39 window, the levels in the 50 MB
// L2 as the pyramid leaves them).
//
// What the design does about it:
//   - one launch for every group of a step: a table of groups (pointers,
//     level size, slots, first slot) passed by value; warp k of the launch
//     is keypoint k of the (images, slots) output, so the angle and the
//     words are written straight into the step's output, no concatenation;
//   - one warp a keypoint, 8 a block. Lane l reads column l - 15 of the
//     circle's 31 rows (coalesced), quantises each pixel as it reads it (no
//     quantised copy of a level is written) and sums the moments in int32;
//     a butterfly of shuffles gives every lane both sums. Every lane then
//     computes the angle, cos and sin, and 8 of the 256 pairs (pair
//     32 k + l), and each __ballot_sync is one descriptor word;
//   - the pattern sits in __constant__ memory and is staged into shared
//     memory once a block (one pair a thread), where the lanes' distinct
//     pairs read without serialising.
//
// Bit-equality with the plain version:
//   - the quantised pixels are integers up to 255 and the weights integers
//     up to 15 in magnitude: every partial sum of a moment lies below
//     1,248,480 < 2^24, so the plain float32 sum is exact in any order and
//     equals the int32 sum here;
//   - every float step after that is written with an _rn intrinsic
//     (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the plain code's
//     order, so nvcc contracts nothing into a fused multiply-add that the
//     plain code rounds twice; floorf, fabsf and rintf (half to even, as
//     torch.round) are exact; the constants are the float32 values the
//     plain code uses (its Python floats rounded to float32, written here in
//     hexadecimal);
//   - a level under 39 px on a side (the top levels of a small camera):
//     the plain version's clamp of the centre to [19, side - 20] gives
//     side - 20 there (torch.clamp takes the upper bound when the bounds
//     cross), and its patch gather wraps the negative rows or columns round
//     to the level's far edge (Python indexing); the kernel does both.
//     Below 20 px the plain version's indices leave the level, and the
//     binding refuses such a level.

#include <cstdint>
#include <cuda_runtime.h>

// One group as the caller passes it (kernels/orb_describe.py's ctypes
// structure). Outside the anonymous namespace: the C entry point takes it.
struct OrbGroupArg {
  const float* img;    // (images, h, w) float32, contiguous: the level
  const float* blur;   // (images, h, w) float32, contiguous: it blurred
  const float* xy;     // (images, n, 2) float32, contiguous: (x, y) a slot
  int h, w, n;
};

namespace {

constexpr int kWarps = 8;                  // keypoints a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroups = 17;             // the tracked slots + 16 levels
constexpr int kHalfPatch = 15;             // the orientation circle's radius
constexpr int kRadius = 19;                // ORB_PATCH_RADIUS
constexpr int kPairs = 256;
constexpr int kWords = kPairs / 32;

static_assert(kThreads == kPairs, "a block stages one pair a thread");

// ops/orb.u_max_table(): the circle's half width at each row |dv|
__constant__ int kUMax[kHalfPatch + 1] = {15, 15, 15, 15, 14, 14, 14, 13,
                                          13, 12, 11, 10, 9, 8, 6, 3};

// ops/orb_pattern.ORB_PATTERN: pair i = (p0 and p1 of sample a, p0 and p1
// of sample b)
__constant__ char4 kPattern[kPairs] = {
    {8, -3, 9, 5}, {4, 2, 7, -12}, {-11, 9, -8, 2}, {7, -12, 12, -13},
    {2, -13, 2, 12}, {1, -7, 1, 6}, {-2, -10, -2, -4}, {-13, -13, -11, -8},
    {-13, -3, -12, -9}, {10, 4, 11, 9}, {-13, -8, -8, -9}, {-11, 7, -9, 12},
    {7, 7, 12, 6}, {-4, -5, -3, 0}, {-13, 2, -12, -3}, {-9, 0, -7, 5},
    {12, -6, 12, -1}, {-3, 6, -2, 12}, {-6, -13, -4, -8}, {11, -13, 12, -8},
    {4, 7, 5, 1}, {5, -3, 10, -3}, {3, -7, 6, 12}, {-8, -7, -6, -2},
    {-2, 11, -1, -10}, {-13, 12, -8, 10}, {-7, 3, -5, -3}, {-4, 2, -3, 7},
    {-10, -12, -6, 11}, {5, -12, 6, -7}, {5, -6, 7, -1}, {1, 0, 4, -5},
    {9, 11, 11, -13}, {4, 7, 4, 12}, {2, -1, 4, 4}, {-4, -12, -2, 7},
    {-8, -5, -7, -10}, {4, 11, 9, 12}, {0, -8, 1, -13}, {-13, -2, -8, 2},
    {-3, -2, -2, 3}, {-6, 9, -4, -9}, {8, 12, 10, 7}, {0, 9, 1, 3},
    {7, -5, 11, -10}, {-13, -6, -11, 0}, {10, 7, 12, 1}, {-6, -3, -6, 12},
    {10, -9, 12, -4}, {-13, 8, -8, -12}, {-13, 0, -8, -4}, {3, 3, 7, 8},
    {5, 7, 10, -7}, {-1, 7, 1, -12}, {3, -10, 5, 6}, {2, -4, 3, -10},
    {-13, 0, -13, 5}, {-13, -7, -12, 12}, {-13, 3, -11, 8}, {-7, 12, -4, 7},
    {6, -10, 12, 8}, {-9, -1, -7, -6}, {-2, -5, 0, 12}, {-12, 5, -7, 5},
    {3, -10, 8, -13}, {-7, -7, -4, 5}, {-3, -2, -1, -7}, {2, 9, 5, -11},
    {-11, -13, -5, -13}, {-1, 6, 0, -1}, {5, -3, 5, 2}, {-4, -13, -4, 12},
    {-9, -6, -9, 6}, {-12, -10, -8, -4}, {10, 2, 12, -3}, {7, 12, 12, 12},
    {-7, -13, -6, 5}, {-4, 9, -3, 4}, {7, -1, 12, 2}, {-7, 6, -5, 1},
    {-13, 11, -12, 5}, {-3, 7, -2, -6}, {7, -8, 12, -7}, {-13, -7, -11, -12},
    {1, -3, 12, 12}, {2, -6, 3, 0}, {-4, 3, -2, -13}, {-1, -13, 1, 9},
    {7, 1, 8, -6}, {1, -1, 3, 12}, {9, 1, 12, 6}, {-1, -9, -1, 3},
    {-13, -13, -10, 5}, {7, 7, 10, 12}, {12, -5, 12, 9}, {6, 3, 7, 11},
    {5, -13, 6, 10}, {2, -12, 2, 3}, {3, 8, 4, -6}, {2, 6, 12, -13},
    {9, -12, 10, 3}, {-8, 4, -7, 9}, {-11, 12, -4, -6}, {1, 12, 2, -8},
    {6, -9, 7, -4}, {2, 3, 3, -2}, {6, 3, 11, 0}, {3, -3, 8, -8}, {7, 8, 9, 3},
    {-11, -5, -6, -4}, {-10, 11, -5, 10}, {-5, -8, -3, 12}, {-10, 5, -9, 0},
    {8, -1, 12, -6}, {4, -6, 6, -11}, {-10, 12, -8, 7}, {4, -2, 6, 7},
    {-2, 0, -2, 12}, {-5, -8, -5, 2}, {7, -6, 10, 12}, {-9, -13, -8, -8},
    {-5, -13, -5, -2}, {8, -8, 9, -13}, {-9, -11, -9, 0}, {1, -8, 1, -2},
    {7, -4, 9, 1}, {-2, 1, -1, -4}, {11, -6, 12, -11}, {-12, -9, -6, 4},
    {3, 7, 7, 12}, {5, 5, 10, 8}, {0, -4, 2, 8}, {-9, 12, -5, -13},
    {0, 7, 2, 12}, {-1, 2, 1, 7}, {5, 11, 7, -9}, {3, 5, 6, -8},
    {-13, -4, -8, 9}, {-5, 9, -3, -3}, {-4, -7, -3, -12}, {6, 5, 8, 0},
    {-7, 6, -6, 12}, {-13, 6, -5, -2}, {1, -10, 3, 10}, {4, 1, 8, -4},
    {-2, -2, 2, -13}, {2, -12, 12, 12}, {-2, -13, 0, -6}, {4, 1, 9, 3},
    {-6, -10, -3, -5}, {-3, -13, -1, 1}, {7, 5, 12, -11}, {4, -2, 5, -7},
    {-13, 9, -9, -5}, {7, 1, 8, 6}, {7, -8, 7, 6}, {-7, -4, -7, 1},
    {-8, 11, -7, -8}, {-13, 6, -12, -8}, {2, 4, 3, 9}, {10, -5, 12, 3},
    {-6, -5, -6, 7}, {8, -3, 9, -8}, {2, -12, 2, 8}, {-11, -2, -10, 3},
    {-12, -13, -7, -9}, {-11, 0, -10, -5}, {5, -3, 11, 8}, {-2, -13, -1, 12},
    {-1, -8, 0, 9}, {-13, -11, -12, -5}, {-10, -2, -10, 11}, {-3, 9, -2, -13},
    {2, -3, 3, 2}, {-9, -13, -4, 0}, {-4, 6, -3, -10}, {-4, 12, -2, -7},
    {-6, -11, -4, 9}, {6, -3, 6, 11}, {-13, 11, -5, 5}, {11, 11, 12, 6},
    {7, -5, 12, -2}, {-1, 12, 0, 7}, {-4, -8, -3, -2}, {-7, 1, -6, 7},
    {-13, -12, -8, -13}, {-7, -2, -6, -8}, {-8, 5, -6, -9}, {-5, -1, -4, 5},
    {-13, 7, -8, 10}, {1, 5, 5, -13}, {1, 0, 10, -13}, {9, 12, 10, -1},
    {5, -8, 10, -9}, {-1, 11, 1, -13}, {-9, -3, -6, 2}, {-1, -10, 1, 12},
    {-13, 1, -8, -10}, {8, -11, 10, -6}, {2, -13, 3, -6}, {7, -13, 12, -9},
    {-10, -10, -5, -7}, {-10, -8, -8, -13}, {4, -6, 8, 5}, {3, 12, 8, -13},
    {-4, 2, -3, -3}, {5, -13, 10, -12}, {4, -13, 5, -1}, {-9, 9, -4, 3},
    {0, 3, 3, -9}, {-12, 1, -6, 1}, {3, 2, 4, -8}, {-10, -10, -10, 9},
    {8, -13, 12, 12}, {-8, -12, -6, -5}, {2, 2, 3, 7}, {10, 6, 11, -8},
    {6, 8, 8, -12}, {-7, 10, -6, 5}, {-3, -9, -3, 9}, {-1, -13, -1, 5},
    {-3, -7, -3, 4}, {-8, -2, -8, 3}, {4, 2, 12, 12}, {2, -5, 3, 11},
    {6, -9, 11, -13}, {3, -1, 7, 12}, {11, -1, 12, 4}, {-3, 0, -3, 6},
    {4, -11, 4, 12}, {2, -4, 2, 1}, {-10, -6, -8, 1}, {-13, 7, -11, 1},
    {-13, 12, -11, -13}, {6, 0, 11, -13}, {0, -1, 1, 4}, {-13, 3, -9, -2},
    {-9, 8, -6, -3}, {-13, -6, -8, -2}, {5, -9, 8, 10}, {2, 7, 3, -9},
    {-1, -6, -1, -1}, {9, 5, 11, -2}, {11, -3, 12, -8}, {3, 0, 3, 5},
    {-1, 4, 0, 10}, {3, -6, 4, 5}, {-13, 0, -10, 5}, {5, 8, 12, 11},
    {8, 9, 9, -6}, {7, -4, 8, -12}, {-10, 4, -10, 9}, {7, 3, 12, 4},
    {9, -7, 10, -2}, {7, 0, 12, -2}, {-1, -6, 0, -11}};

// ops/orb.py's float32 constants
constexpr float kAtanP1 = 0x1.ca44dcp+5f;      //  57.283623  _ATAN2_P1
constexpr float kAtanP3 = -0x1.2aaddcp+4f;     // -18.667446  _ATAN2_P3
constexpr float kAtanP5 = 0x1.1d3f7ep+3f;      //   8.9140005 _ATAN2_P5
constexpr float kAtanP7 = -0x1.4515b2p+1f;     //  -2.5397246 _ATAN2_P7
constexpr float kDblEps = 0x1.0p-52f;          // _DBL_EPS
constexpr float kPi = 0x1.921fb6p+1f;          // _PI
constexpr float kHalfPi = 0x1.921fb6p+0f;      // _PI_2
constexpr float kTwoPi = 0x1.921fb6p+2f;       // _TWO_PI
constexpr float kInvTwoPi = 0x1.45f306p-3f;    // _INV_TWO_PI
constexpr float kThreeHalfPi = 0x1.2d97c8p+2f; // _THREE_PI_2
constexpr float kCos0 = 0x1.ffb1c2p-1f;        //  0.99940307 (_cos_core)
constexpr float kCos2 = -0x1.fb7984p-2f;       // -0.49558072
constexpr float kCos4 = 0x1.2d65bep-5f;        //  0.03679168
constexpr float kDegToRad = 0x1.1df46ap-6f;    // float32(pi / 180)

struct Group {
  const float* img;
  const float* blur;
  const float* xy;
  int h, w, n, first;   // first: the group's first slot
};

struct Table {
  Group g[kMaxGroups];
  int n_groups, slots, images;
};

// round(clamp(x, 0, 255)), half to even as torch.round
__device__ __forceinline__ float quantise(float x) {
  return rintf(x < 0.f ? 0.f : (x > 255.f ? 255.f : x));
}

// clamp(x.to(int64), lo, hi) = min(max(x, lo), hi), hi where the bounds
// cross; the conversion toward zero is the same instruction as PyTorch's
// cast on the card
__device__ __forceinline__ int centre(float x, int lo, int hi) {
  long long v = static_cast<long long>(x);
  v = v < lo ? lo : v;
  return static_cast<int>(v > hi ? hi : v);
}

// a row or column index of the patch round a clamped centre: from -side
// up, negative ones wrapped to the far edge as Python indexing does
__device__ __forceinline__ int wrap(int i, int side) {
  return i < 0 ? i + side : i;
}

// ops/orb.fast_atan2_deg
__device__ __forceinline__ float fast_atan2_deg(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float lo = fminf(ax, ay), hi = fmaxf(ax, ay);
  const float c = __fdiv_rn(lo, __fadd_rn(hi, kDblEps));
  const float c2 = __fmul_rn(c, c);
  float a = __fadd_rn(__fmul_rn(kAtanP7, c2), kAtanP5);
  a = __fadd_rn(__fmul_rn(a, c2), kAtanP3);
  a = __fmul_rn(__fmul_rn(a, c2), c);
  a = __fadd_rn(a, __fmul_rn(kAtanP1, c));
  if (!(ax >= ay)) a = __fsub_rn(90.f, a);
  if (x < 0.f) a = __fsub_rn(180.f, a);
  if (y < 0.f) a = __fsub_rn(360.f, a);
  return a;
}

// ops/orb._cos_core
__device__ __forceinline__ float cos_core(float v) {
  const float v2 = __fmul_rn(v, v);
  return __fadd_rn(kCos0, __fmul_rn(v2, __fadd_rn(kCos2,
                                                  __fmul_rn(kCos4, v2))));
}

// ops/orb.fast_cos
__device__ __forceinline__ float fast_cos(float v) {
  v = __fsub_rn(v, __fmul_rn(floorf(__fmul_rn(v, kInvTwoPi)), kTwoPi));
  v = fabsf(v);
  if (v < kHalfPi) return cos_core(v);
  if (v < kPi) return -cos_core(__fsub_rn(kPi, v));
  if (v < kThreeHalfPi) return -cos_core(__fsub_rn(v, kPi));
  return cos_core(__fsub_rn(kTwoPi, v));
}

// one rotated sample of the quantised blurred (h, w) level round the
// centre (cy, cx): row cvRound(p0 sin + p1 cos), column
// cvRound(p0 cos - p1 sin)
__device__ __forceinline__ float sample(const float* level, int h, int w,
                                        int cy, int cx, float p0, float p1,
                                        float ca, float sa) {
  const int r = static_cast<int>(
      rintf(__fadd_rn(__fmul_rn(p0, sa), __fmul_rn(p1, ca))));
  const int q = static_cast<int>(
      rintf(__fsub_rn(__fmul_rn(p0, ca), __fmul_rn(p1, sa))));
  return quantise(level[wrap(cy + r, h) * static_cast<size_t>(w)
                        + wrap(cx + q, w)]);
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const Table t, float* __restrict__ angles,
                    uint32_t* __restrict__ desc) {
  __shared__ char4 pattern[kPairs];
  pattern[threadIdx.x] = kPattern[threadIdx.x];
  __syncthreads();

  // this warp's keypoint: image, slot, and the last group whose first slot
  // is at most the slot (a group of no slots is passed over)
  const int lane = threadIdx.x & 31;
  const long long key =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (key >= static_cast<long long>(t.images) * t.slots) return;
  const int image = static_cast<int>(key / t.slots);
  const int slot = static_cast<int>(key - static_cast<long long>(image)
                                              * t.slots);
  Group G = t.g[0];
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i)
    if (i < t.n_groups && slot >= t.g[i].first) G = t.g[i];
  const int h = G.h, w = G.w;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* xy = G.xy + (image * static_cast<size_t>(G.n)
                            + (slot - G.first)) * 2;
  const int cx = centre(xy[0], kRadius, w - 1 - kRadius);
  const int cy = centre(xy[1], kRadius, h - 1 - kRadius);

  // the moments: lane l sums column du = l - 15 of the circle (lane 31,
  // du = 16, lies outside it)
  const int du = lane - kHalfPatch;
  const int adu = du < 0 ? -du : du;
  const float* __restrict__ col = G.img + image * plane + wrap(cx + du, w);
  int m10 = 0, m01 = 0;
#pragma unroll
  for (int dv = -kHalfPatch; dv <= kHalfPatch; ++dv) {
    if (adu <= kUMax[dv < 0 ? -dv : dv]) {
      const int v = static_cast<int>(
          quantise(col[wrap(cy + dv, h) * static_cast<size_t>(w)]));
      m10 += du * v;
      m01 += dv * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, o);
    m01 += __shfl_xor_sync(0xffffffffu, m01, o);
  }
  const float angle = fast_atan2_deg(static_cast<float>(m01),
                                     static_cast<float>(m10));

  // the descriptor: lane l compares pairs l, 32 + l, ..., 224 + l; ballot k
  // is word k, bit l of it pair 32 k + l
  const float rad = __fmul_rn(angle, kDegToRad);
  const float ca = fast_cos(rad);
  const float sa = fast_cos(__fsub_rn(kHalfPi, rad));   // ops/orb.fast_sin
  const float* __restrict__ blur = G.blur + image * plane;
  uint32_t mine = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const char4 p = pattern[32 * k + lane];
    const float a = sample(blur, h, w, cy, cx, p.x, p.y, ca, sa);
    const float b = sample(blur, h, w, cy, cx, p.z, p.w, ca, sa);
    const uint32_t word = __ballot_sync(0xffffffffu, a < b);
    if (lane == k) mine = word;
  }
  if (lane < kWords) desc[key * kWords + lane] = mine;
  if (lane == 0) angles[key] = angle;
}

}  // namespace

// groups: n_groups (1..17) groups of `images` images each, every level at
// least 20 x 20. Writes angles (images, slots) float32 and desc (images,
// slots, 8) 32-bit words, slots the groups' n summed, in group order. One
// launch on `stream`. Returns the launch's cudaError_t.
extern "C" int orb_describe_launch(const OrbGroupArg* groups, int n_groups,
                                   int images, float* angles, void* desc,
                                   void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || images < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  long long slots = 0;
  for (int i = 0; i < n_groups; ++i) {
    const OrbGroupArg& a = groups[i];
    if (a.h < kRadius + 1 || a.w < kRadius + 1 || a.n < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    Group& g = t.g[i];
    g.img = a.img;
    g.blur = a.blur;
    g.xy = a.xy;
    g.h = a.h;
    g.w = a.w;
    g.n = a.n;
    g.first = static_cast<int>(slots);
    slots += a.n;
    if (slots > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.n_groups = n_groups;
  t.slots = static_cast<int>(slots);
  t.images = images;
  const long long blocks = (images * slots + kWarps - 1) / kWarps;
  if (blocks < 1 || blocks > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  orb_describe_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      t, angles, static_cast<uint32_t*>(desc));
  return static_cast<int>(cudaGetLastError());
}
