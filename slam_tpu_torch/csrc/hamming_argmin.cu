// Minimum Hamming distance of each 256-bit descriptor to a codebook, and
// the first codebook index that reaches it.
//
// Replaces the Pallas TPU kernel slam_tpu/ops/pallas_kernels.py
// (_hamming_argmin_kernel). Like it, the (N, V) distance matrix never
// reaches device memory: each descriptor keeps a running (dist, idx) min in
// registers while codebook tiles stream through shared memory.
//
// Bound: integer ALU work, 8 XOR + 8 popcount + 8 adds per pair. Device
// memory traffic is O(N + V) words.
//
// Design, simple first, one launch:
//   - one thread per descriptor, its 8 words in registers;
//   - codebook tiles of kTileV rows staged in shared memory (every thread of
//     a warp reads the same row, a broadcast);
//   - __popc(a ^ b) summed over the 8 words, running min with strict <, so
//     the first index wins among equal distances;
//   - ragged N and V edges are masked; no padding is needed.
// Inputs are int32 tensors holding the uint32 bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // descriptors per block
constexpr int kTileV = 128;      // codebook rows per shared-memory tile
constexpr int kWords = 8;
static_assert(kBlock == kTileV, "each thread stages one codebook row");

__global__ void __launch_bounds__(kBlock)
hamming_argmin_kernel(const uint32_t* __restrict__ desc,
                      const uint32_t* __restrict__ code, int n, int v,
                      int32_t* __restrict__ dist, int32_t* __restrict__ idx) {
  __shared__ uint4 tile[kTileV][2];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;

  uint32_t a[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) a[k] = live ? desc[(size_t)i * kWords + k] : 0u;

  int best = 1 << 30;
  int best_idx = 0;
  for (int base = 0; base < v; base += kTileV) {
    const int rows = min(kTileV, v - base);
    // kBlock == kTileV: each thread stages one codebook row (32 bytes)
    if (threadIdx.x < rows) {
      const uint4* src = reinterpret_cast<const uint4*>(code + (size_t)(base + threadIdx.x) * kWords);
      tile[threadIdx.x][0] = src[0];
      tile[threadIdx.x][1] = src[1];
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const uint4 c0 = tile[j][0];
      const uint4 c1 = tile[j][1];
      const int d = __popc(a[0] ^ c0.x) + __popc(a[1] ^ c0.y) +
                    __popc(a[2] ^ c0.z) + __popc(a[3] ^ c0.w) +
                    __popc(a[4] ^ c1.x) + __popc(a[5] ^ c1.y) +
                    __popc(a[6] ^ c1.z) + __popc(a[7] ^ c1.w);
      if (d < best) {
        best = d;
        best_idx = base + j;
      }
    }
    __syncthreads();
  }
  if (live) {
    dist[i] = best;
    idx[i] = best_idx;
  }
}

}  // namespace

// desc: (n, 8) int32, code: (v, 8) int32, both 16-byte aligned and
// contiguous; dist, idx: (n,) int32. Returns cudaGetLastError().
extern "C" int hamming_argmin_launch(const int32_t* desc, const int32_t* code,
                                     int n, int v, int32_t* dist, int32_t* idx,
                                     void* stream) {
  if (n <= 0 || v <= 0 || v > 65536) return (int)cudaErrorInvalidValue;
  hamming_argmin_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(desc),
      reinterpret_cast<const uint32_t*>(code), n, v, dist, idx);
  return (int)cudaGetLastError();
}
