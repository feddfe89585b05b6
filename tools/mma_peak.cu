// Peak rate of two tensor-core mma.sync forms on this card, measured by a
// loop of independent mma.sync instructions on registers only (no memory
// traffic inside the loop):
//   form 0: mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc, the
//           instruction of csrc/hamming_argmin.cu, 2*16*8*256 operations;
//   form 1: mma.sync.m16n8k32.row.col.s32.s8.s8.s32, 2*16*8*32 operations,
//           to set the probe beside the card's published int8 peak.
// chip_smoke.py builds this file, times a launch with CUDA events and
// counts the operations from the grid it asked for. The hamming kernel's
// bound takes the larger of the published int8 peak and the measured b1
// rate, because the card's b1 rate is not in its data sheet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kChains = 8;     // independent accumulators a warp

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1,
                                    bool bits) {
  if (bits) {
    asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <bool kBits>
__global__ void __launch_bounds__(kThreads, 4)  // 4 blocks an SM
mma_peak_kernel(int iters, int32_t* __restrict__ out) {
  // operands from the thread index, so that nothing folds at compile time
  uint32_t x = (blockIdx.x * kThreads + threadIdx.x) * 2654435761u + 1u;
  uint32_t a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x ^= x << 13; x ^= x >> 17; x ^= x << 5;
    a[j] = x;
  }
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  const uint32_t b0 = x;
  x ^= x << 13; x ^= x >> 17; x ^= x << 5;
  const uint32_t b1 = x;
  int d[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma(d[c], a, b0, b1, kBits);
  }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// One launch of `blocks` blocks of 256 threads, each warp issuing
// iters * 8 mma.sync of `form` (0: b1 and.popc m16n8k256, 1: s8 m16n8k32);
// out: blocks * 256 int32. Returns the launch's cudaError_t.
extern "C" int mma_peak_launch(int form, int blocks, int iters, int32_t* out,
                               void* stream) {
  if (blocks <= 0 || iters <= 0 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0)
    mma_peak_kernel<true><<<blocks, kThreads, 0, s>>>(iters, out);
  else
    mma_peak_kernel<false><<<blocks, kThreads, 0, s>>>(iters, out);
  return (int)cudaGetLastError();
}
