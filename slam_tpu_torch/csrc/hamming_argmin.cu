// Minimum Hamming distance of each 256-bit descriptor to a codebook, and
// the first codebook index that reaches it, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel slam_tpu/ops/pallas_kernels.py:52
// (_hamming_argmin_kernel). Like it, the (N, V) distance matrix never
// reaches device memory: each descriptor keeps a running packed key while
// codebook tiles stream through shared memory.
//
// What bounds it on an H100:
//   - at the vocabulary's shape (4096 x 65536) the work: 2*N*V*256
//     bit operations on the tensor cores, timed against the larger of the
//     card's int8 peak and its measured b1 mma rate (chip_smoke.py); the
//     popcount form on the CUDA cores (8 XOR + 8 popc per pair) is bound
//     at ~0.51 ms;
//   - at the main path's shape (2432 x 512) the launch: the work is
//     well under a microsecond.
//
// What the design does about each:
//   - tensor cores on the packed bits: mma.sync.m16n8k256.b1.and.popc sums
//     popc(a & c) over 256 bits, and hamming = popc(a) + popc(c)
//     - 2 popc(a & c); nothing is expanded. A lane's A fragment is words t
//     and 4 + t of two descriptors, its B fragment the same words of one
//     codebook row, read straight from the cp.async ring. (An int8 form on
//     +-1 bytes, mma.sync.m16n8k32.s8, was about three times slower at the
//     vocabulary's shape on an H100, PERF.md; wgmma has no b1 form.)
//   - a block holds 64 descriptors (4 warps: 2 row halves x 2 column
//     halves); packed codebook tiles (64 rows, 32 bytes a row) arrive by
//     cp.async into a 3-stage ring, one __syncthreads per tile.
//   - the running min is one integer max of the key
//     score * 65536 + (65535 - index), where a larger score is a smaller
//     distance: among equal distances the first index wins, and masked
//     codebook rows (past V) get a key below every real one.
//   - parallelism over V in one launch: a thread-block cluster of up to 8
//     blocks shares a 64-row tile; each rank walks its own contiguous range
//     of codebook tiles, and rank r merges rows r, r + ranks, ... by reading
//     every rank's keys through distributed shared memory. At 4096 x 65536
//     that is 64 x 8 = 512 blocks; at the main path's shape 38 x 8.
//   - ragged N and V are masked in the kernel (zero-filled copies, masked
//     keys, no store past N): no padding copy, no fill or unpack launch.
// Inputs are int32 tensors holding the uint32 bit patterns.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 8;            // 32-bit words of a descriptor
constexpr int kRows = 64;            // descriptors per block
constexpr int kTileV = 64;           // codebook rows per shared-memory tile
constexpr int kStages = 3;           // depth of the packed-tile ring
constexpr int kThreads = 128;        // 4 warps: 2 row halves x 2 column halves
constexpr int kMaxRanks = 8;         // portable cluster size
constexpr int kPackedBytes = 48;     // codebook row in the ring, padded:
                                     // conflict-free fragment loads
constexpr int kMasked = -(1 << 30);  // index part of a masked row's key
static_assert(kTileV * 2 == kThreads, "one 16-byte copy per thread per tile");

constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       bool live) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(live ? 16 : 0));
}

// Copy codebook tile `tile` (rows past v zero-filled) into `ring`, whose
// rows are kPackedBytes apart: thread i copies half i & 1 of row i / 2.
__device__ __forceinline__ void load_tile(uint8_t* ring, const uint32_t* code,
                                          int v, int tile) {
  const int row = tile * kTileV + (threadIdx.x >> 1);
  const bool live = row < v;
  const uint32_t* src = code + static_cast<size_t>(live ? row : 0) * kWords
                        + 4 * (threadIdx.x & 1);
  copy16(ring + (threadIdx.x >> 1) * kPackedBytes + 16 * (threadIdx.x & 1),
         src, live);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n");
}

__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
}

// This rank's contiguous range [tile0, tile1) of codebook tiles.
__device__ __forceinline__ void rank_tiles(int v, int ranks, int rank,
                                           int& tile0, int& tile1) {
  const int tiles = (v + kTileV - 1) / kTileV;
  tile0 = static_cast<int>(static_cast<long long>(rank) * tiles / ranks);
  tile1 = static_cast<int>(static_cast<long long>(rank + 1) * tiles / ranks);
}

// key[m][h] holds a lane's running max for row 32*wr + 16*m + 8*h + g of
// the block (warp = 2*wr + wc, lane = 4*g + t). Reduce each row over its
// four lanes, the two column warps and the cluster's ranks; store dist and
// idx. The score is 2 popc(a & c) - popc(c), so dist = popc(a) - score.
__device__ __forceinline__ void finish(const int (&key)[2][2],
                                       int (&part)[2][kRows],
                                       int (&block_key)[kRows],
                                       const uint32_t* __restrict__ desc,
                                       int n, int row0,
                                       int32_t* __restrict__ dist,
                                       int32_t* __restrict__ idx) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 1, wc = warp & 1;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k = key[m][h];
      k = max(k, __shfl_xor_sync(kAll, k, 1));
      k = max(k, __shfl_xor_sync(kAll, k, 2));
      if (t == 0) part[wc][32 * wr + 16 * m + 8 * h + g] = k;
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows)
    block_key[threadIdx.x] = max(part[0][threadIdx.x], part[1][threadIdx.x]);
  cluster.sync();
  const int r = threadIdx.x;
  if (r < kRows && r % ranks == rank && row0 + r < n) {
    int k = INT_MIN;
    for (int q = 0; q < ranks; ++q)
      k = max(k, cluster.map_shared_rank(&block_key[0], q)[r]);
    const int score = k >> 16;  // arithmetic shift: floor, exact below 0
    const uint4* src = reinterpret_cast<const uint4*>(
        desc + static_cast<size_t>(row0 + r) * kWords);
    const uint4 w0 = __ldg(src), w1 = __ldg(src + 1);
    dist[row0 + r] = __popc(w0.x) + __popc(w0.y) + __popc(w0.z) + __popc(w0.w)
                     + __popc(w1.x) + __popc(w1.y) + __popc(w1.z)
                     + __popc(w1.w) - score;
    idx[row0 + r] = 0xFFFF - (k & 0xFFFF);
  }
  cluster.sync();  // keep every rank's keys alive until all are read
}

// D = popc(A & B) + D on a 16 x 8 x 256 bit tile.
__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of m16n8k256.b1 for lane (g, t): A holds bits 32t.. and
// 128 + 32t.. of rows g and g + 8, B the same bits of column g; word t and
// word 4 + t of each descriptor give them.
__global__ void __launch_bounds__(kThreads, 3)
hamming_argmin_kernel(const uint32_t* __restrict__ desc,
                         const uint32_t* __restrict__ code, int n, int v,
                         int32_t* __restrict__ dist,
                         int32_t* __restrict__ idx) {
  __shared__ __align__(16) uint8_t ring[kStages][kTileV * kPackedBytes];
  __shared__ int part[2][kRows];
  __shared__ int block_key[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int row0 = static_cast<int>(blockIdx.x / ranks) * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wr = warp >> 1, wc = warp & 1;
  int tile0, tile1;
  rank_tiles(v, ranks, static_cast<int>(cluster.block_rank()), tile0, tile1);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (tile0 + s < tile1) load_tile(ring[s], code, v, tile0 + s);
    commit();
  }

  uint32_t a[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 32 * wr + 16 * m + 8 * h + g;
      const uint32_t* src = desc + static_cast<size_t>(row) * kWords;
      a[m][h] = row < n ? __ldg(src + t) : 0u;
      a[m][2 + h] = row < n ? __ldg(src + 4 + t) : 0u;
    }
  }

  int key[2][2] = {{INT_MIN, INT_MIN}, {INT_MIN, INT_MIN}};
  for (int tile = tile0; tile < tile1; ++tile) {
    const int i = tile - tile0;
    wait_tile();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (tile + kStages - 1 < tile1)
      load_tile(ring[(i + kStages - 1) % kStages], code, v,
                tile + kStages - 1);
    commit();

    const uint8_t* slot = ring[i % kStages];
    const int col0 = tile * kTileV + 32 * wc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(
          slot + (32 * wc + 8 * nt + g) * kPackedBytes);
      const uint32_t b0 = b[t], b1 = b[4 + t];
      int pc = __popc(b0) + __popc(b1);
      pc += __shfl_xor_sync(kAll, pc, 1);
      pc += __shfl_xor_sync(kAll, pc, 2);            // popc of column g
      const int pc0 = __shfl_sync(kAll, pc, 8 * t);   // of column 2t
      const int pc1 = __shfl_sync(kAll, pc, 8 * t + 4);
      int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      mma_b1(d[0], a[0], b0, b1);
      mma_b1(d[1], a[1], b0, b1);
      // key = (2 d - popc(c)) * 65536 + 65535 - col
      const int col = col0 + 8 * nt + 2 * t;
      const int k0 = col < v ? 0xFFFF - col - pc0 * 65536 : kMasked;
      const int k1 = col + 1 < v ? 0xFFFF - (col + 1) - pc1 * 65536 : kMasked;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        key[m][0] = max(key[m][0], max(d[m][0] * 131072 + k0, d[m][1] * 131072 + k1));
        key[m][1] = max(key[m][1], max(d[m][2] * 131072 + k0, d[m][3] * 131072 + k1));
      }
    }
  }
  finish(key, part, block_key, desc, n, row0, dist, idx);
}

}  // namespace

// desc: (n, 8) int32, code: (v, 8) int32, both 16-byte aligned and
// contiguous, 1 <= v <= 65536; dist, idx: (n,) int32. One launch on
// `stream`. Returns the launch's cudaError_t.
extern "C" int hamming_argmin_launch(const int32_t* desc, const int32_t* code,
                                     int n, int v, int32_t* dist, int32_t* idx,
                                     void* stream) {
  if (n <= 0 || v <= 0 || v > 65536) return (int)cudaErrorInvalidValue;
  const int tiles = (v + kTileV - 1) / kTileV;
  const int ranks = tiles < kMaxRanks ? tiles : kMaxRanks;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + kRows - 1) / kRows * ranks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, hamming_argmin_kernel, reinterpret_cast<const uint32_t*>(desc),
      reinterpret_cast<const uint32_t*>(code), n, v, dist, idx);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
