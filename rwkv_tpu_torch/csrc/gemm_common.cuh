// Pieces shared by the two quantized matmuls, K1 (quant_matmul.cu) and K9
// (block_matmul.cu): cp.async copies that zero-fill what lies outside the
// operands, ldmatrix, the int8 mma, the K split of the tensor-core (M > 8)
// route, its split-K reduction through the cluster's distributed shared
// memory, and its launch. K4 (batch_mma.cuh) takes the cp.async copies,
// the int8 mma (its int forms) and the bf16 mma with x split into three
// bf16 parts (its bf16 form, as K9's f32 forms split x).
//
// The M > 8 route. A block of WM x WN warps owns a BM x BN output tile, one
// of three (64x64 on 2 x 4 warps, 32x32 on 2 x 4, 32x16 on 2 x 2), and
// one of `split` contiguous ranges of its K steps. The `split` blocks of a
// tile form one thread block cluster (cluster dims (split, 1, 1), grid
// (split, ceil(N / BN), ceil(M / BM))). With split > 1 each block leaves its
// partial tile in its own shared memory; after a cluster barrier, block r of
// the cluster sums rows r, r + split, ... of the tile over the cluster's
// blocks in rank order 0, 1, ..., split - 1, and writes them. The order is
// fixed, so an f32 split-K result is the same at every launch; no scratch in
// device memory, no atomics and no second launch. The wrapper
// (rwkv_tpu_torch/ops/kernels.py::matmul_plan) picks the tile and the split
// so that a main-path shape launches at least 132 blocks, one an SM.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gemm {

namespace cg = cooperative_groups;

constexpr int kMaxSplit = 8;  // the portable cluster size

// 16 bytes from global `src` into shared `dst`; !valid fills the 16 bytes
// with zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes, zero-filled where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four (x4) or two (x2) 8x8 matrices of 16-bit elements from shared
// memory, row addresses from lanes 0-31 (x4) or 0-15 (x2): lane l gets the
// 32-bit word l % 4 of row l / 4 of each matrix. A row is 16 bytes: 8
// bf16, 16 int8 or 4 tf32 values.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 (K1 here, K4's int
// forms in batch_mma.cuh)
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 (K9, K4's bf16 form)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two values as a bf16 pair, lo in the low half (RNE)
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The first P bf16 parts of the pair (a, b), each a bf16x2 word (a in the
// low half): part 0 is (bf16(a), bf16(b)), each next part the same of what
// the parts before it leave (a - hi, then a - hi - mid: each difference
// exact in f32, the parts widened exactly by a shift). Three parts carry a
// finite f32's 24-bit significand, so hi + mid + lo == a for 2^-110 <= |a|
// < 2^128 (1 - 2^-9) (bf16's largest value and a half ulp); smaller values
// keep what bf16's subnormals can hold (within 2^-134), larger ones round
// to infinity in part 0.
template <int P>
__device__ __forceinline__ void bf16_parts(float a, float b, unsigned (&h)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    h[p] = bf16x2(a, b);
    if (p + 1 < P) {
      a = __fsub_rn(a, __uint_as_float(h[p] << 16));
      b = __fsub_rn(b, __uint_as_float(h[p] & 0xFFFF0000u));
    }
  }
}

// K steps [first, last) of cluster rank z out of `split` over `steps`:
// contiguous, whole steps, sizes differing by at most one.
__device__ __forceinline__ void split_range(int steps, int split, int z, int& first, int& last) {
  first = static_cast<int>(static_cast<long long>(steps) * z / split);
  last = static_cast<int>(static_cast<long long>(steps) * (z + 1) / split);
}

// The mma accumulators acc[MF][NF][4] of a warp whose tile starts at row
// r0, column c0 (m16n8 fragments: row r0 + 16 i + lane / 4 (+ 8), columns
// c0 + 8 j + 2 (lane % 4) (+ 1)), as fn(row, col, value) calls.
template <int MF, int NF, typename T, typename Fn>
__device__ __forceinline__ void for_fragments(const T (&acc)[MF][NF][4], int r0, int c0, Fn fn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int r = r0 + i * 16 + (lane >> 2);
      const int c = c0 + j * 8 + 2 * (lane & 3);
      fn(r, c, acc[i][j][0]);
      fn(r, c + 1, acc[i][j][1]);
      fn(r + 8, c, acc[i][j][2]);
      fn(r + 8, c + 1, acc[i][j][3]);
    }
  }
}

// Split-K reduction and epilogue (split > 1). Each block has written its
// partial tile to red[BM][BN + 1] (its own shared memory, T = int or
// float). Block r of the cluster sums rows r, r + split, ... in rank order
// and calls store(row_in_tile, col_in_tile, sum) for each element; store
// checks the ragged edges. Eight elements a thread are read from each rank
// at once. Starts and ends with a cluster barrier: the partial tiles are
// complete before anyone reads them, and no block leaves while another
// still reads its shared memory.
template <int BM, int BN, typename T, typename Store>
__device__ __forceinline__ void cluster_reduce(T* red, Store store) {
  constexpr int kU = 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int count = (BM - rank + split - 1) / split * BN;  // this rank's elements
  cluster.sync();
  for (int e0 = threadIdx.x; e0 < count; e0 += kU * blockDim.x) {
    T sum[kU];
    for (int z = 0; z < split; ++z) {
      const T* src = cluster.map_shared_rank(red, z);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < count) {
          const T v = src[(rank + split * (e / BN)) * (BN + 1) + e % BN];
          sum[u] = z == 0 ? v : sum[u] + v;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) store(rank + split * (e / BN), e % BN, sum[u]);
    }
  }
  cluster.sync();
}

// Launch `kernel` with `threads` threads a block on a grid of clusters of
// `split` blocks along x (no cluster when split = 1); sets the kernel's
// dynamic shared memory limit first (each launch its own: the limit belongs
// to the kernel). Returns the CUDA error.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem, int split,
                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gemm
