// K1: w8a8 quantized matmul, y[M, N] = (float(x8 @ q^T) * dx) * d.
//
// Replaces rwkv_tpu/ops/kernels.py::_pallas_quant_matmul, w8a8 branch
// (_kernel_w8a8, kernels.py:255), reached through quant_matmul (:427).
//
// x [M, K] f32 is quantized per row to int8 (dx = amax/127, rint, clip
// +-127, act_inv_scale / act_code of common.cuh); the codes are multiplied
// s8 x s8 -> s32, exactly, and the epilogue is
// __fmul_rn(__fmul_rn(f32(acc), dx), d) in the JAX package's order. The
// weight is stored [N, K] (K contiguous, the port's own layout) with one f32
// scale per output row.
//
// Bound on this card: the bytes (x, the K*N int8 codes, the scales, y) over
// HBM bandwidth, or 2*M*K*N int8 operations over the int8 tensor-core
// peak, whichever is larger -- at the main path's shapes (M <= 256) the
// bytes, so launch latency and the time to fill a pipeline set the floor.
// Design (the route, tile and split come from the wrapper,
// ops/kernels.py::matmul_plan):
//  - M > 8: two launches. w8a8_quantize_rows writes the codes and dx (a
//    128-thread block a row, float4 loads). w8a8_gemm runs on the int8
//    tensor cores (mma.sync m16n8k32 s8.s8.s32, fragments by ldmatrix from
//    shared memory; the [N, K] weight is already mma's "col" operand): a
//    BM x BN tile a block of 2 x 4 warps (64x64, 32x32; 32x16 on 2 x 2),
//    128-byte K stages through a 4-stage cp.async ring, zero-filled past K
//    (K = 16, 48 are taken) and past the ragged M and N edges. Split-K over
//    a cluster of up to 8 blocks (gemm_common.cuh): int32 partial sums,
//    added in a fixed order, so the result is exact and the same at every
//    launch. The quantization stays a launch of its own: fused into the
//    GEMM, every column tile would read its rows' f32 x over the whole of
//    K again for their amax (4 bytes an element where the GEMM reads one);
//    chip_smoke.py prints its share.
//  - M <= 8 (the head; the batcher's head at M = B): one launch,
//    w8a8_gemv. Every block quantizes the M rows of x itself into shared
//    memory (the same codes in every block) while its first weight rows
//    are prefetched into L2, then walks output rows: `lanes` lanes a row,
//    16-byte code loads, up to 8 in flight a lane, __dp4a against the
//    staged codes, a grid of at most 4 blocks an SM looping over the rows.
#include "common.cuh"
#include "gemm_common.cuh"

namespace {

// ---- activation codes (M > 8) ------------------------------------------------

constexpr int kQuantThreads = 128;  // a block a row

__device__ __forceinline__ float amax4(float a, float4 v) {
  return fmaxf(fmaxf(a, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// the codes of four values, packed little-endian into a word
__device__ __forceinline__ int codes4(float4 v, float inv) {
  return static_cast<int>(static_cast<uint8_t>(act_code(v.x, inv)) |
                          static_cast<uint8_t>(act_code(v.y, inv)) << 8 |
                          static_cast<uint8_t>(act_code(v.z, inv)) << 16 |
                          static_cast<unsigned>(static_cast<uint8_t>(act_code(v.w, inv))) << 24);
}

__global__ void __launch_bounds__(kQuantThreads)
w8a8_quantize_rows(const float* __restrict__ x, int8_t* __restrict__ x8,
                   float* __restrict__ dx, int K) {
  __shared__ float red[32];
  const float4* xr = reinterpret_cast<const float4*>(x + static_cast<size_t>(blockIdx.x) * K);
  int* qr = reinterpret_cast<int*>(x8 + static_cast<size_t>(blockIdx.x) * K);
  float amax = 0.f;
  for (int i = threadIdx.x; i < K / 4; i += kQuantThreads) amax = amax4(amax, xr[i]);
  amax = block_max(amax, red);
  const float d = amax / 127.0f;
  const float inv = act_inv_scale(d);
  for (int i = threadIdx.x; i < K / 4; i += kQuantThreads) qr[i] = codes4(xr[i], inv);
  if (threadIdx.x == 0) dx[blockIdx.x] = d;
}

// ---- M > 8: the int8 tensor-core GEMM ---------------------------------------

constexpr int kBK = 128;             // bytes of K a stage
constexpr int kPitch = kBK + 16;     // shared row pitch: 8 ldmatrix rows on distinct banks
constexpr int kStages = 4;

template <int BM, int BN>
constexpr size_t gemm_smem() {
  constexpr size_t ring = static_cast<size_t>(kStages) * (BM + BN) * kPitch;
  constexpr size_t red = static_cast<size_t>(BM) * (BN + 1) * sizeof(int);
  return ring > red ? ring : red;
}

// Grid (split, ceil(N / BN), ceil(M / BM)), clusters of `split` along x;
// WM x WN warps, each a (BM / WM) x (BN / WN) sub-tile.
template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
w8a8_gemm(const int8_t* __restrict__ x8, const float* __restrict__ dx,
          const int8_t* __restrict__ q, const float* __restrict__ d,
          float* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = WM * WN * 32;
  constexpr int MF = BM / WM / 16;  // m16 fragments of a warp
  constexpr int NF = BN / WN / 8;   // n8 fragments of a warp
  constexpr int kStage = (BM + BN) * kPitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = (warp / WN) * (BM / WM), wc0 = (warp % WN) * (BN / WN);
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  int first, last;
  gemm::split_range((K + kBK - 1) / kBK, gridDim.x, blockIdx.x, first, last);
  const int n_steps = last - first;
  const int8_t* xa = x8 + static_cast<size_t>(m0) * K;
  const int8_t* qb = q + static_cast<size_t>(n0) * K;

  // one stage: the x8 and code rows of the tile, 16 bytes a copy; rows at
  // or past M / N and bytes at or past K are zero-filled
  auto load = [&](int step) {
    unsigned char* dst = smem + (step % kStages) * kStage;
    const int k0 = (first + step) * kBK;
    for (int i = tid; i < (BM + BN) * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = i % (kBK / 16), k = k0 + 16 * c;
      const bool is_a = r < BM;
      const int8_t* src = is_a ? xa : qb;
      const int rr = is_a ? r : r - BM;
      const bool ok = rr < (is_a ? M - m0 : N - n0) && k < K;
      gemm::cp_async16(dst + r * kPitch + 16 * c, ok ? src + static_cast<size_t>(rr) * K + k : src,
                       ok);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s);
    gemm::cp_async_commit();
  }

  int acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int it = 0; it < n_steps; ++it) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; stage it - 1 is free for reuse
    if (it + kStages - 1 < n_steps) load(it + kStages - 1);
    gemm::cp_async_commit();
    const unsigned char* as = smem + (it % kStages) * kStage;
    const unsigned char* bs = as + BM * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[MF][4], b[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        gemm::ldmatrix_x4(a[i], as + (wr0 + i * 16 + (lane & 15)) * kPitch + kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NF; ++j)
        gemm::ldmatrix_x2(b[j], bs + (wc0 + j * 8 + (lane & 7)) * kPitch + kk +
                                    ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) gemm::mma_s8(acc[i][j], a[i], b[j]);
    }
  }

  // (float(acc) * dx) * d, in the JAX package's order
  auto store = [&](int r, int c, int sum) {
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      y[static_cast<size_t>(m) * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(sum), dx[m]), d[n]);
  };
  if (gridDim.x == 1) {
    gemm::for_fragments(acc, wr0, wc0, store);
    return;
  }
  gemm::cp_async_wait<0>();
  __syncthreads();  // the ring becomes the partial tile
  int* red = reinterpret_cast<int*>(smem);
  gemm::for_fragments(acc, wr0, wc0, [&](int r, int c, int v) { red[r * (BN + 1) + c] = v; });
  gemm::cluster_reduce<BM, BN>(red, store);
}

// ---- M <= 8: the GEMV with its own quantization ----------------------------

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvRows = 8;   // largest M this route takes
constexpr int kMaxChunks = 8;  // 16-byte code loads a lane has in flight
// shared memory a block may use, static included: the GEMV's M x K codes
// (dynamic) and its reduction scratch (static) together
constexpr size_t kSmemLimit = 232448;

__global__ void __launch_bounds__(kGemvThreads)
w8a8_gemv(const float* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ d, float* __restrict__ y, int M, int N, int K, int lanes) {
  extern __shared__ __align__(16) int8_t xs[];  // [M][K] codes
  __shared__ float red[kGemvRows * 32];
  __shared__ float dxs[kGemvRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nchunks = K / 16;
  const int per_lane = (nchunks + lanes - 1) / lanes;
  const int sub = lane % lanes, grp = lane / lanes, gpw = 32 / lanes;

  // pull this warp's first rows towards L2 while the block quantizes
  {
    const int n = (blockIdx.x * kGemvWarps + warp) * gpw + grp;
    for (int j = 0; j < per_lane && n < N; ++j) {
      const int c = j * lanes + sub;
      if (c < nchunks)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(q + static_cast<size_t>(n) * K + 16 * c));
    }
  }

  // the codes of x's M rows, as w8a8_quantize_rows computes them
  float amax[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) amax[r] = 0.f;
  for (int c = tid; c < K / 4; c += kGemvThreads) {
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
      if (r < M) amax[r] = amax4(amax[r], reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * K)[c]);
  }
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    const float v = warp_max(amax[r]);
    if (lane == 0) red[r * 32 + warp] = v;
  }
  __syncthreads();
  float inv[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    const float dr = warp_max(lane < kGemvWarps ? red[r * 32 + lane] : 0.f) / 127.0f;
    inv[r] = act_inv_scale(dr);
    if (tid == 0) dxs[r] = dr;
  }
  for (int c = tid; c < K / 4; c += kGemvThreads) {
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r)
      if (r < M)
        reinterpret_cast<int*>(xs + r * K)[c] =
            codes4(reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * K)[c], inv[r]);
  }
  __syncthreads();

  for (int base = (blockIdx.x * kGemvWarps + warp) * gpw; base < N;
       base += gridDim.x * kGemvWarps * gpw) {  // warp-uniform
    const int n = base + grp;
    int acc[kGemvRows];
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) acc[r] = 0;
    if (n < N) {
      const int4* wr = reinterpret_cast<const int4*>(q + static_cast<size_t>(n) * K);
      for (int j0 = 0; j0 < per_lane; j0 += kMaxChunks) {
        int4 wv[kMaxChunks];
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = (j0 + j) * lanes + sub;
          if (j0 + j < per_lane && c < nchunks) wv[j] = __ldg(wr + c);
        }
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = (j0 + j) * lanes + sub;
          if (j0 + j < per_lane && c < nchunks) {
#pragma unroll
            for (int r = 0; r < kGemvRows; ++r) {
              if (r < M) {
                const int4 xv = reinterpret_cast<const int4*>(xs + r * K)[c];
                int a = acc[r];
                a = __dp4a(wv[j].x, xv.x, a);
                a = __dp4a(wv[j].y, xv.y, a);
                a = __dp4a(wv[j].z, xv.z, a);
                a = __dp4a(wv[j].w, xv.w, a);
                acc[r] = a;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGemvRows; ++r) {
      if (r < M) {
        int a = acc[r];
        for (int off = lanes >> 1; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (sub == 0 && n < N)
          y[static_cast<size_t>(r) * N + n] =
              __fmul_rn(__fmul_rn(__int2float_rn(a), dxs[r]), d[n]);
      }
    }
  }
}

cudaError_t quantize(const float* x, int8_t* x8, float* dx, int M, int K, cudaStream_t st) {
  w8a8_quantize_rows<<<M, kQuantThreads, 0, st>>>(x, x8, dx, K);
  return cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch_gemm(const int8_t* x8, const float* dx, const int8_t* q, const float* d,
                        float* y, int M, int N, int K, int split, cudaStream_t st) {
  const dim3 grid(split, (N + BN - 1) / BN, (M + BM - 1) / BM);
  return gemm::launch(w8a8_gemm<BM, BN, WM, WN>, grid, WM * WN * 32, gemm_smem<BM, BN>(), split,
                      st, x8, dx, q, d, y, M, N, K);
}

}  // namespace

// The activation codes alone (x [M, K] f32 -> x8 [M, K] int8, dx [M] f32),
// the first launch of the M > 8 route; chip_smoke.py times it on its own.
extern "C" int rwkv_w8a8_quantize(const void* x, void* x8, void* dx, int M, int K, void* stream) {
  return static_cast<int>(quantize(static_cast<const float*>(x), static_cast<int8_t*>(x8),
                                   static_cast<float*>(dx), M, K,
                                   static_cast<cudaStream_t>(stream)));
}

// The GEMV's static shared memory (bytes), or a negative CUDA error code:
// ops/kernels.py::K1_GEMV_STATIC_SMEM must match it (a card test reads
// both), since matmul_plan sends M x K codes to the GEMV only while they
// fit beside it.
extern "C" int rwkv_w8a8_gemv_static_smem() {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, w8a8_gemv);
  return err == cudaSuccess ? static_cast<int>(attr.sharedSizeBytes) : -static_cast<int>(err);
}

// x [M, K] f32, q [N, K] int8, d [N] f32 -> y [M, N] f32. The plan comes
// from ops/kernels.py::matmul_plan: bm = 0 takes the GEMV route (M <= 8;
// `lanes` lanes a row, `blocks` blocks; x8 and dx unused), else the
// tensor-core route with a bm x bn tile (64x64, 32x32, 32x16) and `split`
// K ranges (1-8, at most the number of 64-byte K steps), x8 [M, K] int8
// and dx [M] f32 caller-allocated scratch. K must be a multiple of 16 and
// every pointer 16-byte aligned (checked by the Python wrapper).
extern "C" int rwkv_w8a8_matmul(const void* x, void* x8, void* dx, const void* q, const void* d,
                                void* y, int M, int K, int N, int bm, int bn, int split,
                                int lanes, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* dp = static_cast<const float*>(d);
  float* yp = static_cast<float*>(y);
  if (M < 1 || N < 1 || K < 16 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 0) {
    if (M > kGemvRows || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || blocks < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(M) * K;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, w8a8_gemv);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem + attr.sharedSizeBytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(w8a8_gemv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    w8a8_gemv<<<blocks, kGemvThreads, smem, st>>>(xp, qp, dp, yp, M, N, K, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  const int steps = (K + kBK - 1) / kBK;
  if (split < 1 || split > gemm::kMaxSplit || split > steps)
    return static_cast<int>(cudaErrorInvalidValue);
  int8_t* x8p = static_cast<int8_t*>(x8);
  float* dxp = static_cast<float*>(dx);
  cudaError_t err = quantize(xp, x8p, dxp, M, K, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bm == 64 && bn == 64) err = launch_gemm<64, 64, 2, 4>(x8p, dxp, qp, dp, yp, M, N, K, split, st);
  else if (bm == 32 && bn == 32) err = launch_gemm<32, 32, 2, 4>(x8p, dxp, qp, dp, yp, M, N, K, split, st);
  else if (bm == 32 && bn == 16) err = launch_gemm<32, 16, 2, 2>(x8p, dxp, qp, dp, yp, M, N, K, split, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
