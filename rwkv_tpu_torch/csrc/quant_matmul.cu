// K1: w8a8 quantized matmul, y[M, N] = (float(x8 @ q^T) * dx) * d.
//
// Replaces rwkv_tpu/ops/kernels.py::_pallas_quant_matmul, w8a8 branch
// (_kernel_w8a8, kernels.py:255), reached through quant_matmul (:427).
//
// x [M, K] f32 is quantized per row to int8 (dx = amax/127, rint, clip
// +-127) by w8a8_quantize_rows; w8a8_gemm then accumulates s8 x s8 -> s32
// with __dp4a. The weight is stored [N, K] (K contiguous, the port's own
// layout, transposed at conversion) with one f32 scale per output row.
//
// Bound on this card: the weight stream (K*N int8 + 4N bytes of scales) over
// HBM bandwidth, or 2*M*K*N int8 operations over the int8 tensor-core peak,
// whichever is larger -- at the main path's shapes (M <= 256) the bytes.
// Design: a 64x64 output tile per 256-thread block, 64-byte K steps staged
// through shared memory with 16-byte loads, 4x4 outputs per thread. dp4a
// runs on the CUDA cores, so at M = 256 this kernel is compute-bound well
// above the bound; the wgmma tensor-core form is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;          // bytes of K per step
constexpr int kKW = kBK / 4;     // int32 words per tile row

__global__ void __launch_bounds__(kThreads)
w8a8_quantize_rows(const float* __restrict__ x, int8_t* __restrict__ x8,
                   float* __restrict__ dx, int K) {
  __shared__ float red[32];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * K;
  int8_t* qr = x8 + static_cast<size_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) amax = fmaxf(amax, fabsf(xr[i]));
  amax = block_max(amax, red);
  const float d = amax / 127.0f;
  const float inv = act_inv_scale(d);
  for (int i = threadIdx.x; i < K; i += blockDim.x) qr[i] = act_code(xr[i], inv);
  if (threadIdx.x == 0) dx[blockIdx.x] = d;
}

__global__ void __launch_bounds__(kThreads)
w8a8_gemm(const int8_t* __restrict__ x8, const float* __restrict__ dx,
          const int8_t* __restrict__ q, const float* __restrict__ d,
          float* __restrict__ y, int M, int N, int K) {
  __shared__ int As[kBM][kKW + 1];
  __shared__ int Bs[kBN][kKW + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int lr = threadIdx.x >> 2, lp = threadIdx.x & 3;  // loader: row, 16-byte part
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kk = k0 + lp * 16;
    int4 av = make_int4(0, 0, 0, 0), bv = make_int4(0, 0, 0, 0);
    if (m0 + lr < M && kk < K)
      av = *reinterpret_cast<const int4*>(x8 + static_cast<size_t>(m0 + lr) * K + kk);
    if (n0 + lr < N && kk < K)
      bv = *reinterpret_cast<const int4*>(q + static_cast<size_t>(n0 + lr) * K + kk);
    As[lr][lp * 4 + 0] = av.x; As[lr][lp * 4 + 1] = av.y;
    As[lr][lp * 4 + 2] = av.z; As[lr][lp * 4 + 3] = av.w;
    Bs[lr][lp * 4 + 0] = bv.x; Bs[lr][lp * 4 + 1] = bv.y;
    Bs[lr][lp * 4 + 2] = bv.z; Bs[lr][lp * 4 + 3] = bv.w;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kKW; ++w) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float dm = dx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      // (float(acc) * dx) * d, in the JAX package's order
      if (n < N) y[static_cast<size_t>(m) * N + n] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), dm), d[n]);
    }
  }
}

}  // namespace

// x [M, K] f32, q [N, K] int8, d [N] f32 -> y [M, N] f32; x8 [M, K] int8 and
// dx [M] f32 are caller-allocated scratch. K must be a multiple of 16 and
// every pointer 16-byte aligned (checked by the Python wrapper).
extern "C" int rwkv_w8a8_matmul(const void* x, void* x8, void* dx, const void* q,
                                const void* d, void* y, int M, int K, int N,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  w8a8_quantize_rows<<<M, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(x8), static_cast<float*>(dx), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_gemm<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(dx),
      static_cast<const int8_t*>(q), static_cast<const float*>(d),
      static_cast<float*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
