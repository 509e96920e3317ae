// K9: block-format quantized matmul, y[M, N] = x[M, K] @ W^T with the
// weight kept in its quantized form in device memory.
//
// Replaces rwkv_tpu/ops/kernels.py::_pallas_quant_matmul (call :365), the
// bodies _kernel_plain (:251), _kernel_min (:278), _make_kernel4 (:282)
// and _kernel_rowwise (:266), reached through quant_matmul. One template
// instance per form (the `form` argument of the C entry):
//   0 plain      W[n, k] = f32(q * d[n, k/32])             (Q5_0, Q8_0, q8)
//   1 min        W[n, k] = f32(f32(q * d) + m[n, k/32])    (Q5_1, Q4_K, Q5_K)
//   2 pack4      plain on nibbles, two's complement codes   (Q4_0)
//   3 pack4_min  min on nibbles, unsigned codes 0..15        (Q4_1)
//   4 rowwise    x rounded to bf16 (RNE), W = q exactly, y = (sum) * d[n]  (q8r)
// Codes are int8 [N, K] with K contiguous (the port's layout); pack4 holds
// [N, K/2] bytes where byte j of a 32-block's 16 bytes has code j in its
// low nibble and code j + 16 in its high nibble (ggml's own order). The
// dequantization rounds after the product and after the min
// (__fmul_rn / __fadd_rn: nvcc would contract q*d + m into one FMA), as
// the plain version and the JAX package do; the sums are f32 FMAs in this
// kernel's order.
//
// Bound on this card: for the decode shape (M <= 8) the weight stream
// (codes + scales) over HBM bandwidth; for the prefill shape (M = 256)
// 2*M*K*N f32 operations over the 67 TFLOP/s of the CUDA cores (989 TFLOP/s
// of the bf16 tensor cores for rowwise, whose products are exact in bf16).
// Design, simple first:
//  - M <= 8 (block_gemv): one warp per output row, eight rows a block;
//    the block stages x (bf16-rounded for rowwise) in shared memory in
//    chunks of 1024 columns, each lane reads 4 code bytes (4 int8 codes or
//    8 nibbles) a step, so a warp reads 128 contiguous bytes, and
//    accumulates every x row against the dequantized codes; a warp
//    reduction ends the row.
//  - M > 8 (block_gemm): a 64x64 output tile per 256-thread block, one
//    32-column K step at a time (one scale per row and step): x and the
//    dequantized weight tile go through shared memory, each thread
//    accumulates a 4x4 sub-tile with f32 FMAs from float4 reads.
// Tensor cores (wgmma on a bf16 or int8 dequant) are later work.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

enum Form { kPlain = 0, kMin = 1, kPack4 = 2, kPack4Min = 3, kRowwise = 4 };

template <int F> struct Traits {
  static constexpr bool kHasMin = F == kMin || F == kPack4Min;
  static constexpr bool kNibbles = F == kPack4 || F == kPack4Min;
  static constexpr bool kSigned = F == kPack4;
  static constexpr bool kRow = F == kRowwise;
};

template <int F>
__device__ __forceinline__ float dequant(int code, float d, float m) {
  if (Traits<F>::kRow) return static_cast<float>(code);
  const float w = __fmul_rn(static_cast<float>(code), d);
  return Traits<F>::kHasMin ? __fadd_rn(w, m) : w;
}

// nibble -> code: two's complement (Q4_0) or unsigned (Q4_1)
template <int F>
__device__ __forceinline__ int nibble(unsigned v) {
  return Traits<F>::kSigned ? static_cast<int>(v ^ 8u) - 8 : static_cast<int>(v);
}

__device__ __forceinline__ float stage_x(float v, bool row) {
  return row ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ---- M <= 8 ---------------------------------------------------------------

constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 8;   // largest M this path takes
constexpr int kChunk = 1024;   // x columns staged at a time

template <int F>
__global__ void __launch_bounds__(kGemvWarps * 32)
block_gemv(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ d, const float* __restrict__ m,
           float* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) float xs[kGemvRows][kChunk];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  const int nb = K / 32;
  float acc[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) acc[r] = 0.f;

  for (int kc = 0; kc < K; kc += kChunk) {
    const int klen = min(kChunk, K - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < M * (klen / 4); i += blockDim.x) {
      const int r = i / (klen / 4), c = i % (klen / 4);
      float4 v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(r) * K + kc + 4 * c);
      v.x = stage_x(v.x, Traits<F>::kRow); v.y = stage_x(v.y, Traits<F>::kRow);
      v.z = stage_x(v.z, Traits<F>::kRow); v.w = stage_x(v.w, Traits<F>::kRow);
      *reinterpret_cast<float4*>(&xs[r][4 * c]) = v;
    }
    __syncthreads();
    if (n >= N) continue;
    if (Traits<F>::kNibbles) {
      // a step: 8 blocks of 16 bytes, 4 lanes a block, 4 bytes a lane
      const unsigned char* qr = reinterpret_cast<const unsigned char*>(q) + static_cast<size_t>(n) * (K / 2);
      const int b_end = (kc + klen) / 32;
      for (int b = kc / 32 + (lane >> 2); b < b_end; b += 8) {
        const int t = lane & 3;
        const unsigned word = __ldg(reinterpret_cast<const unsigned*>(qr + b * 16 + 4 * t));
        const float db = __ldg(d + static_cast<size_t>(n) * nb + b);
        const float mb = Traits<F>::kHasMin ? __ldg(m + static_cast<size_t>(n) * nb + b) : 0.f;
        float wl[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned byte = (word >> (8 * j)) & 0xFFu;
          wl[j] = dequant<F>(nibble<F>(byte & 0xFu), db, mb);
          wh[j] = dequant<F>(nibble<F>(byte >> 4), db, mb);
        }
        const int k = b * 32 - kc + 4 * t;
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r) {
          if (r < M) {
            const float4 lo = *reinterpret_cast<const float4*>(&xs[r][k]);
            const float4 hi = *reinterpret_cast<const float4*>(&xs[r][k + 16]);
            float a = acc[r];
            a = fmaf(lo.x, wl[0], a); a = fmaf(lo.y, wl[1], a);
            a = fmaf(lo.z, wl[2], a); a = fmaf(lo.w, wl[3], a);
            a = fmaf(hi.x, wh[0], a); a = fmaf(hi.y, wh[1], a);
            a = fmaf(hi.z, wh[2], a); a = fmaf(hi.w, wh[3], a);
            acc[r] = a;
          }
        }
      }
    } else {
      // a step: 128 contiguous code bytes, 4 a lane
      const int8_t* qr = q + static_cast<size_t>(n) * K;
#pragma unroll 4
      for (int k = kc + 4 * lane; k < kc + klen; k += 128) {
        const int word = __ldg(reinterpret_cast<const int*>(qr + k));
        const int b = k >> 5;
        const float db = Traits<F>::kRow ? 0.f : __ldg(d + static_cast<size_t>(n) * nb + b);
        const float mb = Traits<F>::kHasMin ? __ldg(m + static_cast<size_t>(n) * nb + b) : 0.f;
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = dequant<F>(static_cast<int>(static_cast<int8_t>((word >> (8 * j)) & 0xFF)), db, mb);
#pragma unroll
        for (int r = 0; r < kGemvRows; ++r) {
          if (r < M) {
            const float4 xv = *reinterpret_cast<const float4*>(&xs[r][k - kc]);
            float a = acc[r];
            a = fmaf(xv.x, w[0], a); a = fmaf(xv.y, w[1], a);
            a = fmaf(xv.z, w[2], a); a = fmaf(xv.w, w[3], a);
            acc[r] = a;
          }
        }
      }
    }
  }
  if (n >= N) return;
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    if (r < M) {
      const float s = warp_sum(acc[r]);
      if (lane == 0)
        y[static_cast<size_t>(r) * N + n] = Traits<F>::kRow ? __fmul_rn(s, d[n]) : s;
    }
  }
}

// ---- M > 8 -----------------------------------------------------------------

constexpr int kTile = 64;  // output rows and columns of a block
constexpr int kBK = 32;    // K columns a step: one quant block

template <int F>
__global__ void __launch_bounds__(256)
block_gemm(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ d, const float* __restrict__ m,
           float* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) float xs[kBK][kTile];  // [k][m]
  __shared__ __align__(16) float ws[kBK][kTile];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int nb = K / 32;
  // weight loader: row wn of the tile, quarter wp of its 32 codes
  const int wn = tid >> 2, wp = tid & 3;
  const int n_load = n0 + wn;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int b = 0; b < nb; ++b) {
    const int k0 = b * kBK;
    // x tile: row xr, float4 columns (tid >> 6) and (tid >> 6) + 4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int xr = tid & 63, c4 = (tid >> 6) + 4 * h;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + xr < M)
        v = *reinterpret_cast<const float4*>(x + static_cast<size_t>(m0 + xr) * K + k0 + 4 * c4);
      xs[4 * c4 + 0][xr] = stage_x(v.x, Traits<F>::kRow);
      xs[4 * c4 + 1][xr] = stage_x(v.y, Traits<F>::kRow);
      xs[4 * c4 + 2][xr] = stage_x(v.z, Traits<F>::kRow);
      xs[4 * c4 + 3][xr] = stage_x(v.w, Traits<F>::kRow);
    }
    if (n_load < N) {
      const float db = Traits<F>::kRow ? 0.f : __ldg(d + static_cast<size_t>(n_load) * nb + b);
      const float mb = Traits<F>::kHasMin ? __ldg(m + static_cast<size_t>(n_load) * nb + b) : 0.f;
      if (Traits<F>::kNibbles) {
        const unsigned char* qr =
            reinterpret_cast<const unsigned char*>(q) + static_cast<size_t>(n_load) * (K / 2);
        const unsigned word = __ldg(reinterpret_cast<const unsigned*>(qr + b * 16 + 4 * wp));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned byte = (word >> (8 * j)) & 0xFFu;
          ws[4 * wp + j][wn] = dequant<F>(nibble<F>(byte & 0xFu), db, mb);
          ws[16 + 4 * wp + j][wn] = dequant<F>(nibble<F>(byte >> 4), db, mb);
        }
      } else {
        const int2 v = __ldg(reinterpret_cast<const int2*>(q + static_cast<size_t>(n_load) * K + k0 + 8 * wp));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int word = j < 4 ? v.x : v.y;
          const int code = static_cast<int8_t>((word >> (8 * (j & 3))) & 0xFF);
          ws[8 * wp + j][wn] = dequant<F>(code, db, mb);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[8 * wp + j][wn] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 w = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + 4 * ty + i;
    if (mm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + 4 * tx + j;
      if (nn < N)
        y[static_cast<size_t>(mm) * N + nn] = Traits<F>::kRow ? __fmul_rn(acc[i][j], d[nn]) : acc[i][j];
    }
  }
}

template <int F>
cudaError_t launch(const float* x, const int8_t* q, const float* d, const float* m, float* y,
                   int M, int K, int N, cudaStream_t st) {
  if (M <= kGemvRows) {
    block_gemv<F><<<(N + kGemvWarps - 1) / kGemvWarps, kGemvWarps * 32, 0, st>>>(
        x, q, d, m, y, M, K, N);
  } else {
    dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
    block_gemm<F><<<grid, 256, 0, st>>>(x, q, d, m, y, M, K, N);
  }
  return cudaGetLastError();
}

}  // namespace

// x [M, K] f32, q int8 [N, K] ([N, K/2] for the nibble forms), d f32
// [N, K/32] ([N] for rowwise), m f32 [N, K/32] or null -> y [M, N] f32.
// K must be a multiple of 32 and every pointer 16-byte aligned (checked by
// the Python wrapper, which also picks `form`).
extern "C" int rwkv_block_matmul(const void* x, const void* q, const void* d, const void* m,
                                 void* y, int M, int K, int N, int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* dp = static_cast<const float*>(d);
  const float* mp = static_cast<const float*>(m);
  float* yp = static_cast<float*>(y);
  switch (form) {
    case kPlain: return static_cast<int>(launch<kPlain>(xp, qp, dp, mp, yp, M, K, N, st));
    case kMin: return static_cast<int>(launch<kMin>(xp, qp, dp, mp, yp, M, K, N, st));
    case kPack4: return static_cast<int>(launch<kPack4>(xp, qp, dp, mp, yp, M, K, N, st));
    case kPack4Min: return static_cast<int>(launch<kPack4Min>(xp, qp, dp, mp, yp, M, K, N, st));
    case kRowwise: return static_cast<int>(launch<kRowwise>(xp, qp, dp, mp, yp, M, K, N, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
