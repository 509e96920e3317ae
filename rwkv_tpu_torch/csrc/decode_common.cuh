// Pieces shared by the whole-model decode kernels K3 (v7_decode.cu), K4
// (v7_decode_batched.cu), K6 (v6_decode.cu), K7 (v5_decode.cu) and K8
// (v4_decode.cu): the timing build's phase stamps, IEEE-exact elementwise
// helpers, the lane count of the big matvecs, the block-wide quantization
// of a phase's input vectors, the block-wide layer norm and the LM head
// phase.
#pragma once

#include "common.cuh"

constexpr int kMaxJ = 16;  // state entries a thread holds: S * S / threads <= 16 (S <= 64 at 256)

#ifdef RWKV_PHASE_TIMES
// Timing build (scripts/probe_torch_decode.py --phases and
// rwkv_tpu_torch/tools/probe_batched.py --phases): thread 0 of block 0 stamps
// %globaltimer at every phase boundary into marks[] (the scratch tail).
#define PHASE_MARK()                                               \
  do {                                                             \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                     \
      unsigned long long t_;                                       \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));       \
      marks[n_marks] = t_;                                         \
    }                                                              \
    ++n_marks;                                                     \
  } while (0)
#else
#define PHASE_MARK() \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / add(1.0f, expf(-x)); }
__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float dequant(int acc, float dx, float d) {
  return mul(mul(__int2float_rn(acc), dx), d);
}

// Lanes sharing a weight row of width K in the big matvecs of K6-K8: a
// power of two that lets each lane read its share in one round of
// kMaxChunksPerLane 16-byte chunks (matvec_rows then keeps the largest
// power of two dividing the row's chunks), so a warp has the most bytes in
// flight per round and a phase takes the fewest dependent rounds.
__device__ __forceinline__ int lanes_for(int K, bool w4) {
  const int want = (w4 ? K / 2 : K) / 16 / kMaxChunksPerLane;
  int l = 1;
  while (l < want && l < 32) l <<= 1;
  return l;
}

// Block-wide max of N values at once (one pair of barriers for all N);
// every thread gets the results. `red` holds N * 32 floats.
template <int N>
__device__ __forceinline__ void block_max_n(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = warp_max(v[m]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < N; ++m) red[m * 32 + warp] = v[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = warp_max(lane < n_warps ? red[m * 32 + lane] : 0.f);
  __syncthreads();
}

// Quantize N vectors of n values, f(m, c) giving value c of vector m, each
// as a whole: codes into q8[m * q_stride + c] (shared), scales into dxs[m].
// One pass for the N maxima, one block reduction, one pass for the codes.
template <int N, typename Fn>
__device__ void quantize_n(Fn f, int n, int8_t* q8, int q_stride, float* dxs, float* red) {
  float amax[N];
#pragma unroll
  for (int m = 0; m < N; ++m) amax[m] = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
#pragma unroll
    for (int m = 0; m < N; ++m) amax[m] = fmaxf(amax[m], fabsf(f(m, c)));
  }
  block_max_n<N>(amax, red);
  float inv[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float dx = amax[m] / 127.0f;
    inv[m] = act_inv_scale(dx);
    if (threadIdx.x == 0) dxs[m] = dx;
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
#pragma unroll
    for (int m = 0; m < N; ++m) q8[m * q_stride + c] = act_code(f(m, c), inv[m]);
  }
  __syncthreads();
}

// Block-wide layer norm of src[0..n) into dst (both shared), as
// (x - mu) * rsqrt(var + eps) * w + b with population variance.
__device__ void layer_norm_block(const float* src, float* dst, const float* w,
                                 const float* b, int n, float eps, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) s += src[c];
  const float mu = block_sum(s, red) / static_cast<float>(n);
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float d = sub(src[c], mu);
    v += mul(d, d);
  }
  const float var = block_sum(v, red) / static_cast<float>(n);
  const float rs = rsqrtf(add(var, eps));
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    dst[c] = add(mul(mul(sub(src[c], mu), rs), w[c]), b[c]);
  __syncthreads();
}

// The LM head after the last layer's barrier: ln_out of the residual x_g
// (C floats, global), quantized as a whole, then the V int8 head rows (int8
// under w4a8 too) into logits, eight lanes a row (V rows take half the
// rounds of the default). Shared scratch: xs and xl C floats each, red 256
// floats, dxs one float, q8 C bytes.
__device__ __forceinline__ void lm_head(const float* x_g, const int8_t* head,
                                        const float* head_d, const float* ln_out, float* logits,
                                        int C, int V, float* xs, float* xl, float* red,
                                        float* dxs, int8_t* q8) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) xs[c] = x_g[c];
  __syncthreads();
  layer_norm_block(xs, xl, ln_out, ln_out + C, C, 1e-5f, red);
  quantize_n<1>([&](int, int c) { return xl[c]; }, C, q8, 0, dxs, red);
  matvec_grid<false, 1>(head, V, C, 1, [&](int, int) { return q8; },
      [&](int row, int, int acc) { logits[row] = dequant(acc, dxs[0], head_d[row]); }, 8);
}
