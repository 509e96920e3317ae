// Pieces shared by the whole-model decode kernels K3 (v7_decode.cu), K4
// (v7_decode_batched.cu), K6 (v6_decode.cu), K7 (v5_decode.cu) and K8
// (v4_decode.cu) and the tensor-parallel shard kernels: the timing build's
// phase stamps, IEEE-exact elementwise helpers, the embedding read, the
// lane count of the big matvecs and the block-wide quantization (int
// forms) or staging (bf16 form) of a phase's input vectors (K4's; the
// stream kernels' versions over their consumer warps, with the layer norm,
// are in decode_stream.cuh).
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

// Element i of the embedding table: bf16 bits, or float32 (emb_f32: the
// f32 precision's table, which the bf16 form takes).
__device__ __forceinline__ float emb_at(const void* emb, bool emb_f32, size_t i) {
  return emb_f32 ? static_cast<const float*>(emb)[i]
                 : bf16_to_float(static_cast<const uint16_t*>(emb)[i]);
}

// A matvec row's value from its epilogue's sum: an int form's exact int32
// dot scaled as (float(acc) * dx) * d[0] (d points at the row's scale), the
// bf16 form's f32 dot as it is (no scale is read: that form has none).
__device__ __forceinline__ float dequant(int acc, float dx, const float* d) {
  return mul(mul(__int2float_rn(acc), dx), *d);
}
__device__ __forceinline__ float dequant(float acc, float, const float*) { return acc; }

// Lanes sharing a weight row of width K in form wf in the big matvecs of
// K6-K8: a power of two that lets each lane read its share in one round of
// kMaxChunksPerLane 16-byte chunks (matvec_rows then keeps the largest
// power of two dividing the row's chunks), so a warp has the most bytes in
// flight per round and a phase takes the fewest dependent rounds.
__host__ __device__ inline int lanes_for(int K, int wf) {
  const int want = static_cast<int>(form_bytes(wf, K)) / 16 / kMaxChunksPerLane;
  int l = 1;
  while (l < want && l < 32) l <<= 1;
  return l;
}

// Sets `kernel`'s dynamic shared memory limit to `smem` bytes. The limit
// belongs to the kernel, not to a launch, so each launch sets its own: a
// grid computed for one model stays launchable after a launch for another
// width changed the limit. Returns the CUDA error.
inline cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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

// The input vectors of a phase's matvecs in form WF: the int forms
// quantize them (quantize_n: codes into xq, scales into dxs), the bf16 form
// stages the f32 values themselves into xq[m * stride + c] (dxs unused).
template <int WF, int N, typename Fn>
__device__ void act_n(Fn f, int n, act_t<WF>* xq, int stride, float* dxs, float* red) {
  if constexpr (WF == kBf16) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
#pragma unroll
      for (int m = 0; m < N; ++m) xq[m * stride + c] = f(m, c);
    }
    __syncthreads();
  } else {
    quantize_n<N>(f, n, xq, stride, dxs, red);
  }
}
