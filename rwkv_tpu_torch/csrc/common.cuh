// Shared helpers for the port's CUDA kernels (one shared library per .cu;
// each includes this header once).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

extern "C" const char* rwkv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide reductions for blockDim.x a multiple of 32 (at most 1024).
// `red` is 32 floats of shared scratch; every thread gets the result.
// Ends with a barrier, so `red` may be reused right after.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < n_warps ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < n_warps ? red[lane] : 0.f;
  t = warp_max(t);
  __syncthreads();
  return t;
}

// w8a8 activation code, as the JAX package computes it:
// clip(rint(x * inv), -127, 127) with inv = 1 / max(amax / 127, 1e-30)
// (0 when amax == 0). rintf rounds half to even, like jnp.rint.
__device__ __forceinline__ float act_inv_scale(float dx) {
  return dx > 0.f ? 1.0f / fmaxf(dx, 1e-30f) : 0.f;
}

__device__ __forceinline__ int8_t act_code(float x, float inv) {
  const float q = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}
