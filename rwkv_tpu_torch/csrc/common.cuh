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

// ---- the decode kernels' matvec (K3, K4, K6, K7, K8) ----------------------
//
// Weight rows come in one of three forms (WF): int8 codes (kInt8, K bytes
// a row), int4 codes (kInt4, K/2 bytes a row) or bf16 values (kBf16, 2K
// bytes a row). An int4 row is packed in 16-byte chunks:
// byte j of chunk c holds code 32c + j in its low nibble and code
// 32c + 16 + j in its high nibble, both two's complement. Masking a word
// with 0xF0 per byte (after a 4-bit left shift for the low nibbles) gives
// each code times 16 as an exact int8, so one __dp4a per four codes
// accumulates 16x the integer dot; it is exact in int32 (|16 * 7 * 127| *
// K < 2^31 for K < 150,000) and the wrapper shifts it back by 4 bits.
// The float epilogue float(acc) * dx * d then equals the JAX package's
// float(16 * acc) * (dx / 16) * d bit for bit: both factors of 16 are
// powers of two, which scale a float exactly.
//
// The int forms dot the rows against int8 activation codes into an exact
// int32 sum. The bf16 form (the JAX package's quant=False kernels: bf16
// weights widened in registers, f32 products at full precision) dots them
// against f32 activations: a 16-byte chunk holds 8 values, each widened to
// f32 exactly by shifting its bits 16 left, and FMAs into an f32 sum; the
// result differs from an f32 product of the widened rows only in the order
// of the sums.
enum WForm : int { kInt8 = 0, kInt4 = 1, kBf16 = 2 };

// What a matvec of form WF reads its activations as (int8 codes or f32)
// and accumulates into (exact int32 or f32).
template <int WF> struct FormTraits {
  using Act = int8_t;
  using Acc = int;
};
template <> struct FormTraits<kBf16> {
  using Act = float;
  using Acc = float;
};
template <int WF> using act_t = typename FormTraits<WF>::Act;

// The form of the matrices that stay int8 under w4a8 (the LoRAs and the
// head): int8 in both int forms, bf16 in the bf16 form.
__host__ __device__ constexpr int small_form(int wf) { return wf == kBf16 ? kBf16 : kInt8; }

// Bytes of n weights of form wf.
__host__ __device__ constexpr size_t form_bytes(int wf, size_t n) {
  return wf == kInt4 ? n / 2 : wf == kBf16 ? 2 * n : n;
}

constexpr int kMaxChunksPerLane = 8;  // 16-byte weight chunks a lane holds at once

__device__ __forceinline__ int w4_lo16(int w) {
  return static_cast<int>((static_cast<unsigned>(w) << 4) & 0xF0F0F0F0u);
}
__device__ __forceinline__ int w4_hi16(int w) {
  return static_cast<int>(static_cast<unsigned>(w) & 0xF0F0F0F0u);
}
// the bf16 value in the low / high half of a 32-bit word, as f32 (exact)
__device__ __forceinline__ float bf16_lo(int w) {
  return __uint_as_float(static_cast<unsigned>(w) << 16);
}
__device__ __forceinline__ float bf16_hi(int w) {
  return __uint_as_float(static_cast<unsigned>(w) & 0xFFFF0000u);
}

// Rows [0, nrows) of a matvec against up to NB activation columns in
// shared memory (nb of them used, nb <= NB, the same in every thread).
// Row r reads weight row rowmap(r) of W and, for column b, the activations
// at xsel(r, b) (16-byte aligned, K of them: int8 codes, or f32 in the bf16
// form); epi(r, b, acc) gets the exact int32 dot (int forms) or the f32 dot
// (bf16). Rows are spread over warps unit, unit + n_units, ... (the grid's
// or one block's); lpr lanes (at most max_lpr) share a row, each lane
// reading whole 16-byte chunks of it, at most kMaxChunksPerLane at a time,
// so a row is read from memory once for all nb columns.
template <int WF, int NB, typename RowMap, typename XSel, typename Epi>
__device__ void matvec_rows(const int8_t* __restrict__ W, int nrows, int K, int unit,
                            int n_units, int max_lpr, int nb, RowMap rowmap, XSel xsel,
                            Epi epi) {
  using Acc = typename FormTraits<WF>::Acc;
  const int row_bytes = static_cast<int>(form_bytes(WF, K));
  const int nchunks = row_bytes >> 4;
  int lpr = max_lpr;
  while (lpr > 1 && (nchunks % lpr) != 0) lpr >>= 1;
  const int per_lane = nchunks / lpr;
  const int lane = threadIdx.x & 31;
  const int sub_lane = lane % lpr;
  const int grp = lane / lpr;
  const int gpw = 32 / lpr;
  for (int base = unit * gpw; base < nrows; base += n_units * gpw) {  // warp-uniform
    const int row = base + grp;
    Acc acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0;
    if (row < nrows) {
      const int4* wr =
          reinterpret_cast<const int4*>(W + static_cast<size_t>(rowmap(row)) * row_bytes);
      for (int c0 = 0; c0 < per_lane; c0 += kMaxChunksPerLane) {
        int4 wv[kMaxChunksPerLane];
#pragma unroll
        for (int c = 0; c < kMaxChunksPerLane; ++c)
          if (c0 + c < per_lane) wv[c] = __ldg(wr + (c0 + c) * lpr + sub_lane);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          if (b < nb) {
            const act_t<WF>* xcol = xsel(row, b);
#pragma unroll
            for (int c = 0; c < kMaxChunksPerLane; ++c) {
              if (c0 + c < per_lane) {
                const int chunk = (c0 + c) * lpr + sub_lane;
                Acc a = acc[b];
                if constexpr (WF == kBf16) {
                  const float4* xb = reinterpret_cast<const float4*>(xcol);
                  const float4 x0 = xb[2 * chunk], x1 = xb[2 * chunk + 1];
                  a = fmaf(bf16_lo(wv[c].x), x0.x, a);
                  a = fmaf(bf16_hi(wv[c].x), x0.y, a);
                  a = fmaf(bf16_lo(wv[c].y), x0.z, a);
                  a = fmaf(bf16_hi(wv[c].y), x0.w, a);
                  a = fmaf(bf16_lo(wv[c].z), x1.x, a);
                  a = fmaf(bf16_hi(wv[c].z), x1.y, a);
                  a = fmaf(bf16_lo(wv[c].w), x1.z, a);
                  a = fmaf(bf16_hi(wv[c].w), x1.w, a);
                } else if constexpr (WF == kInt4) {
                  const int4* xb = reinterpret_cast<const int4*>(xcol);
                  const int4 xl = xb[2 * chunk], xh = xb[2 * chunk + 1];
                  a = __dp4a(w4_lo16(wv[c].x), xl.x, a);
                  a = __dp4a(w4_lo16(wv[c].y), xl.y, a);
                  a = __dp4a(w4_lo16(wv[c].z), xl.z, a);
                  a = __dp4a(w4_lo16(wv[c].w), xl.w, a);
                  a = __dp4a(w4_hi16(wv[c].x), xh.x, a);
                  a = __dp4a(w4_hi16(wv[c].y), xh.y, a);
                  a = __dp4a(w4_hi16(wv[c].z), xh.z, a);
                  a = __dp4a(w4_hi16(wv[c].w), xh.w, a);
                } else {
                  const int4 xv = reinterpret_cast<const int4*>(xcol)[chunk];
                  a = __dp4a(wv[c].x, xv.x, a);
                  a = __dp4a(wv[c].y, xv.y, a);
                  a = __dp4a(wv[c].z, xv.z, a);
                  a = __dp4a(wv[c].w, xv.w, a);
                }
                acc[b] = a;
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        Acc a = acc[b];
        for (int off = lpr >> 1; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (sub_lane == 0 && row < nrows) {
          if constexpr (WF == kInt4) {
            epi(row, b, a >> 4);
          } else {
            epi(row, b, a);
          }
        }
      }
    }
  }
}
