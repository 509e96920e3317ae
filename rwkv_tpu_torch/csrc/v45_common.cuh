// Pieces shared by the v5 (K7, v5_decode.cu) and v4 (K8, v4_decode.cu)
// whole-model decode kernels and their tensor-parallel shard kernels (K15,
// tp_v6.cu; K14, tp_v45.cu): the per-layer layout of the flat pack, the
// token-shift mix in the reference's op order, which mix feeds each fused
// attention projection, v4's max-trick wkv on one channel, and the grid
// size of a cooperative launch.
#pragma once

#include "decode_common.cuh"

// The vector rows a layer starts with in the [L, rows, C] block
// (megakernel.py's V45_VEC_KEYS, then _v45_blocks' fmix, td, tf); K7 and K8
// append their own rows after kTF.
enum VecRow45 { kLn1W = 0, kLn1B, kLn2W, kLn2B, kFmixK, kFmixR, kTD, kTF, kNumVec45 };

// Byte offsets of a layer's five matrices in the flat pack's [L, bytes]
// buffer (att | out | fk | fv | fr), and the layer's size, for weight form
// wf. att holds NA fused projections of C rows (v4 and v5.1 r, k, v; v5.2
// r, k, v, g). Under w4 all five hold int4 codes, two a byte; in the bf16
// form all five are bf16.
struct MatOffsets45 {
  size_t att, out, fk, fv, fr, layer;
  __host__ __device__ MatOffsets45(int C, int F, int NA, int wf) {
    att = 0;
    out = att + form_bytes(wf, 1ull * NA * C * C);
    fk = out + form_bytes(wf, 1ull * C * C);
    fv = fk + form_bytes(wf, 1ull * F * C);
    fr = fv + form_bytes(wf, 1ull * C * F);
    layer = fr + form_bytes(wf, 1ull * C * C);
  }
};

// Row scales of a layer (int forms), in the same order: NA C + C + F + C + C
// floats.
struct ScaleOffsets45 {
  size_t att, out, fk, fv, fr, layer;
  __host__ __device__ ScaleOffsets45(int C, int F, int NA) {
    att = 0;
    out = att + 1ull * NA * C;
    fk = out + C;
    fv = fk + F;
    fr = fv + C;
    layer = fr + C;
  }
};

// The v4/v5 token-shift mix x*c + (prev - prev*c), rounded as the
// reference's op order rounds it (not v6's sx * maa + xl).
__device__ __forceinline__ float mix45(float x, float prev, float c) {
  return add(mul(x, c), sub(prev, mul(prev, c)));
}

// Which attention mix (amix order k, v, r, g) feeds part `part` of the
// fused att rows (r, k, v, g).
__device__ __forceinline__ int att_mix(int part) { return part == 0 ? 2 : part == 3 ? 3 : part - 1; }

// v4's max-trick wkv (rwkv_graph.inc:119-161) on one channel: the output
// from the old state aa, bb, pp and the bonus tf ...
__device__ __forceinline__ float wkv4_out(float tf, float k, float v, float aa, float bb,
                                          float pp) {
  const float ww = add(tf, k);
  const float qq = fmaxf(pp, ww);
  const float e1 = expf(sub(pp, qq)), e2 = expf(sub(ww, qq));
  return __fdiv_rn(add(mul(e1, aa), mul(e2, v)), add(mul(e1, bb), e2));
}

// ... and the channel's new state with the decay td. A blank state's pp =
// -1e30 gives exp(pp - qq) = 0 in both, never NaN.
__device__ __forceinline__ void wkv4_state(float td, float k, float v, float aa, float bb,
                                           float pp, float* aa_out, float* bb_out,
                                           float* pp_out) {
  const float ww2 = add(pp, td);
  const float qq2 = fmaxf(ww2, k);
  const float e1 = expf(sub(ww2, qq2)), e2 = expf(sub(k, qq2));
  *aa_out = add(mul(e1, aa), mul(e2, v));
  *bb_out = add(mul(e1, bb), e2);
  *pp_out = qq2;
}

// Grid size a cooperative launch of `kernel` uses (one block per SM), or a
// negative CUDA error code (0: the kernel does not fit on an SM).
inline int cooperative_grid(const void* kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (per_sm > 1 ? 1 : per_sm) * sms;
}
