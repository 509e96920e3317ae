// Pieces shared by the v5 (K7, v5_decode.cu) and v4 (K8, v4_decode.cu)
// whole-model decode kernels: the per-layer layout of their flat pack, the
// token-shift mix in the reference's op order, which mix feeds each fused
// attention projection, and the FFN phases E and F.
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

// Phases E and F of a v4/v5 layer, each ending in `barrier`: ln2 of the
// residual x_g and the token shift (block 0 writes ln2's output to
// ffn_out), the two mixes quantized as whole vectors, the fk rows with
// relu^2 into fk_g and the fr rows with sigmoid into rg_g; then the fv rows,
// x += sigmoid(fr) * fv. Shared: xs and xl C floats each, red 256 floats,
// dxs two, q8 max(2C, F) activations (bf16 form: staged in f32).
template <int WF, typename Barrier>
__device__ void ffn_v45(const float* vec, const int8_t* m_layer, const float* s_layer,
                        const MatOffsets45& mo, const ScaleOffsets45& so, const float* ffn_in,
                        float* ffn_out, float* x_g, float* rg_g, float* fk_g, int C, int F,
                        float* xs, float* xl, float* red, float* dxs, act_t<WF>* q8,
                        Barrier barrier) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) xs[c] = x_g[c];
  __syncthreads();
  layer_norm_block(xs, xl, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < C; c += blockDim.x) ffn_out[c] = xl[c];
  const float* fx = vec + kFmixK * C;  // rows k, r
  act_n<WF, 2>([&](int m, int c) { return mix45(xl[c], ffn_in[c], fx[m * C + c]); }, C, q8, C,
               dxs, red);
  matvec_grid<WF, 1>(m_layer + mo.fk, F, C, 1, [&](int, int) { return q8; },
      [&](int row, int, auto acc) {
        const float y = fmaxf(dequant(acc, dxs[0], s_layer + so.fk + row), 0.f);
        fk_g[row] = mul(y, y);
      },
      lanes_for(C, WF));
  matvec_grid<WF, 1>(m_layer + mo.fr, C, C, 1, [&](int, int) { return q8 + C; },
      [&](int row, int, auto acc) {
        rg_g[row] = sigmoidf(dequant(acc, dxs[1], s_layer + so.fr + row));
      },
      lanes_for(C, WF), true);
  barrier();

  act_n<WF, 1>([&](int, int c) { return fk_g[c]; }, F, q8, 0, dxs, red);
  matvec_grid<WF, 1>(m_layer + mo.fv, C, F, 1, [&](int, int) { return q8; },
      [&](int row, int, auto acc) {
        x_g[row] = add(x_g[row], mul(rg_g[row], dequant(acc, dxs[0], s_layer + so.fv + row)));
      },
      lanes_for(F, WF));
  barrier();
}

// The residual before layer l's phase A into xs (shared; every block): at
// l = 0 ln0 of the token's embedding row (bf16, or f32 when emb_f32; block
// 0 also writes it to x_g), else x_g.
__device__ __forceinline__ void load_residual(int l, const int* token, const void* emb,
                                              bool emb_f32, const float* ln0, float* x_g, int C,
                                              float* xs, float* tmp, float* red) {
  if (l == 0) {
    const size_t e = static_cast<size_t>(*token) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) tmp[c] = emb_at(emb, emb_f32, e + c);
    __syncthreads();
    layer_norm_block(tmp, xs, ln0, ln0 + C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = threadIdx.x; c < C; c += blockDim.x) x_g[c] = xs[c];
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x) xs[c] = x_g[c];
    __syncthreads();
  }
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
