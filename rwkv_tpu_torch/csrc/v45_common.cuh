// Pieces shared by the v5 (K7, v5_decode.cu) and v4 (K8, v4_decode.cu)
// whole-model decode kernels and their tensor-parallel shard kernels (K15,
// K14: tp_v45.cu): the per-layer layout of the flat pack, the token-shift
// mix in the reference's op order, which mix feeds each fused attention
// projection, v4's max-trick wkv on one channel, v5's wkv step of one head
// on a whole block (K15; K7 runs its own over the consumers of its
// stream), and K8's FFN phases E and F.
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

// v5's wkv step of one head on one block (blockDim.x a multiple of S, S * S
// / blockDim.x <= kMaxJ): r, k, v, the static decay w and the bonus tf hold
// the head's S values, st_in / st_out its S x S state (row i = value dim).
// The output reads the OLD state plus the bonus, then the state decays and
// takes k v^T; the output is group-normed (eps 1e-5) and handed to
// yn_out(i, yn) on thread i < S. hv: 5S floats of shared memory. Ends with
// a barrier.
template <typename YOut>
__device__ void v5_head_step(const float* r, const float* k, const float* v, const float* w,
                             const float* tf, const float* st_in, float* st_out, int S,
                             float* hv, float* red, YOut yn_out) {
  const int tid = threadIdx.x;
  float* h_r = hv;
  float* h_k = hv + S;
  float* h_v = hv + 2 * S;
  float* h_w = hv + 3 * S;
  float* h_y = hv + 4 * S;
  float dot_part = 0.f;
  if (tid < S) {
    const float rr = r[tid], kk = k[tid];
    h_r[tid] = rr;
    h_k[tid] = kk;
    h_v[tid] = v[tid];
    h_w[tid] = w[tid];
    dot_part = mul(mul(rr, tf[tid]), kk);
  }
  const float dot = block_sum(dot_part, red);  // also orders the h_* stores

  // state rows: tpr threads per row i, entries j = jj * tpr + part
  const int tpr = blockDim.x / S;
  const int jn = S / tpr;
  const int i = tid / tpr, part = tid % tpr;
  const float* st_row = st_in + static_cast<size_t>(i) * S;
  float* st_row_out = st_out + static_cast<size_t>(i) * S;
  const float vi = h_v[i];
  float yi = 0.f;
#pragma unroll
  for (int jj = 0; jj < kMaxJ; ++jj) {
    if (jj < jn) {
      const int j = jj * tpr + part;
      const float st = st_row[j];
      yi += st * h_r[j];
      st_row_out[j] = add(mul(st, h_w[j]), mul(h_k[j], vi));
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
  if (part == 0) h_y[i] = add(yi, mul(vi, dot));
  __syncthreads();

  const float yv = tid < S ? h_y[tid] : 0.f;
  const float mu = block_sum(yv, red) / static_cast<float>(S);
  const float yc = tid < S ? sub(yv, mu) : 0.f;
  const float var = block_sum(mul(yc, yc), red) / static_cast<float>(S);
  if (tid < S) yn_out(tid, mul(yc, rsqrtf(add(var, 1e-5f))));
  __syncthreads();
}

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
