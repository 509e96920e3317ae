// Pieces shared by the RWKV v7 decode kernels K3 (v7_decode.cu, B=1 with
// the LM head) and K4 (v7_decode_batched.cu, B sequences, no head): the
// flat pack's layout and the per-(sequence, head) step of the time mix
// (lora2 rows of the head, wkv7, group norm, gate). What the v6 kernel
// shares with them is in decode_common.cuh.
#pragma once

#include "decode_common.cuh"

// rows of the per-layer vector block [L, kNumVec, C]
enum VecRow {
  kLn1W = 0, kLn1B, kLn2W, kLn2B, kW0, kA0, kV0, kKK, kKA, kLnxW, kLnxB, kXK,
  kCoeff,          // six rows: r, w, k, v, a, g
  kRK = kCoeff + 6,
  kNumVec
};

// Byte offsets of a layer's six matrices in the flat pack's [L, bytes]
// buffer (rkv | lora1 | lora2 | out | fk | fv), and the layer's size, for
// weight form wf. Under w4 the big ones (rkv, out, fk, fv) hold int4 codes,
// two a byte, and the LoRAs int8; in the bf16 form all six are bf16.
struct MatOffsets {
  size_t rkv, l1, l2, out, fk, fv, layer;
  __host__ __device__ MatOffsets(int C, int D, int F, int wf) {
    const int sf = small_form(wf);
    rkv = 0;
    l1 = rkv + form_bytes(wf, 3ull * C * C);
    l2 = l1 + form_bytes(sf, 4ull * D * C);
    out = l2 + form_bytes(sf, 4ull * C * D);
    fk = out + form_bytes(wf, 1ull * C * C);
    fv = fk + form_bytes(wf, 1ull * F * C);
    layer = fv + form_bytes(wf, 1ull * C * F);
  }
};

// Which of the six mixes (r, w, k, v, a, g) feeds each part of the fused
// rows: rkv = r, k, v; lora1 = w, a, g, v.
__device__ __forceinline__ int rkv_mix(int part) { return part == 0 ? 0 : part + 1; }
__device__ __forceinline__ int lora1_mix(int part) {
  return part == 0 ? 1 : part == 3 ? 3 : part + 3;
}

// The per-channel vectors the time mix of a head reads, each indexed by
// channel: rows of a layer's [kNumVec, C] block in K3 and K4 (head_vecs),
// rows of a shard's [8, C/tp] block in K10 (tp_v7.cu).
struct HeadVecs {
  const float *w0, *a0, *v0, *kk, *ka, *lnx_w, *lnx_b, *rk;
};

__device__ __forceinline__ HeadVecs head_vecs(const float* vec, int C) {
  return {vec + kW0 * C, vec + kA0 * C,   vec + kV0 * C,   vec + kKK * C,
          vec + kKA * C, vec + kLnxW * C, vec + kLnxB * C, vec + kRK * C};
}

// One sequence's vectors and state for the per-head step.
struct HeadIO {
  const float* r;       // [C] receptance
  const float* k;       // [C] key (before the a-gate update)
  const float* v;       // [C] value (before the value residual)
  const float* dn;      // [4D] lora downs: tanh(w), a, sigmoid(g), v
  float* vf;            // [C] the layer-0 value (written at l == 0)
  float* xo;            // [C] attention output before `out`
  const float* st_in;   // [H, S, S] this layer's wkv state (i = value dim)
  float* st_out;
};

// The time mix of head h for one sequence, by the whole block: the four
// lora downs quantized as whole vectors (bf16 form: staged in f32), the
// 4 x S lora2 rows of the head's own channels (decay, a gate, output gate,
// value gate), kk l2 norm, k update, value residual, wkv7 state update,
// group norm, r_k bonus, gate. C is the channels of io's vectors (the
// lora2 rows are [4, C, D], their scales [4, C]); l == 0 sets v_first.
// Shared scratch: hv 12 * S floats, red 256 floats, dxs 4 floats, q8 4D
// activations. blockDim.x must be a multiple of S with
// S * S / blockDim.x <= kMaxJ.
template <int WF>
__device__ void v7_head_step(int l, int h, const HeadIO& io, const int8_t* m_l2,
                             const float* s_l2, const HeadVecs& vec, int C, int S, int D,
                             float* hv, float* red, float* dxs, act_t<WF>* q8) {
  constexpr int LF = small_form(WF);
  const int tid = threadIdx.x;
  float* h_r = hv;
  float* h_w = hv + S;       // decay
  float* h_k = hv + 2 * S;
  float* h_a = hv + 3 * S;
  float* h_b = hv + 4 * S;
  float* h_v = hv + 5 * S;
  float* h_y = hv + 6 * S;
  float* h_ag = hv + 7 * S;  // a gate
  float* h_g = hv + 8 * S;   // output gate
  float* h_vm = hv + 9 * S;  // value-residual gate
  act_n<LF, 4>([&](int m, int c) { return io.dn[m * D + c]; }, D, q8, D, dxs, red);
  // one lane per row: all 4 x S rows in one round of the block's warps
  matvec_rows<LF, 1>(m_l2, 4 * S, D, tid >> 5, blockDim.x >> 5, 1, 1,
      [&](int r) { return (r / S) * C + h * S + r % S; },
      [&](int r, int) { return q8 + (r / S) * D; },
      [&](int r, int, auto acc) {
        const int part = r / S, i = r % S, c = h * S + i;
        const float y = dequant(acc, dxs[part], s_l2 + part * C + c);
        if (part == 0) {
          h_w[i] = expf(mul(sigmoidf(add(y, vec.w0[c])), -0.606531f));
        } else if (part == 1) {
          h_ag[i] = sigmoidf(add(y, vec.a0[c]));
        } else if (part == 2) {
          h_g[i] = y;
        } else {
          h_vm[i] = sigmoidf(add(y, vec.v0[c]));
        }
      });
  __syncthreads();

  const int c = h * S + tid;
  float kkv = 0.f, kraw = 0.f, rr = 0.f;
  if (tid < S) {
    kraw = io.k[c];
    rr = io.r[c];
    kkv = mul(kraw, vec.kk[c]);
  }
  const float nrm = sqrtf(block_sum(mul(kkv, kkv), red));
  float dot_part = 0.f;
  if (tid < S) {
    const float kk = kkv / fmaxf(nrm, 1e-12f);
    const float ka = mul(kraw, vec.ka[c]);
    const float ag = h_ag[tid];
    const float knew = add(kraw, sub(mul(ag, ka), ka));
    float vv = io.v[c];
    if (l == 0) {
      io.vf[c] = vv;
    } else {
      vv = add(vv, mul(sub(io.vf[c], vv), h_vm[tid]));
    }
    h_r[tid] = rr;
    h_k[tid] = knew;
    h_a[tid] = -kk;
    h_b[tid] = mul(kk, ag);
    h_v[tid] = vv;
    dot_part = mul(mul(knew, rr), vec.rk[c]);
  }
  const float dot = block_sum(dot_part, red);  // also orders the h_* stores

  // state rows: tpr threads per row i, entries j = jj * tpr + part
  const int tpr = blockDim.x / S;
  const int jn = S / tpr;
  const int i = tid / tpr, part = tid % tpr;
  const size_t hoff = (static_cast<size_t>(h) * S + i) * S;
  const float* st_in = io.st_in + hoff;
  float* st_out = io.st_out + hoff;
  float st[kMaxJ];
  float sa = 0.f;
#pragma unroll
  for (int jj = 0; jj < kMaxJ; ++jj) {
    if (jj < jn) {
      const int j = jj * tpr + part;
      st[jj] = st_in[j];
      sa += h_a[j] * st[jj];
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) sa += __shfl_xor_sync(0xffffffffu, sa, off);
  const float vi = h_v[i];
  float yi = 0.f;
#pragma unroll
  for (int jj = 0; jj < kMaxJ; ++jj) {
    if (jj < jn) {
      const int j = jj * tpr + part;
      const float s2 = add(add(mul(st[jj], h_w[j]), mul(h_k[j], vi)), mul(sa, h_b[j]));
      st_out[j] = s2;
      yi += s2 * h_r[j];
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
  if (part == 0) h_y[i] = yi;
  __syncthreads();

  const float yv = tid < S ? h_y[tid] : 0.f;
  const float mu = block_sum(yv, red) / static_cast<float>(S);
  const float yc = tid < S ? sub(yv, mu) : 0.f;
  const float var = block_sum(mul(yc, yc), red) / static_cast<float>(S);
  if (tid < S) {
    const float yn = mul(yc, rsqrtf(add(var, 64e-5f)));
    const float xo = add(mul(yn, vec.lnx_w[c]), vec.lnx_b[c]);
    const float bonus = mul(h_v[tid], dot);
    io.xo[c] = mul(add(xo, bonus), h_g[tid]);
  }
  __syncthreads();
}
