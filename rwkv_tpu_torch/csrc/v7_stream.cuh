// The time mix of one RWKV v7 head on the consumers of a streamed block:
// K3's phase C (v7_decode.cu) and K10's phase B (tp_v7.cu), the same steps
// in the same order as v7_common.cuh's v7_head_step, which K3 and K10 ran
// before they took their inputs from the stream.
#pragma once

#include "decode_stream.cuh"
#include "v7_common.cuh"

namespace stream {

// Head h's step from its pieces of the stream: first its state [S, S] with
// its eight vector slices (w0, a0, v0, kk, ka, ln_x w, ln_x b, r_k; in
// K10 a ninth, the layer-0 value, where vf_staged), then its 4 x S lora2
// rows (decay, a gate, output gate, value gate), l2_runs runs of S rows a
// piece with their scales, against the four lora downs already quantized
// in q8 (scales dxs[0..3]). Thread tid < S holds the head's channel tid of
// r, k, v (rr, kraw, vv) and, where not vf_staged, of the layer-0 value
// (vf). first: v is the layer-0 value, handed to v_out(v) on thread tid;
// otherwise the value residual mixes it in. Row i of the new state goes to
// st_row(i), the output (xo + bonus) * g of thread tid to xo_out(v). The
// outputs' addresses are the caller's lambdas, computed where they are
// used, as K3 did before it shared this step (held across the step, they
// cost K3 registers at its cap). next() runs once the head's inputs are
// read, so the caller may fetch the next head's meanwhile. hv: 10 S floats
// of shared memory. Ends with the head's pieces released.
template <int LF, typename StRow, typename VOut, typename XoOut, typename Next>
__device__ __forceinline__ void v7_stream_head(Stream& cs, int l2_runs, int S, int D, float rr,
                                               float kraw, float vv, float vf, bool first,
                                               bool vf_staged, StRow st_row, VOut v_out,
                                               XoOut xo_out, float* hv, float* red,
                                               const float* dxs, const act_t<LF>* q8,
                                               Next next) {
  const int tid = threadIdx.x;
  const int l2_pieces = (4 + l2_runs - 1) / l2_runs;
  const int lg_s = __ffs(S) - 1;  // S divides 256: a power of two
  const int lg_tpr = __ffs(kConsumers >> lg_s) - 1;
  const size_t l2_rb = form_bytes(LF, D);
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
  // the head's state [S, S], then its slices of w0, a0, v0, kk, ka, ln_x w,
  // ln_x b, r_k (and the layer-0 value)
  const float* st = reinterpret_cast<const float*>(cs.wait());
  const float* w0 = st + S * S;
  const float* a0 = w0 + S;
  const float* v0 = a0 + S;
  const float* kkw = v0 + S;
  const float* kaw = kkw + S;
  const float* lnx_w = kaw + S;
  const float* lnx_b = lnx_w + S;
  const float* rkw = lnx_b + S;
  // the 4 x S lora2 rows of the head's channels (decay, a gate, output gate,
  // value gate), l2_runs runs a piece, one lane a row
  for (int q0 = 0; q0 < 4; q0 += l2_runs) {
    const int nq = q0 + l2_runs < 4 ? l2_runs : 4 - q0;
    const unsigned char* rows = cs.wait();
    const float* d2 = reinterpret_cast<const float*>(rows + nq * S * l2_rb);
    smem_rows<LF>(rows, nq * S, D, 1, q0 * S,
        [&](int r) { return q8 + (q0 + (r >> lg_s)) * D; },
        [&](int r, auto acc) {
          const int part = q0 + (r >> lg_s), i = r & (S - 1);
          const float y = dequant(acc, dxs[part], d2 + r);
          if (part == 0) {
            h_w[i] = expf(mul(sigmoidf(add(y, w0[i])), -0.606531f));
          } else if (part == 1) {
            h_ag[i] = sigmoidf(add(y, a0[i]));
          } else if (part == 2) {
            h_g[i] = y;
          } else {
            h_vm[i] = sigmoidf(add(y, v0[i]));
          }
        });
  }
  csync();

  float kkv = 0.f;
  if (tid < S) {
    if (vf_staged) vf = rkw[S + tid];
    kkv = mul(kraw, kkw[tid]);
  }
  next();
  const float nrm = sqrtf(block_sum(mul(kkv, kkv), red));
  float dot_part = 0.f;
  if (tid < S) {
    const float kk = kkv / fmaxf(nrm, 1e-12f);
    const float ka = mul(kraw, kaw[tid]);
    const float ag = h_ag[tid];
    const float knew = add(kraw, sub(mul(ag, ka), ka));
    if (first) {
      v_out(vv);
    } else {
      vv = add(vv, mul(sub(vf, vv), h_vm[tid]));
    }
    h_r[tid] = rr;
    h_k[tid] = knew;
    h_a[tid] = -kk;
    h_b[tid] = mul(kk, ag);
    h_v[tid] = vv;
    dot_part = mul(mul(knew, rr), rkw[tid]);
  }
  const float dot = block_sum(dot_part, red);  // also orders the h_* stores

  // state rows: tpr threads per row i, entries jx = jj * tpr + part (read
  // from the stage in both passes)
  const int tpr = 1 << lg_tpr;
  const int jn = S >> lg_tpr;
  const int i = tid >> lg_tpr, part = tid & (tpr - 1);
  const float* st_in = st + i * S;
  float* st_o = st_row(i);
  float sa = 0.f;
#pragma unroll
  for (int jj = 0; jj < kMaxJ; ++jj) {
    if (jj < jn) {
      const int jx = jj * tpr + part;
      sa += h_a[jx] * st_in[jx];
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) sa += __shfl_xor_sync(0xffffffffu, sa, off);
  const float vi = h_v[i];
  float yi = 0.f;
#pragma unroll
  for (int jj = 0; jj < kMaxJ; ++jj) {
    if (jj < jn) {
      const int jx = jj * tpr + part;
      const float s2 = add(add(mul(st_in[jx], h_w[jx]), mul(h_k[jx], vi)), mul(sa, h_b[jx]));
      st_o[jx] = s2;
      yi += s2 * h_r[jx];
    }
  }
  for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
  if (part == 0) h_y[i] = yi;
  csync();

  const float yv = tid < S ? h_y[tid] : 0.f;
  const float mu = block_sum(yv, red) / static_cast<float>(S);
  const float yc = tid < S ? sub(yv, mu) : 0.f;
  const float var = block_sum(mul(yc, yc), red) / static_cast<float>(S);
  if (tid < S) {
    const float yn = mul(yc, rsqrtf(add(var, 64e-5f)));
    const float xo = add(mul(yn, lnx_w[tid]), lnx_b[tid]);
    const float bonus = mul(h_v[tid], dot);
    xo_out(mul(add(xo, bonus), h_g[tid]));
  }
  csync();
  cs.release(1 + l2_pieces);
}

}  // namespace stream
