// K5: the wkv6 recurrence over a whole sequence (v5/v6 prefill).
//
// Replaces rwkv_tpu/ops/chunked.py::wkv6_chunked_pallas (kernel body
// _wkv6_chunk_kernel), reached through wkv6_auto. Same function: for every
// (batch*head) bh, from state s0[bh] (S x S, row i = value dim, column j =
// key dim), per token t
//   y_i   = sum_j S_ij r_j + v_i * sum_j r_j tf_j k_j   (the OLD state)
//   S_ij <- S_ij w_j + k_j v_i
// giving y [T, BH, S] and the final state. Operands are [T, BH, S] f32
// (heads folded with batch, as wkv6_auto folds them; v5's static decay
// broadcast over T by the caller), tf [BH, S].
//
// Bound on this card: (5 T BH S + BH S + 2 BH S^2) * 4 bytes over HBM
// bandwidth (about 3.4 us at T=256, BH=32, S=64). The recurrence is
// sequential in T and there are only BH = 32 blocks at B=1 (1.6B width),
// so it is latency-bound far above that. Design: K2's (csrc/wkv7.cu)
// without the a/b terms: one block per bh; S*4 threads, four per state
// row i, each holding S/4 of the row and of tf in registers; the next
// token's operands are loaded into registers while the current token
// computes and staged through double-buffered shared memory, so each token
// costs one barrier. The chunked tensor-core form the TPU used is later
// work.
#include "common.cuh"

namespace {

constexpr int kTPR = 4;  // threads per state row

template <int S>
__global__ void __launch_bounds__(S * kTPR)
wkv6_seq(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ tf, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int T, int BH) {
  constexpr int JP = S / kTPR;  // state entries per thread
  __shared__ float sh[2][4][S];  // r, k, w, v
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / kTPR, p = tid % kTPR;  // row, part: j = jj * kTPR + p

  float st[JP], tfj[JP];
  const float* srow = s0 + (static_cast<size_t>(bh) * S + i) * S;
#pragma unroll
  for (int jj = 0; jj < JP; ++jj) {
    st[jj] = srow[jj * kTPR + p];
    tfj[jj] = tf[static_cast<size_t>(bh) * S + jj * kTPR + p];
  }

  const size_t stride = static_cast<size_t>(BH) * S;
  const bool loader = tid < S;
  size_t off = static_cast<size_t>(bh) * S + (loader ? tid : 0);
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;
  if (loader && T > 0) {
    nr = r[off]; nk = k[off]; nw = w[off]; nv = v[off];
  }
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (loader) {
      sh[buf][0][tid] = nr; sh[buf][1][tid] = nk; sh[buf][2][tid] = nw; sh[buf][3][tid] = nv;
    }
    __syncthreads();
    if (loader && t + 1 < T) {
      off += stride;
      nr = r[off]; nk = k[off]; nw = w[off]; nv = v[off];
    }
    const float* rs = sh[buf][0];
    const float* ks = sh[buf][1];
    const float* ws = sh[buf][2];
    const float vi = sh[buf][3][i];

    float yi = 0.f, dot = 0.f;
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = jj * kTPR + p;
      yi += st[jj] * rs[j];
      dot += rs[j] * tfj[jj] * ks[j];
      st[jj] = st[jj] * ws[j] + ks[j] * vi;
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1) {
      yi += __shfl_xor_sync(0xffffffffu, yi, o);
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    }
    if (p == 0) y[static_cast<size_t>(t) * stride + static_cast<size_t>(bh) * S + i] = yi + vi * dot;
  }
  float* orow = s_out + (static_cast<size_t>(bh) * S + i) * S;
#pragma unroll
  for (int jj = 0; jj < JP; ++jj) orow[jj * kTPR + p] = st[jj];
}

}  // namespace

// r, k, v, w: [T, BH, S] f32; tf: [BH, S]; s0, s_out: [BH, S, S];
// y: [T, BH, S]. S must be 32, 64 or 128.
extern "C" int rwkv_wkv6_seq(const void* r, const void* k, const void* v, const void* w,
                             const void* tf, const void* s0, void* y, void* s_out, int T,
                             int BH, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RWKV_WKV6_LAUNCH(SS)                                                   \
  wkv6_seq<SS><<<BH, SS * kTPR, 0, st>>>(                                      \
      static_cast<const float*>(r), static_cast<const float*>(k),              \
      static_cast<const float*>(v), static_cast<const float*>(w),              \
      static_cast<const float*>(tf), static_cast<const float*>(s0),            \
      static_cast<float*>(y), static_cast<float*>(s_out), T, BH)
  switch (S) {
    case 32: RWKV_WKV6_LAUNCH(32); break;
    case 64: RWKV_WKV6_LAUNCH(64); break;
    case 128: RWKV_WKV6_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RWKV_WKV6_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
