// K2: the wkv7 recurrence over a whole sequence (prefill).
//
// Replaces rwkv_tpu/ops/chunked.py::wkv7_chunked_pallas (kernel body
// _wkv7_chunk_kernel_grouped), reached through wkv7_auto. Same function:
// for every (batch*head) bh, from state s0[bh] (S x S, row i = value dim,
// column j = key dim), per token t
//   sa_i   = sum_j a_j S_ij
//   S_ij  <- S_ij w_j + k_j v_i + sa_i b_j
//   y_i    = sum_j S_ij r_j
// giving y [T, BH, S] and the final state. Operands are [T, BH, S] f32
// (heads folded with batch, as wkv7_auto folds them).
//
// Bound on this card: (7 T BH S + 2 BH S^2) * 4 bytes over HBM bandwidth
// (about 1.8 us at T=256, BH=12, S=64). The recurrence is sequential in T
// and there are only BH = 12 blocks at B=1, so it is latency-bound far above
// that. Design: one block per bh; S*4 threads, four per state row i, each
// holding S/4 of the row in registers (shorter dependency chains than one
// thread per row); the next token's operands are loaded into registers
// while the current token computes, and staged through double-buffered
// shared memory, so each token costs one barrier. The chunked
// tensor-core form the TPU used is later work.
#include "common.cuh"

namespace {

constexpr int kTPR = 4;  // threads per state row

template <int S>
__global__ void __launch_bounds__(S * kTPR)
wkv7_seq(const float* __restrict__ r, const float* __restrict__ w,
         const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ a, const float* __restrict__ b,
         const float* __restrict__ s0, float* __restrict__ y,
         float* __restrict__ s_out, int T, int BH) {
  constexpr int JP = S / kTPR;  // state entries per thread
  __shared__ float sh[2][6][S];  // r, w, k, a, b, v
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / kTPR, p = tid % kTPR;  // row, part: j = jj * kTPR + p

  float st[JP];
  const float* srow = s0 + (static_cast<size_t>(bh) * S + i) * S;
#pragma unroll
  for (int jj = 0; jj < JP; ++jj) st[jj] = srow[jj * kTPR + p];

  const size_t stride = static_cast<size_t>(BH) * S;
  const bool loader = tid < S;
  size_t off = static_cast<size_t>(bh) * S + (loader ? tid : 0);
  float nr = 0.f, nw = 0.f, nk = 0.f, na = 0.f, nb = 0.f, nv = 0.f;
  if (loader && T > 0) {
    nr = r[off]; nw = w[off]; nk = k[off]; na = a[off]; nb = b[off]; nv = v[off];
  }
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (loader) {
      sh[buf][0][tid] = nr; sh[buf][1][tid] = nw; sh[buf][2][tid] = nk;
      sh[buf][3][tid] = na; sh[buf][4][tid] = nb; sh[buf][5][tid] = nv;
    }
    __syncthreads();
    if (loader && t + 1 < T) {
      off += stride;
      nr = r[off]; nw = w[off]; nk = k[off]; na = a[off]; nb = b[off]; nv = v[off];
    }
    const float* rs = sh[buf][0];
    const float* ws = sh[buf][1];
    const float* ks = sh[buf][2];
    const float* as = sh[buf][3];
    const float* bs = sh[buf][4];
    const float vi = sh[buf][5][i];

    float sa = 0.f;
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) sa += as[jj * kTPR + p] * st[jj];
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1) sa += __shfl_xor_sync(0xffffffffu, sa, o);

    float yi = 0.f;
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = jj * kTPR + p;
      st[jj] = st[jj] * ws[j] + ks[j] * vi + sa * bs[j];
      yi += st[jj] * rs[j];
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, o);
    if (p == 0) y[static_cast<size_t>(t) * stride + static_cast<size_t>(bh) * S + i] = yi;
  }
  float* orow = s_out + (static_cast<size_t>(bh) * S + i) * S;
#pragma unroll
  for (int jj = 0; jj < JP; ++jj) orow[jj * kTPR + p] = st[jj];
}

}  // namespace

// r, w, k, v, a, b: [T, BH, S] f32; s0, s_out: [BH, S, S]; y: [T, BH, S].
// S must be 32, 64 or 128.
extern "C" int rwkv_wkv7_seq(const void* r, const void* w, const void* k,
                             const void* v, const void* a, const void* b,
                             const void* s0, void* y, void* s_out, int T,
                             int BH, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RWKV_WKV7_LAUNCH(SS)                                                   \
  wkv7_seq<SS><<<BH, SS * kTPR, 0, st>>>(                                      \
      static_cast<const float*>(r), static_cast<const float*>(w),              \
      static_cast<const float*>(k), static_cast<const float*>(v),              \
      static_cast<const float*>(a), static_cast<const float*>(b),              \
      static_cast<const float*>(s0), static_cast<float*>(y),                   \
      static_cast<float*>(s_out), T, BH)
  switch (S) {
    case 32: RWKV_WKV7_LAUNCH(32); break;
    case 64: RWKV_WKV7_LAUNCH(64); break;
    case 128: RWKV_WKV7_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RWKV_WKV7_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
