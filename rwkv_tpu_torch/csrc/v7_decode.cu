// K3: one RWKV v7 decode step at B=1 for all layers, w8a8, with ln_out and
// the LM head inside the kernel. One launch per token.
//
// Replaces rwkv_tpu/ops/megakernel.py::v7_decode_megakernel (kernel body
// _make_kernel, head phases _emit_head_phases), w8a8 variant.
//
// Bound on this card: the step streams every weight once -- at 169M about
// 12 x 7.47 MB of int8 matrices, ~0.1 MB/layer of scales and vectors,
// 0.39 MB/layer of wkv state read and written, and the 50.3 MB int8 head,
// ~146 MB in all -- so HBM bandwidth bounds it (~44 us at 3.35 TB/s).
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, one
// 256-thread block per SM) whose phases are separated by grid-wide
// barriers, five per layer:
//   A  ln1 + six-way token-shift mix, the six mixes quantized as whole
//      vectors in one pass (every block redundantly; C is small), then the
//      rkv and lora1 rows
//   C  per head (one block each): the four lora downs quantized, the lora2
//      rows of the head's own channels (decay, a gate, output gate, value
//      gate), kk l2-norm, k update, value residual, wkv7 state update,
//      group norm, r_k bonus, gate
//   D  out rows + residual      E  ln2 + shift, fk rows with relu^2
//   F  fv rows + residual
// then ln_out and the head rows. Weight rows are spread over every warp of
// the grid with 16-byte loads and __dp4a (s8 x s8 -> s32), so the weight
// stream keeps the whole card's memory system busy. The step is bound by
// latency, not bytes: each phase is a chain of block reductions and
// dependent loads, so phases are few and each quantization is one pass and
// one block reduction.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole (amax over all of it, codes rint(x * inv) clipped to +-127), the
// int32 sum is scaled as (float(acc) * dx) * d, and the elementwise formulas
// are evaluated with explicit round-to-nearest multiplies and adds so that
// no fused multiply-add shifts an activation across a code boundary.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunksPerLane = 8;  // K <= 16 * 8 * 32 = 4096
constexpr int kMaxJ = 16;             // S * S / kThreads <= 16  (S <= 64)

// rows of the per-layer vector block [L, kNumVec, C]
enum VecRow {
  kLn1W = 0, kLn1B, kLn2W, kLn2B, kW0, kA0, kV0, kKK, kKA, kLnxW, kLnxB, kXK,
  kCoeff,          // six rows: r, w, k, v, a, g
  kRK = kCoeff + 6,
  kNumVec
};

struct Args {
  const int* token;
  const uint16_t* emb;      // bf16 bits [V, C]
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, 4C^2 + 8DC + 2FC]: rkv|lora1|lora2|out|fk|fv
  const float* scales;      // [L, 9C + 4D + F] in the same order
  const float* vecs;        // [L, kNumVec, C]
  const int8_t* head;       // [V, C]
  const float* head_d;      // [V]
  const float* ln_out;      // [2, C]
  const float* att_in;      // [L, C]
  const float* ffn_in;      // [L, C]
  const float* heads_in;    // [L, H, S, S]
  float* att_out;
  float* ffn_out;
  float* heads_out;
  float* logits;            // [V]
  float* scratch;           // scratch_floats(C, D, F); x ends at scratch[0..C)
  int C, H, S, D, F, L, V;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / add(1.0f, expf(-x)); }
__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// Block-wide layer norm of src[0..n) into dst (both shared), as
// (x - mu) * rsqrt(var + eps) * w + b with population variance.
__device__ void layer_norm_block(const float* src, float* dst, const float* w,
                                 const float* b, int n, float eps, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) s += src[c];
  const float mu = block_sum(s, red) / static_cast<float>(n);
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float d = sub(src[c], mu);
    v += mul(d, d);
  }
  const float var = block_sum(v, red) / static_cast<float>(n);
  const float rs = rsqrtf(add(var, eps));
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    dst[c] = add(mul(mul(sub(src[c], mu), rs), w[c]), b[c]);
  __syncthreads();
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

// Rows [0, nrows) of a matvec against int8 vectors in shared memory: row r
// reads weight row rowmap(r) of W (int8, K per row, 16-byte aligned) and
// the vector xsel(r); epi(r, acc) gets the exact int32 dot. Rows are spread
// over warps unit, unit + n_units, ... (the grid's or one block's); lpr
// lanes (at most max_lpr) share a row, each lane reading whole 16-byte
// chunks. Fewer lanes per row put more loads in flight per lane and more
// rows in each round of a warp.
template <typename RowMap, typename XSel, typename Epi>
__device__ void matvec_rows(const int8_t* __restrict__ W, int nrows, int K, int unit,
                            int n_units, int max_lpr, RowMap rowmap, XSel xsel, Epi epi) {
  const int nchunks = K >> 4;
  int lpr = max_lpr;
  while (lpr > 1 && (nchunks % lpr) != 0) lpr >>= 1;
  const int per_lane = nchunks / lpr;
  const int lane = threadIdx.x & 31;
  const int sub_lane = lane % lpr;
  const int grp = lane / lpr;
  const int gpw = 32 / lpr;
  for (int base = unit * gpw; base < nrows; base += n_units * gpw) {  // warp-uniform
    const int row = base + grp;
    int acc = 0;
    if (row < nrows) {
      const int4* wr = reinterpret_cast<const int4*>(W + static_cast<size_t>(rowmap(row)) * K);
      const int4* xr = reinterpret_cast<const int4*>(xsel(row));
      int4 wv[kMaxChunksPerLane];
#pragma unroll
      for (int c = 0; c < kMaxChunksPerLane; ++c)
        if (c < per_lane) wv[c] = __ldg(wr + c * lpr + sub_lane);
#pragma unroll
      for (int c = 0; c < kMaxChunksPerLane; ++c) {
        if (c < per_lane) {
          const int4 xv = xr[c * lpr + sub_lane];
          acc = __dp4a(wv[c].x, xv.x, acc);
          acc = __dp4a(wv[c].y, xv.y, acc);
          acc = __dp4a(wv[c].z, xv.z, acc);
          acc = __dp4a(wv[c].w, xv.w, acc);
        }
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub_lane == 0 && row < nrows) epi(row, acc);
  }
}

// All rows of a matvec, spread over every warp of the grid.
template <typename XSel, typename Epi>
__device__ void matvec_grid(const int8_t* __restrict__ W, int nrows, int K, XSel xsel, Epi epi,
                            int max_lpr = 32) {
  const int warps_per_block = blockDim.x >> 5;
  matvec_rows(W, nrows, K, blockIdx.x * warps_per_block + (threadIdx.x >> 5),
              gridDim.x * warps_per_block, max_lpr, [](int r) { return r; }, xsel, epi);
}

// Which of the six mixes (r, w, k, v, a, g) feeds each part of the fused
// rows: rkv = r, k, v; lora1 = w, a, g, v.
__device__ __forceinline__ int rkv_mix(int part) { return part == 0 ? 0 : part + 1; }
__device__ __forceinline__ int lora1_mix(int part) {
  return part == 0 ? 1 : part == 3 ? 3 : part + 3;
}

// Floats of the kernel's global scratch (the residual stream and the
// vectors passed between phases); the Python wrapper allocates the same.
__host__ __device__ inline size_t scratch_floats(int C, int D, int F) {
  return 7ull * C + 4ull * D + F;
}

#ifdef RWKV_V7_PHASE_TIMES
// Timing build (scripts/probe_torch_decode.py --phases): thread 0 of block 0
// stamps %globaltimer at every phase boundary into the scratch tail.
#define PHASE_MARK()                                               \
  do {                                                             \
    if (blockIdx.x == 0 && tid == 0) {                             \
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

__device__ __forceinline__ float dequant(int acc, float dx, float d) {
  return mul(mul(__int2float_rn(acc), dx), d);
}

__global__ void __launch_bounds__(kThreads)
v7_decode_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, H = p.H, S = p.S, D = p.D, F = p.F;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [max(C, F)] residual / input
  float* xl = xs + (C > F ? C : F);              // [C] normalized
  float* hv = xl + C;                            // [12][S] per-head vectors
  float* red = hv + 12 * S;                      // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  int8_t* q8 = reinterpret_cast<int8_t*>(dxs + 8);  // [max(6C, F, 4D)]

  float* x_g = p.scratch;          // residual stream
  float* r_g = x_g + C;
  float* k_g = r_g + C;
  float* v_g = k_g + C;
  float* dn_g = v_g + C;           // 4 x D: tanh(w), a, sigmoid(g), v downs
  float* vf_g = dn_g + 4 * D;      // layer-0 value
  float* xo_g = vf_g + C;          // attention output before `out`
  float* fk_g = xo_g + C;          // [F] relu^2 keys

#ifdef RWKV_V7_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, D, F));
  int n_marks = 0;
#endif
  // a grid-wide barrier, with a timestamp on each side in the timing build
  auto barrier = [&]() {
    PHASE_MARK();
    grid.sync();
    PHASE_MARK();
  };
  PHASE_MARK();

  const size_t mat_layer = 4ull * C * C + 8ull * D * C + 2ull * F * C;
  const size_t sc_layer = 9ull * C + 4ull * D + F;

  for (int l = 0; l < p.L; ++l) {
    const int8_t* m_rkv = p.mats + l * mat_layer;
    const int8_t* m_l1 = m_rkv + 3ull * C * C;
    const int8_t* m_l2 = m_l1 + 4ull * D * C;
    const int8_t* m_out = m_l2 + 4ull * C * D;
    const int8_t* m_fk = m_out + 1ull * C * C;
    const int8_t* m_fv = m_fk + 1ull * F * C;
    const float* s_rkv = p.scales + l * sc_layer;
    const float* s_l1 = s_rkv + 3 * C;
    const float* s_l2 = s_l1 + 4 * D;
    const float* s_out = s_l2 + 4 * C;
    const float* s_fk = s_out + C;
    const float* s_fv = s_fk + F;
    const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec * C;
    const float* att_in = p.att_in + static_cast<size_t>(l) * C;
    const float* ffn_in = p.ffn_in + static_cast<size_t>(l) * C;

    // ---- phase A: ln1, shift mixes, rkv + lora1 rows --------------------
    if (l == 0) {
      const uint16_t* e = p.emb + static_cast<size_t>(*p.token) * C;
      for (int c = tid; c < C; c += blockDim.x) xl[c] = bf16_to_float(e[c]);
      __syncthreads();
      layer_norm_block(xl, xs, p.ln0, p.ln0 + C, C, 1e-5f, red);
      if (blockIdx.x == 0)
        for (int c = tid; c < C; c += blockDim.x) x_g[c] = xs[c];
    } else {
      for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
      __syncthreads();
    }
    layer_norm_block(xs, xl, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      // xl + (x_prev - xl) * coeff[m], m = r, w, k, v, a, g
      const float* cf = vec + kCoeff * C;
      quantize_n<6>(
          [&](int m, int c) { return add(xl[c], mul(sub(att_in[c], xl[c]), cf[m * C + c])); },
          C, q8, C, dxs, red);
      // rkv rows take mixes r(0), k(2), v(3); lora1 rows w(1), a(4), g(5), v(3)
      const int n_rkv = 3 * C;
      matvec_grid(m_rkv, n_rkv + 4 * D, C,
          [&](int row) {
            const int m = row < n_rkv ? rkv_mix(row / C) : lora1_mix((row - n_rkv) / D);
            return q8 + m * C;
          },
          [&](int row, int acc) {
            if (row < n_rkv) {
              const int part = row / C;
              const float y = dequant(acc, dxs[rkv_mix(part)], s_rkv[row]);
              (part == 0 ? r_g : part == 1 ? k_g : v_g)[row - part * C] = y;
            } else {
              const int r = row - n_rkv, part = r / D;
              float y = dequant(acc, dxs[lora1_mix(part)], s_l1[r]);
              if (part == 0) y = tanhf(y);
              if (part == 2) y = sigmoidf(y);
              dn_g[r] = y;
            }
          });
    }
    barrier();

    // ---- phase C: per head: lora2 rows, wkv7 step, group norm, gate -----
    for (int h = blockIdx.x; h < H; h += gridDim.x) {  // block-uniform
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
      // the four downs, each quantized as a whole, then the 4 x S lora2
      // rows of this head's channels (row m * C + h * S + i)
      quantize_n<4>([&](int m, int c) { return dn_g[m * D + c]; }, D, q8, D, dxs, red);
      // one lane per row: all 4 x S rows in one round of the block's warps
      matvec_rows(m_l2, 4 * S, D, tid >> 5, blockDim.x >> 5, 1,
          [&](int r) { return (r / S) * C + h * S + r % S; },
          [&](int r) { return q8 + (r / S) * D; },
          [&](int r, int acc) {
            const int part = r / S, i = r % S, c = h * S + i;
            const float y = dequant(acc, dxs[part], s_l2[part * C + c]);
            if (part == 0) {
              h_w[i] = expf(mul(sigmoidf(add(y, vec[kW0 * C + c])), -0.606531f));
            } else if (part == 1) {
              h_ag[i] = sigmoidf(add(y, vec[kA0 * C + c]));
            } else if (part == 2) {
              h_g[i] = y;
            } else {
              h_vm[i] = sigmoidf(add(y, vec[kV0 * C + c]));
            }
          });
      __syncthreads();

      const int c = h * S + tid;
      float kkv = 0.f, kraw = 0.f, rr = 0.f;
      if (tid < S) {
        kraw = k_g[c];
        rr = r_g[c];
        kkv = mul(kraw, vec[kKK * C + c]);
      }
      const float nrm = sqrtf(block_sum(mul(kkv, kkv), red));
      float dot_part = 0.f;
      if (tid < S) {
        const float kk = kkv / fmaxf(nrm, 1e-12f);
        const float ka = mul(kraw, vec[kKA * C + c]);
        const float ag = h_ag[tid];
        const float knew = add(kraw, sub(mul(ag, ka), ka));
        float vv = v_g[c];
        if (l == 0) {
          vf_g[c] = vv;
        } else {
          vv = add(vv, mul(sub(vf_g[c], vv), h_vm[tid]));
        }
        h_r[tid] = rr;
        h_k[tid] = knew;
        h_a[tid] = -kk;
        h_b[tid] = mul(kk, ag);
        h_v[tid] = vv;
        dot_part = mul(mul(knew, rr), vec[kRK * C + c]);
      }
      const float dot = block_sum(dot_part, red);  // also orders the h_* stores

      // state rows: tpr threads per row i, entries j = jj * tpr + part
      const int tpr = blockDim.x / S;
      const int jn = S / tpr;
      const int i = tid / tpr, part = tid % tpr;
      const size_t hoff = ((static_cast<size_t>(l) * H + h) * S + i) * S;
      const float* st_in = p.heads_in + hoff;
      float* st_out = p.heads_out + hoff;
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
        const float xo = add(mul(yn, vec[kLnxW * C + c]), vec[kLnxB * C + c]);
        const float bonus = mul(h_v[tid], dot);
        xo_g[c] = mul(add(xo, bonus), h_g[tid]);
      }
      __syncthreads();
    }
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    quantize_n<1>([&](int, int c) { return xo_g[c]; }, C, q8, 0, dxs, red);
    matvec_grid(m_out, C, C, [&](int) { return q8; },
        [&](int row, int acc) { x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_out[row])); });
    barrier();

    // ---- phase E: ln2 + shift, fk rows with relu^2 -------------------------
    for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
    __syncthreads();
    layer_norm_block(xs, xl, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.ffn_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      const float* xk = vec + kXK * C;
      quantize_n<1>([&](int, int c) { return add(xl[c], mul(sub(ffn_in[c], xl[c]), xk[c])); },
                    C, q8, 0, dxs, red);
      matvec_grid(m_fk, F, C, [&](int) { return q8; },
          [&](int row, int acc) {
            const float y = fmaxf(dequant(acc, dxs[0], s_fk[row]), 0.f);
            fk_g[row] = mul(y, y);
          });
    }
    barrier();

    // ---- phase F: fv rows + residual --------------------------------------
    for (int c = tid; c < F; c += blockDim.x) xs[c] = fk_g[c];
    __syncthreads();
    quantize_n<1>([&](int, int c) { return xs[c]; }, F, q8, 0, dxs, red);
    matvec_grid(m_fv, C, F, [&](int) { return q8; },
        [&](int row, int acc) { x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_fv[row])); });
    barrier();
  }

  // ---- head: ln_out, quantize, V rows -------------------------------------
  for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
  __syncthreads();
  layer_norm_block(xs, xl, p.ln_out, p.ln_out + C, C, 1e-5f, red);
  quantize_n<1>([&](int, int c) { return xl[c]; }, C, q8, 0, dxs, red);
  // eight lanes per row: V rows take half the rounds of the default
  matvec_grid(p.head, p.V, C, [&](int) { return q8; },
      [&](int row, int acc) { p.logits[row] = dequant(acc, dxs[0], p.head_d[row]); }, 8);
  PHASE_MARK();
}

size_t smem_bytes(int C, int S, int F, int D) {
  int q = 6 * C;
  if (F > q) q = F;
  if (4 * D > q) q = 4 * D;
  const size_t floats = static_cast<size_t>(C > F ? C : F) + C + 12ull * S + 8 * 32 + 8;
  return floats * sizeof(float) + ((q + 15) / 16) * 16;
}

}  // namespace

// Grid size the launch below uses (blocks), or a negative CUDA error code.
extern "C" int rwkv_v7_decode_grid(int C, int S, int D, int F) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, v7_decode_kernel, kThreads, smem_bytes(C, S, F, D));
  if (err != cudaSuccess) return -static_cast<int>(err);
  // one block per SM: measured ~2% faster than two (fewer blocks at each
  // barrier and in each redundant preamble), scripts/probe_torch_decode.py
  if (per_sm > 1) per_sm = 1;
  return per_sm * sms;
}

extern "C" int rwkv_v7_decode(const void* token, const void* emb, const void* ln0,
                              const void* mats, const void* scales, const void* vecs,
                              const void* head, const void* head_d, const void* ln_out,
                              const void* att_in, const void* ffn_in, const void* heads_in,
                              void* att_out, void* ffn_out, void* heads_out,
                              void* logits, void* scratch,
                              int C, int H, int S, int D, int F, int L, int V,
                              int grid_blocks, void* stream) {
  if (grid_blocks <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.token = static_cast<const int*>(token);
  a.emb = static_cast<const uint16_t*>(emb);
  a.ln0 = static_cast<const float*>(ln0);
  a.mats = static_cast<const int8_t*>(mats);
  a.scales = static_cast<const float*>(scales);
  a.vecs = static_cast<const float*>(vecs);
  a.head = static_cast<const int8_t*>(head);
  a.head_d = static_cast<const float*>(head_d);
  a.ln_out = static_cast<const float*>(ln_out);
  a.att_in = static_cast<const float*>(att_in);
  a.ffn_in = static_cast<const float*>(ffn_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.att_out = static_cast<float*>(att_out);
  a.ffn_out = static_cast<float*>(ffn_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.logits = static_cast<float*>(logits);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.H = H; a.S = S; a.D = D; a.F = F; a.L = L; a.V = V;
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(v7_decode_kernel), dim3(grid_blocks), dim3(kThreads),
      kargs, smem_bytes(C, S, F, D), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
