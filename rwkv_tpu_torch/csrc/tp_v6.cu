// K12 and K13: one layer of an RWKV v6 (Finch) decode step at B=1 on one
// shard of a tensor-parallel mesh, w8a8, w4a8 or bf16. One launch per
// shard per layer each; the caller sums the shards' full-C partials and
// gathers the FFN gate between them (ops/megakernel_tp.py).
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call_v6 (kernel
// _make_att_kernel_v6: K12) and _ffn_layer_call_v6 (_make_ffn_kernel_v6:
// K13; MIX45 = the v4/v5 token-shift mix its mix45 switch selects, the
// FFN of the v4 / v5 TP paths beside K14 / K15 in tp_v45.cu), in their
// int8, int4 and bf16 forms (maa2 stays f32 in all three).
//
// Bound on this card: bytes. At the 1.6B v6 width (C=2048, F=8192, d_maa
// 32, d_dec 64) and tp=2 a K12 launch reads its shard's rkvg rows (4 x
// 1024 x 2048) and out columns (2048 x 1024), the replicated maa1 (160 x
// 2048), dw1 (64 x 2048) and f32 maa2 (5 x 2048 x 32, 1.31 MB), its dw2
// rows, ~12.2 MB, and its wkv state twice (0.52 MB); a K13 launch its fr,
// fk and fv rows, ~18.9 MB int8: ~4 us and ~6 us at 3.35 TB/s.
//
// Design: the phases of K6 (v6_decode.cu) for one layer and one shard in a
// persistent cooperative kernel (one 256-thread block per SM, grid-wide
// barriers between phases):
//   K12  A  ln1, shift, xxx quantized, the maa1 rows with tanh (replicated)
//        M  the five maa2 up-projections in f32 (replicated, all 5C rows)
//           into the five mixes w, k, v, r, g
//        B  the mixes quantized, the shard's rkvg rows (r, k, v, silu(g))
//           and the whole dw1 (d_dec rows) with tanh
//        C  per head of the shard: its dw2 rows, exp(-exp(.)) decay, wkv6
//           with the time_faaaa bonus, group norm, ln_x, gate
//        D  the shard's xo quantized with its own scale, the C rows of out
//           into the partial (tp_out_rows, tp_common.cuh)
//   K13  A  ln2 + shift (v6's, or v4/v5's under MIX45), the two mixes
//           quantized, the shard's fk rows (nf tiles) with relu^2 and its
//           fr gate rows with sigmoid
//        B  per tile, its keys quantized with their own scale, the tile's
//           fv rows summed into the partial (tp_fv_tiles)
// Numerics follow the JAX kernels as K6 does (explicit round-to-nearest
// float ops; each matvec input quantized as a whole, the split
// contractions' inputs the shard's local slices with their own scales).
#include "tp_common.cuh"

namespace {

// rows of a shard's replicated vector block [L, kNumRVec6, C] and of its
// own [L, kNumLVec6, C/tp] (ops/megakernel_tp.py TP6_RVECS, TP6_LVECS)
enum RVec6 {
  kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRMaaX, kRFXK, kRFXR,
  kRMaa5,  // five rows: w, k, v, r, g
  kNumRVec6 = kRMaa5 + 5
};
enum LVec6 { kLTDecay = 0, kLLnxW, kLLnxB, kLTF, kNumLVec6 };

// Which of the five mixes (w, k, v, r, g) feeds each part of the fused
// rkvg rows (r, k, v, g).
__device__ __forceinline__ int rkvg_mix(int part) { return part == 0 ? 3 : part == 3 ? 4 : part; }

struct AttArgs {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* heads_in;   // [HL, S, S] the shard's heads
  const int8_t* rkvg;      // [4, CL, C] form WF
  const float* rkvg_d;     // [4 CL] (int forms)
  const int8_t* maa1;      // [5 DM, C] int8 (bf16)
  const float* maa1_d;     // [5 DM]
  const int8_t* dw1;       // [DD, C] int8 (bf16)
  const float* dw1_d;      // [DD]
  const int8_t* dw2;       // [CL, DD] int8 (bf16)
  const float* dw2_d;      // [CL]
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* maa2;       // [5C, DM] f32
  const float* rvec;       // [kNumRVec6, C]
  const float* lvec;       // [kNumLVec6, CL]
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x)
  float* heads_out;        // [HL, S, S]
  float* scratch;          // mixdn (5 DM) | mixes (5C) | r|k|v|silu(g) (4 CL) | dw1 downs (DD) | xo (CL)
  int C, CL, S, DM, DD;
};

// Floats of the per-head / maa2 staging area in shared memory.
__host__ __device__ inline int hv_floats(int S, int DM) { return 8 * S > 5 * DM ? 8 * S : 5 * DM; }

template <int WF>
__global__ void __launch_bounds__(kTpThreads) tp_v6_att_kernel(AttArgs p) {
  constexpr int LF = small_form(WF);  // the LoRAs' form
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, CL = p.CL, S = p.S, DM = p.DM, DD = p.DD, HL = CL / S;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_units = gridDim.x * (blockDim.x >> 5);
  const int unit = blockIdx.x * (blockDim.x >> 5) + (tid >> 5);

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x
  float* xl = xs + C;                           // [C] ln1(x), kept from A to M
  float* hv = xl + C;                           // [hv_floats] per-head vectors / mixdn
  float* red = hv + hv_floats(S, DM);           // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [5C] activations

  float* mixdn_g = p.scratch;        // [5 DM]
  float* mix_g = mixdn_g + 5 * DM;   // [5][C] w, k, v, r, g
  float* rkvg_g = mix_g + 5 * C;     // [4][CL] r, k, v, silu(g)
  float* dn_g = rkvg_g + 4 * CL;     // [DD]
  float* xo_g = dn_g + DD;           // [CL]
  const float* lv = p.lvec;

  // ---- A: ln1, shift, xxx, maa1 rows with tanh -----------------------------
  for (int c = tid; c < C; c += blockDim.x) xs[c] = p.x[c];
  __syncthreads();
  layer_norm_block(xs, xl, p.rvec + kRLn1W * C, p.rvec + kRLn1B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += blockDim.x) p.att_out[c] = xl[c];
  {
    const float* mx = p.rvec + kRMaaX * C;
    act_n<WF, 1>([&](int, int c) { return add(xl[c], mul(sub(p.att_in[c], xl[c]), mx[c])); }, C,
                 q8, 0, dxs, red);
    matvec_grid<LF, 1>(p.maa1, 5 * DM, C, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          mixdn_g[row] = tanhf(dequant(acc, dxs[0], p.maa1_d + row));
        });
  }
  grid.sync();

  // ---- M: maa2 up-projections (f32) into the five mixes --------------------
  {
    float* mdn = hv;  // [5 DM]
    for (int i = tid; i < 5 * DM; i += blockDim.x) mdn[i] = mixdn_g[i];
    __syncthreads();
    // lpr lanes share a maa2 row of DM floats, one float4 at a time
    const int pieces = DM >> 2;
    int lpr = 32;
    while (lpr > 1 && pieces % lpr) lpr >>= 1;
    const int gpw = 32 / lpr, sub_lane = lane % lpr, grp = lane / lpr;
    const float4* m2 = reinterpret_cast<const float4*>(p.maa2);
    const float* cf = p.rvec + kRMaa5 * C;  // row s * C + c: split s's coefficient
    for (int base = unit * gpw; base < 5 * C; base += n_units * gpw) {  // warp-uniform
      const int row = base + grp;
      float acc = 0.f;
      if (row < 5 * C) {
        const float* md = mdn + (row / C) * DM;
        for (int q = sub_lane; q < pieces; q += lpr) {
          const float4 w = m2[static_cast<size_t>(row) * pieces + q];
          acc = fmaf(w.x, md[4 * q], acc);
          acc = fmaf(w.y, md[4 * q + 1], acc);
          acc = fmaf(w.z, md[4 * q + 2], acc);
          acc = fmaf(w.w, md[4 * q + 3], acc);
        }
      }
      for (int off = lpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (sub_lane == 0 && row < 5 * C) {
        const int c = row % C;
        mix_g[row] = add(xl[c], mul(sub(p.att_in[c], xl[c]), add(cf[row], acc)));
      }
    }
  }
  grid.sync();

  // ---- B: the mixes quantized, rkvg rows, dw1 rows with tanh ---------------
  act_n<WF, 5>([&](int m, int c) { return mix_g[m * C + c]; }, C, q8, C, dxs, red);
  matvec_grid<WF, 1>(p.rkvg, 4 * CL, C, 1,
      [&](int row, int) { return q8 + rkvg_mix(row / CL) * C; },
      [&](int row, int, auto acc) {
        const int part = row / CL;
        float y = dequant(acc, dxs[rkvg_mix(part)], p.rkvg_d + row);
        if (part == 3) y = mul(y, sigmoidf(y));  // silu gate
        rkvg_g[row] = y;
      },
      lanes_for(C, WF));
  matvec_grid<LF, 1>(p.dw1, DD, C, 1, [&](int, int) { return q8; },  // mix w
      [&](int row, int, auto acc) { dn_g[row] = tanhf(dequant(acc, dxs[0], p.dw1_d + row)); },
      32, true);
  grid.sync();

  // ---- C: per head: dw2 rows, decay, wkv6, group norm, ln_x, gate ----------
  for (int h = blockIdx.x; h < HL; h += gridDim.x) {  // block-uniform
    float* h_r = hv;
    float* h_k = hv + S;
    float* h_v = hv + 2 * S;
    float* h_w = hv + 3 * S;
    float* h_y = hv + 4 * S;
    act_n<LF, 1>([&](int, int c) { return dn_g[c]; }, DD, q8, 0, dxs, red);
    const float* tdecay = lv + kLTDecay * CL;
    matvec_rows<LF, 1>(p.dw2, S, DD, tid >> 5, blockDim.x >> 5, 32, 1,
        [&](int r) { return h * S + r; }, [&](int, int) { return q8; },
        [&](int r, int, auto acc) {
          const int c = h * S + r;
          const float wl = add(dequant(acc, dxs[0], p.dw2_d + c), tdecay[c]);
          h_w[r] = expf(-expf(wl));
        });
    const int c = h * S + tid;
    float dot_part = 0.f;
    if (tid < S) {
      const float rr = rkvg_g[c], kk = rkvg_g[CL + c];
      h_r[tid] = rr;
      h_k[tid] = kk;
      h_v[tid] = rkvg_g[2 * CL + c];
      dot_part = mul(mul(rr, lv[kLTF * CL + c]), kk);
    }
    const float dot = block_sum(dot_part, red);  // also orders the h_* stores

    // state rows: tpr threads per row i, entries j = jj * tpr + part
    const int tpr = blockDim.x / S;
    const int jn = S / tpr;
    const int i = tid / tpr, part = tid % tpr;
    const size_t hoff = (static_cast<size_t>(h) * S + i) * S;
    const float* st_in = p.heads_in + hoff;
    float* st_out = p.heads_out + hoff;
    const float vi = h_v[i];
    float yi = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      if (jj < jn) {
        const int j = jj * tpr + part;
        const float st = st_in[j];
        yi += st * h_r[j];
        st_out[j] = add(mul(st, h_w[j]), mul(h_k[j], vi));
      }
    }
    for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
    if (part == 0) h_y[i] = add(yi, mul(vi, dot));
    __syncthreads();

    const float yv = tid < S ? h_y[tid] : 0.f;
    const float mu = block_sum(yv, red) / static_cast<float>(S);
    const float yc = tid < S ? sub(yv, mu) : 0.f;
    const float var = block_sum(mul(yc, yc), red) / static_cast<float>(S);
    if (tid < S) {
      const float yn = mul(yc, rsqrtf(add(var, 64e-5f)));
      const float xo = add(mul(yn, lv[kLLnxW * CL + c]), lv[kLLnxB * CL + c]);
      xo_g[c] = mul(xo, rkvg_g[3 * CL + c]);
    }
    __syncthreads();
  }
  grid.sync();

  // ---- D: the shard's partial of out --------------------------------------
  tp_out_rows<WF>(xo_g, p.out, p.out_d, p.part, C, CL, red, dxs, q8);
}

size_t att_smem(int C, int S, int DM, int wf) {
  return tp_smem(2ull * C + hv_floats(S, DM) + 8 * 32 + 8, 5ull * C, wf);
}

struct FfnArgs {
  const float* x;          // [C]
  const float* ffn_in;     // [C]
  const int8_t* fr;        // [CL, C] form WF: the shard's gate rows
  const float* fr_d;       // [CL]
  const int8_t* fk;        // [FL, C] form WF
  const float* fk_d;       // [FL]
  const int8_t* fv;        // [nf, C, FT] form WF
  const float* fv_d;       // [C]
  const float* rvec;       // [kNumRVec6, C]
  float* part;             // [C] the shard's partial of fv
  float* rg;               // [CL] sigmoid(fr rows)
  float* ffn_out;          // [C] ln2(x)
  float* scratch;          // [FL] relu^2 keys
  int C, CL, FL, nf;
};

template <int WF, bool MIX45>
__global__ void __launch_bounds__(kTpThreads) tp_v6_ffn_kernel(FfnArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C]
  float* xl = xs + C;                           // [C] ln2(x)
  float* red = xl + C;                          // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(2C, FT)]

  // ---- A: ln2 + shift, fk rows with relu^2, fr rows with sigmoid ----------
  for (int c = tid; c < C; c += blockDim.x) xs[c] = p.x[c];
  __syncthreads();
  layer_norm_block(xs, xl, p.rvec + kRLn2W * C, p.rvec + kRLn2B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += blockDim.x) p.ffn_out[c] = xl[c];
  const float* fx = p.rvec + kRFXK * C;  // rows k, r
  act_n<WF, 2>(
      [&](int m, int c) {
        const float cf = fx[m * C + c], prev = p.ffn_in[c];
        return MIX45 ? add(mul(xl[c], cf), sub(prev, mul(prev, cf)))
                     : add(xl[c], mul(sub(prev, xl[c]), cf));
      },
      C, q8, C, dxs, red);
  matvec_grid<WF, 1>(p.fk, p.FL, C, 1, [&](int, int) { return q8; },
      [&](int row, int, auto acc) {
        const float y = fmaxf(dequant(acc, dxs[0], p.fk_d + row), 0.f);
        p.scratch[row] = mul(y, y);
      },
      lanes_for(C, WF));
  matvec_grid<WF, 1>(p.fr, p.CL, C, 1, [&](int, int) { return q8 + C; },
      [&](int row, int, auto acc) { p.rg[row] = sigmoidf(dequant(acc, dxs[1], p.fr_d + row)); },
      lanes_for(C, WF), true);
  grid.sync();

  // ---- B: the fv tiles into the partial ------------------------------------
  tp_fv_tiles<WF>(p.scratch, p.fv, p.fv_d, p.part, C, p.FL, p.nf, red, dxs, q8);
}

size_t ffn_smem(int C, int FT, int wf) {
  return tp_smem(2ull * C + 8 * 32 + 8, 2 * C > FT ? 2 * C : FT, wf);
}

const void* att_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v6_att_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v6_att_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v6_att_kernel<kInt8>);
}

template <int WF>
const void* ffn_of(bool mix45) {
  return mix45 ? reinterpret_cast<const void*>(tp_v6_ffn_kernel<WF, true>)
               : reinterpret_cast<const void*>(tp_v6_ffn_kernel<WF, false>);
}

// v6's FFN (mix45 false), or the MIX45 instance the v4 / v5 TP paths take
// (their replicated block holds ln2 and the FFN mixes at RVec6's rows)
const void* ffn_kernel(int wf, bool mix45) {
  if (wf == kBf16) return ffn_of<kBf16>(mix45);
  return wf == kInt4 ? ffn_of<kInt4>(mix45) : ffn_of<kInt8>(mix45);
}

int att_launch(int wf, const void* x, const void* att_in, const void* heads_in, const void* rkvg,
               const void* rkvg_d, const void* maa1, const void* maa1_d, const void* dw1,
               const void* dw1_d, const void* dw2, const void* dw2_d, const void* out,
               const void* out_d, const void* maa2, const void* rvec, const void* lvec,
               void* part, void* att_out, void* heads_out, void* scratch, int C, int CL, int S,
               int DM, int DD, int grid_blocks, void* stream) {
  if (kTpThreads % S != 0 || S * S / kTpThreads > kMaxJ || CL % S != 0 || DM % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AttArgs a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.rkvg = static_cast<const int8_t*>(rkvg);
  a.rkvg_d = static_cast<const float*>(rkvg_d);
  a.maa1 = static_cast<const int8_t*>(maa1);
  a.maa1_d = static_cast<const float*>(maa1_d);
  a.dw1 = static_cast<const int8_t*>(dw1);
  a.dw1_d = static_cast<const float*>(dw1_d);
  a.dw2 = static_cast<const int8_t*>(dw2);
  a.dw2_d = static_cast<const float*>(dw2_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.maa2 = static_cast<const float*>(maa2);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.S = S; a.DM = DM; a.DD = DD;
  return tp_launch(att_kernel(wf), a, att_smem(C, S, DM, wf), grid_blocks, stream);
}

int ffn_launch(int wf, bool mix45, const void* x, const void* ffn_in, const void* fr,
               const void* fr_d, const void* fk, const void* fk_d, const void* fv,
               const void* fv_d, const void* rvec, void* part, void* rg, void* ffn_out,
               void* scratch, int C, int CL, int FL, int nf, int grid_blocks, void* stream) {
  if (nf <= 0 || FL % nf != 0) return static_cast<int>(cudaErrorInvalidValue);
  FfnArgs a;
  a.x = static_cast<const float*>(x);
  a.ffn_in = static_cast<const float*>(ffn_in);
  a.fr = static_cast<const int8_t*>(fr);
  a.fr_d = static_cast<const float*>(fr_d);
  a.fk = static_cast<const int8_t*>(fk);
  a.fk_d = static_cast<const float*>(fk_d);
  a.fv = static_cast<const int8_t*>(fv);
  a.fv_d = static_cast<const float*>(fv_d);
  a.rvec = static_cast<const float*>(rvec);
  a.part = static_cast<float*>(part);
  a.rg = static_cast<float*>(rg);
  a.ffn_out = static_cast<float*>(ffn_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.FL = FL; a.nf = nf;
  return tp_launch(ffn_kernel(wf, mix45), a, ffn_smem(C, FL / nf, wf), grid_blocks, stream);
}

}  // namespace

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code) and one launch, of
// K12, K13 and K13's MIX45 form (rwkv_tp_v45_ffn*, the v4 / v5 FFN). The
// bf16 ones read no scales (pass null).
#define RWKV_TP_V6_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *heads_in, const void *rkvg,                    \
      const void *rkvg_d, const void *maa1, const void *maa1_d, const void *dw1,                \
      const void *dw1_d, const void *dw2, const void *dw2_d, const void *out,                   \
      const void *out_d, const void *maa2, const void *rvec, const void *lvec, void *part,      \
      void *att_out, void *heads_out, void *scratch, int C, int CL, int S, int DM, int DD,      \
      int grid_blocks, void *stream
#define RWKV_TP_V6_ATT_ARGS                                                                     \
  x, att_in, heads_in, rkvg, rkvg_d, maa1, maa1_d, dw1, dw1_d, dw2, dw2_d, out, out_d, maa2,    \
      rvec, lvec, part, att_out, heads_out, scratch, C, CL, S, DM, DD, grid_blocks, stream
#define RWKV_TP_V6_FFN_PARAMS                                                                   \
  const void *x, const void *ffn_in, const void *fr, const void *fr_d, const void *fk,          \
      const void *fk_d, const void *fv, const void *fv_d, const void *rvec, void *part,         \
      void *rg, void *ffn_out, void *scratch, int C, int CL, int FL, int nf, int grid_blocks,   \
      void *stream
#define RWKV_TP_V6_FFN_ARGS                                                                     \
  x, ffn_in, fr, fr_d, fk, fk_d, fv, fv_d, rvec, part, rg, ffn_out, scratch, C, CL, FL, nf,    \
      grid_blocks, stream

#define RWKV_TP_V6_ENTRIES(suffix, wf)                                                          \
  extern "C" int rwkv_tp_v6_att##suffix##_grid(int C, int S, int DM) {                         \
    return tp_grid_blocks(att_kernel(wf), att_smem(C, S, DM, wf));                             \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_att##suffix(RWKV_TP_V6_ATT_PARAMS) {                               \
    return att_launch(wf, RWKV_TP_V6_ATT_ARGS);                                                 \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_ffn##suffix##_grid(int C, int FT) {                                \
    return tp_grid_blocks(ffn_kernel(wf, false), ffn_smem(C, FT, wf));                          \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_ffn##suffix(RWKV_TP_V6_FFN_PARAMS) {                               \
    return ffn_launch(wf, false, RWKV_TP_V6_FFN_ARGS);                                          \
  }                                                                                             \
  extern "C" int rwkv_tp_v45_ffn##suffix##_grid(int C, int FT) {                               \
    return tp_grid_blocks(ffn_kernel(wf, true), ffn_smem(C, FT, wf));                           \
  }                                                                                             \
  extern "C" int rwkv_tp_v45_ffn##suffix(RWKV_TP_V6_FFN_PARAMS) {                              \
    return ffn_launch(wf, true, RWKV_TP_V6_FFN_ARGS);                                           \
  }

RWKV_TP_V6_ENTRIES(, kInt8)
RWKV_TP_V6_ENTRIES(_w4, kInt4)
RWKV_TP_V6_ENTRIES(_bf16, kBf16)
