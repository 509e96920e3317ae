// K10 and K11: one layer of an RWKV v7 decode step at B=1 on one shard of
// a tensor-parallel mesh, w8a8, w4a8 or bf16. One launch per shard per
// layer each; the caller sums the shards' full-C partials (all_reduce in
// ops/megakernel_tp.py) between them.
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call (kernel
// _make_att_kernel: K10) and _ffn_layer_call (_make_ffn_kernel: K11), in
// their int8 (w8a8), int4 (w4a8: matv4) and bf16 (quant=False) forms.
//
// Bound on this card: bytes. At the World 1.5B v7 width (C=2048, F=8192,
// d_lora 96) and tp=2 a K10 launch reads its shard's rkv rows (3 x 1024 x
// 2048), the whole lora1 (4 x 96 x 2048: replicated, so every shard reads
// it), its lora2 rows and out columns (2048 x 1024), ~9.2 MB int8, and
// the shard's wkv state (16 heads, 0.26 MB) twice; a K11 launch its fk
// rows and fv columns, 2 x 4096 x 2048 = 16.8 MB int8. At 3.35 TB/s that
// is ~3 us and ~5 us a launch; the int4 form halves the big matrices, the
// bf16 form doubles every matrix.
//
// Design: the phases of K3 (v7_decode.cu) for one layer and one shard, in
// a persistent cooperative kernel (one 256-thread block per SM, grid-wide
// barriers between phases):
//   K10  A  ln1 + six-way token-shift mix of the replicated x, the six
//           mixes quantized as whole vectors (every block), the shard's
//           rkv rows (3 C/tp) and the whole lora1 (4 d_lora rows)
//        B  per head of the shard (one block each): v7_head_step
//           (v7_common.cuh) on the shard's channels -- lora2 rows, kk,
//           value residual (v_first written when `first`, read otherwise),
//           wkv7, group norm, r_k bonus, gate
//        C  the shard's xo quantized with its own scale, the C rows of out
//           [C, C/tp] into the partial (tp_out_rows, tp_common.cuh)
//   K11  A  ln2 + shift, quantized, the shard's fk rows (F/tp, nf tiles)
//           with relu^2
//        B  per tile, its keys quantized with their own scale and the C
//           rows of the tile's fv summed into the partial (tp_fv_tiles)
// Weight rows are spread over every warp of the grid with 16-byte loads
// and __dp4a (matvec_rows, common.cuh). A launch is bound by latency: two
// (K10) or one (K11) grid barriers and a chain of block reductions for
// ~3-5 us of bytes.
//
// Numerics follow the JAX kernels (explicit round-to-nearest float ops,
// IEEE division in the activation scale): each matvec input is quantized
// as a whole, and the split contractions' inputs are the shard's local
// slices with their own scales, as the TP kernels do (and the single-device
// ones do not). The bf16 form stages f32 activations and reads no scales.
#include "v7_common.cuh"
#include "tp_common.cuh"

namespace {

// rows of a shard's replicated vector block [L, kNumRVec7, C] and of its
// own [L, kNumLVec7, C/tp] (ops/megakernel_tp.py TP_RVECS, TP_LVECS)
enum RVec7 { kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRXK, kRCoeff, kNumRVec7 = kRCoeff + 6 };
enum LVec7 { kLW0 = 0, kLA0, kLV0, kLKK, kLKA, kLLnxW, kLLnxB, kLRK, kNumLVec7 };

struct AttArgs {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* heads_in;   // [HL, S, S] the shard's heads
  float* vf;               // [CL] v_first: written when first, read otherwise
  const int8_t* rkv;       // [3, CL, C] form WF
  const float* rkv_d;      // [3 CL] (int forms)
  const int8_t* lora1;     // [4D, C] int8 (bf16)
  const float* lora1_d;    // [4D]
  const int8_t* lora2;     // [4, CL, D] int8 (bf16)
  const float* lora2_d;    // [4 CL]
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* rvec;       // [kNumRVec7, C]
  const float* lvec;       // [kNumLVec7, CL]
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x), the new att_xx
  float* heads_out;        // [HL, S, S]
  float* scratch;          // r | k | v (CL each), lora downs (4D), xo (CL)
  int C, CL, S, D, first;
};

template <int WF>
__global__ void __launch_bounds__(kTpThreads) tp_v7_att_kernel(AttArgs p) {
  constexpr int LF = small_form(WF);  // the LoRAs' form
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, CL = p.CL, S = p.S, D = p.D, HL = CL / S;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x
  float* xl = xs + C;                           // [C] ln1(x)
  float* hv = xl + C;                           // [12 S] per-head vectors
  float* red = hv + 12 * S;                     // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                    // [8] activation scales
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(6C, 4D)] activations

  float* r_g = p.scratch;  // r, k, v: [3][CL]
  float* dn_g = r_g + 3 * CL;
  float* xo_g = dn_g + 4 * D;

  // ---- A: ln1, shift mixes, rkv rows and lora1 rows ----------------------
  for (int c = tid; c < C; c += blockDim.x) xs[c] = p.x[c];
  __syncthreads();
  layer_norm_block(xs, xl, p.rvec + kRLn1W * C, p.rvec + kRLn1B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += blockDim.x) p.att_out[c] = xl[c];
  const float* cf = p.rvec + kRCoeff * C;  // r, w, k, v, a, g
  act_n<WF, 6>([&](int m, int c) { return add(xl[c], mul(sub(p.att_in[c], xl[c]), cf[m * C + c])); },
               C, q8, C, dxs, red);
  matvec_grid<WF, 1>(p.rkv, 3 * CL, C, 1, [&](int row, int) { return q8 + rkv_mix(row / CL) * C; },
      [&](int row, int, auto acc) {
        r_g[row] = dequant(acc, dxs[rkv_mix(row / CL)], p.rkv_d + row);
      },
      lanes_for(C, WF));
  matvec_grid<LF, 1>(p.lora1, 4 * D, C, 1, [&](int row, int) { return q8 + lora1_mix(row / D) * C; },
      [&](int row, int, auto acc) {
        const int part = row / D;
        float y = dequant(acc, dxs[lora1_mix(part)], p.lora1_d + row);
        if (part == 0) y = tanhf(y);
        if (part == 2) y = sigmoidf(y);
        dn_g[row] = y;
      },
      32, true);
  grid.sync();

  // ---- B: the shard's heads ------------------------------------------------
  {
    const float* lv = p.lvec;
    const HeadVecs vec{lv + kLW0 * CL,   lv + kLA0 * CL,   lv + kLV0 * CL,   lv + kLKK * CL,
                       lv + kLKA * CL,   lv + kLLnxW * CL, lv + kLLnxB * CL, lv + kLRK * CL};
    const HeadIO io{r_g, r_g + CL, r_g + 2 * CL, dn_g, p.vf, xo_g, p.heads_in, p.heads_out};
    for (int h = blockIdx.x; h < HL; h += gridDim.x)  // block-uniform
      v7_head_step<WF>(p.first ? 0 : 1, h, io, p.lora2, p.lora2_d, vec, CL, S, D, hv, red, dxs,
                       q8);
  }
  grid.sync();

  // ---- C: the shard's partial of out --------------------------------------
  tp_out_rows<WF>(xo_g, p.out, p.out_d, p.part, C, CL, red, dxs, q8);
}

size_t att_smem(int C, int S, int D, int wf) {
  const size_t n = 6ull * C > 4ull * D ? 6ull * C : 4ull * D;
  return tp_smem(2ull * C + 12ull * S + 8 * 32 + 8, n, wf);
}

struct FfnArgs {
  const float* x;          // [C]
  const float* ffn_in;     // [C]
  const int8_t* fk;        // [FL, C] form WF: the shard's rows of nf tiles
  const float* fk_d;       // [FL]
  const int8_t* fv;        // [nf, C, FT] form WF
  const float* fv_d;       // [C]
  const float* rvec;       // [kNumRVec7, C]
  float* part;             // [C] the shard's partial of fv
  float* ffn_out;          // [C] ln2(x), the new ffn_xx
  float* scratch;          // [FL] relu^2 keys
  int C, FL, nf;
};

template <int WF>
__global__ void __launch_bounds__(kTpThreads) tp_v7_ffn_kernel(FfnArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C]
  float* xl = xs + C;                           // [C] ln2(x)
  float* red = xl + C;                          // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(C, FT)]

  // ---- A: ln2 + shift, fk rows with relu^2 ---------------------------------
  for (int c = tid; c < C; c += blockDim.x) xs[c] = p.x[c];
  __syncthreads();
  layer_norm_block(xs, xl, p.rvec + kRLn2W * C, p.rvec + kRLn2B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += blockDim.x) p.ffn_out[c] = xl[c];
  const float* xk = p.rvec + kRXK * C;
  act_n<WF, 1>([&](int, int c) { return add(xl[c], mul(sub(p.ffn_in[c], xl[c]), xk[c])); }, C, q8,
               0, dxs, red);
  matvec_grid<WF, 1>(p.fk, p.FL, C, 1, [&](int, int) { return q8; },
      [&](int row, int, auto acc) {
        const float y = fmaxf(dequant(acc, dxs[0], p.fk_d + row), 0.f);
        p.scratch[row] = mul(y, y);
      },
      lanes_for(C, WF));
  grid.sync();

  // ---- B: the fv tiles into the partial ------------------------------------
  tp_fv_tiles<WF>(p.scratch, p.fv, p.fv_d, p.part, C, p.FL, p.nf, red, dxs, q8);
}

size_t ffn_smem(int C, int FT, int wf) {
  return tp_smem(2ull * C + 8 * 32 + 8, C > FT ? C : FT, wf);
}

const void* att_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v7_att_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v7_att_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v7_att_kernel<kInt8>);
}

const void* ffn_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v7_ffn_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v7_ffn_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v7_ffn_kernel<kInt8>);
}

int att_launch(int wf, const void* x, const void* att_in, const void* heads_in, void* vf,
               const void* rkv, const void* rkv_d, const void* lora1, const void* lora1_d,
               const void* lora2, const void* lora2_d, const void* out, const void* out_d,
               const void* rvec, const void* lvec, void* part, void* att_out, void* heads_out,
               void* scratch, int C, int CL, int S, int D, int first, int grid_blocks,
               void* stream) {
  if (kTpThreads % S != 0 || S * S / kTpThreads > kMaxJ || CL % S != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  AttArgs a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.vf = static_cast<float*>(vf);
  a.rkv = static_cast<const int8_t*>(rkv);
  a.rkv_d = static_cast<const float*>(rkv_d);
  a.lora1 = static_cast<const int8_t*>(lora1);
  a.lora1_d = static_cast<const float*>(lora1_d);
  a.lora2 = static_cast<const int8_t*>(lora2);
  a.lora2_d = static_cast<const float*>(lora2_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.S = S; a.D = D; a.first = first;
  return tp_launch(att_kernel(wf), a, att_smem(C, S, D, wf), grid_blocks, stream);
}

int ffn_launch(int wf, const void* x, const void* ffn_in, const void* fk, const void* fk_d,
               const void* fv, const void* fv_d, const void* rvec, void* part, void* ffn_out,
               void* scratch, int C, int FL, int nf, int grid_blocks, void* stream) {
  if (nf <= 0 || FL % nf != 0) return static_cast<int>(cudaErrorInvalidValue);
  FfnArgs a;
  a.x = static_cast<const float*>(x);
  a.ffn_in = static_cast<const float*>(ffn_in);
  a.fk = static_cast<const int8_t*>(fk);
  a.fk_d = static_cast<const float*>(fk_d);
  a.fv = static_cast<const int8_t*>(fv);
  a.fv_d = static_cast<const float*>(fv_d);
  a.rvec = static_cast<const float*>(rvec);
  a.part = static_cast<float*>(part);
  a.ffn_out = static_cast<float*>(ffn_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.FL = FL; a.nf = nf;
  return tp_launch(ffn_kernel(wf), a, ffn_smem(C, FL / nf, wf), grid_blocks, stream);
}

}  // namespace

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code) and one launch. The
// bf16 ones read no scales (pass null).
#define RWKV_TP_V7_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *heads_in, void *vf, const void *rkv,           \
      const void *rkv_d, const void *lora1, const void *lora1_d, const void *lora2,             \
      const void *lora2_d, const void *out, const void *out_d, const void *rvec,                \
      const void *lvec, void *part, void *att_out, void *heads_out, void *scratch, int C,       \
      int CL, int S, int D, int first, int grid_blocks, void *stream
#define RWKV_TP_V7_ATT_ARGS                                                                     \
  x, att_in, heads_in, vf, rkv, rkv_d, lora1, lora1_d, lora2, lora2_d, out, out_d, rvec, lvec,  \
      part, att_out, heads_out, scratch, C, CL, S, D, first, grid_blocks, stream
#define RWKV_TP_V7_FFN_PARAMS                                                                   \
  const void *x, const void *ffn_in, const void *fk, const void *fk_d, const void *fv,          \
      const void *fv_d, const void *rvec, void *part, void *ffn_out, void *scratch, int C,      \
      int FL, int nf, int grid_blocks, void *stream
#define RWKV_TP_V7_FFN_ARGS \
  x, ffn_in, fk, fk_d, fv, fv_d, rvec, part, ffn_out, scratch, C, FL, nf, grid_blocks, stream

#define RWKV_TP_V7_ENTRIES(suffix, wf)                                                          \
  extern "C" int rwkv_tp_v7_att##suffix##_grid(int C, int S, int D) {                          \
    return tp_grid_blocks(att_kernel(wf), att_smem(C, S, D, wf));                              \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_att##suffix(RWKV_TP_V7_ATT_PARAMS) {                               \
    return att_launch(wf, RWKV_TP_V7_ATT_ARGS);                                                 \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_ffn##suffix##_grid(int C, int FT) {                                \
    return tp_grid_blocks(ffn_kernel(wf), ffn_smem(C, FT, wf));                                 \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_ffn##suffix(RWKV_TP_V7_FFN_PARAMS) {                               \
    return ffn_launch(wf, RWKV_TP_V7_FFN_ARGS);                                                 \
  }

RWKV_TP_V7_ENTRIES(, kInt8)
RWKV_TP_V7_ENTRIES(_w4, kInt4)
RWKV_TP_V7_ENTRIES(_bf16, kBf16)
