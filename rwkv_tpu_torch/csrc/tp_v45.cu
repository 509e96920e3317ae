// K14: the attention of one layer of an RWKV v4 decode step at B=1 on one
// shard of a tensor-parallel mesh, w8a8, w4a8 or bf16. One launch per
// shard per layer; the caller sums the shards' full-C partials, then runs
// the gated FFN on K13's MIX45 form (tp_v6.cu) and gathers its gate
// (ops/megakernel_tp.py). The v5 attention (K15) is a form of K12's kernel
// in tp_v6.cu.
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call_v4 (kernel
// _make_att_kernel_v4), in its int8, int4 and bf16 forms.
//
// Bound on this card: bytes. At the World 1.5B width (C=2048) and tp=2 a
// launch reads its shard's rkv rows (3 x 1024 x 2048) and out columns
// (2048 x 1024), ~8.4 MB int8: ~2.5 us at 3.35 TB/s. int4 moves about half
// of that, bf16 twice.
//
// Design: a persistent cooperative kernel (one 256-thread block per SM,
// grid-wide barriers between phases), K8's phases for one layer and one
// shard:
//   A  ln1, shift, the three mixes (k, v, r) each quantized as a whole
//      (replicated input), the shard's rkv rows (sigmoid on r)
//   B  every block computes the shard's c_loc-wide sigmoid(r) * wkv
//      redundantly with the max-trick (wkv4_out, v45_common.cuh; its
//      quantization needs the amax of all of it), the grid writes the new
//      aa, bb, pp, each block its share (wkv4_state); then the shard's xo
//      quantized with its own scale and the C rows of out into the partial
//      (tp_out_rows, tp_common.cuh)
// Numerics follow the JAX kernel as K8 does (explicit round-to-nearest
// float ops, each matvec input quantized as a whole, the out input the
// shard's local slice with its own scale).
#include "tp_common.cuh"
#include "v45_common.cuh"

namespace {

// rows of a shard's replicated vector block [L, rows, C] and of its own
// [L, rows, C/tp] (ops/megakernel_tp.py TP4_RVECS, TP4_LVECS). Rows 2, 3, 5
// and 6 hold ln2 and the FFN mixes where K13 (tp_v6.cu RVec6) reads them;
// the attention mixes k, v, r sit around them.
enum RVec45 { kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRMixK, kRFmixK, kRFmixR, kRMixV };
enum LVec45 { kLTD = 0, kLTF };

// The row of attention mix m (amix order k, v, r) in the replicated block.
__device__ __forceinline__ int mix_row(int m) { return m == 0 ? kRMixK : kRMixV + m - 1; }

// Phase A: ln1 of x into xl (block 0 writes it to att_out), the three
// mixes quantized as whole vectors, the shard's 3 CL fused rows (r, k, v)
// into att_g, sigmoid on r.
template <int WF>
__device__ void att_rows(const float* x, const float* att_in, const int8_t* w, const float* w_d,
                         const float* rvec, float* att_out, float* att_g, int C, int CL,
                         float* xs, float* xl, float* red, float* dxs, act_t<WF>* q8) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) xs[c] = x[c];
  __syncthreads();
  layer_norm_block(xs, xl, rvec + kRLn1W * C, rvec + kRLn1B * C, C, 1e-5f, red);
  if (blockIdx.x == 0)
    for (int c = threadIdx.x; c < C; c += blockDim.x) att_out[c] = xl[c];
  act_n<WF, 3>([&](int m, int c) { return mix45(xl[c], att_in[c], rvec[mix_row(m) * C + c]); },
               C, q8, C, dxs, red);
  matvec_grid<WF, 1>(w, 3 * CL, C, 1, [&](int row, int) { return q8 + att_mix(row / CL) * C; },
      [&](int row, int, auto acc) {
        const int part = row / CL;
        float y = dequant(acc, dxs[att_mix(part)], w_d + row);
        if (part == 0) y = sigmoidf(y);
        att_g[row] = y;
      },
      lanes_for(C, WF));
}

struct Att4Args {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* aa_in;      // [CL] the shard's channels of the state
  const float* bb_in;
  const float* pp_in;
  const int8_t* rkv;       // [3, CL, C] form WF
  const float* rkv_d;      // [3 CL] (int forms)
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* rvec;       // [kRMixV + 2, C]
  const float* lvec;       // [2, CL] td, tf
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x)
  float* aa_out;           // [CL]
  float* bb_out;
  float* pp_out;
  float* scratch;          // sigmoid(r) | k | v (3 CL)
  int C, CL;
};

template <int WF>
__global__ void __launch_bounds__(kTpThreads) tp_v4_att_kernel(Att4Args p) {
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, CL = p.CL, tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x; phase B: xo (CL)
  float* xl = xs + C;                           // [C] ln1(x)
  float* red = xl + C;                          // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [3C] activations
  float* att_g = p.scratch;

  // ---- A: ln1, shift, the mixes quantized, the shard's r k v rows ---------
  att_rows<WF>(p.x, p.att_in, p.rkv, p.rkv_d, p.rvec, p.att_out, att_g, C, CL, xs, xl,
                        red, dxs, q8);
  grid.sync();

  // ---- B: xo = sigmoid(r) * wkv (every block), the state, out rows --------
  const float* td = p.lvec + kLTD * CL;
  const float* tf = p.lvec + kLTF * CL;
  float* xo = xs;
  for (int c = tid; c < CL; c += blockDim.x)
    xo[c] = mul(att_g[c], wkv4_out(tf[c], att_g[CL + c], att_g[2 * CL + c], p.aa_in[c],
                                   p.bb_in[c], p.pp_in[c]));
  for (int c = blockIdx.x * blockDim.x + tid; c < CL; c += gridDim.x * blockDim.x)
    wkv4_state(td[c], att_g[CL + c], att_g[2 * CL + c], p.aa_in[c], p.bb_in[c], p.pp_in[c],
               p.aa_out + c, p.bb_out + c, p.pp_out + c);
  __syncthreads();
  tp_out_rows<WF>(xo, p.out, p.out_d, p.part, C, CL, red, dxs, q8);
}

size_t att4_smem(int C, int wf) { return tp_smem(2ull * C + 8 * 32 + 8, 3ull * C, wf); }

const void* att4_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v4_att_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v4_att_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v4_att_kernel<kInt8>);
}

int att4_launch(int wf, const void* x, const void* att_in, const void* aa_in, const void* bb_in,
                const void* pp_in, const void* rkv, const void* rkv_d, const void* out,
                const void* out_d, const void* rvec, const void* lvec, void* part, void* att_out,
                void* aa_out, void* bb_out, void* pp_out, void* scratch, int C, int CL,
                int grid_blocks, void* stream) {
  if (CL <= 0 || C % CL != 0) return static_cast<int>(cudaErrorInvalidValue);
  Att4Args a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.aa_in = static_cast<const float*>(aa_in);
  a.bb_in = static_cast<const float*>(bb_in);
  a.pp_in = static_cast<const float*>(pp_in);
  a.rkv = static_cast<const int8_t*>(rkv);
  a.rkv_d = static_cast<const float*>(rkv_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.aa_out = static_cast<float*>(aa_out);
  a.bb_out = static_cast<float*>(bb_out);
  a.pp_out = static_cast<float*>(pp_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL;
  return tp_launch(att4_kernel(wf), a, att4_smem(C, wf), grid_blocks, stream);
}

}  // namespace

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code) and one launch. The
// bf16 ones read no scales (pass null).
#define RWKV_TP_V4_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *aa_in, const void *bb_in, const void *pp_in,   \
      const void *rkv, const void *rkv_d, const void *out, const void *out_d, const void *rvec, \
      const void *lvec, void *part, void *att_out, void *aa_out, void *bb_out, void *pp_out,    \
      void *scratch, int C, int CL, int grid_blocks, void *stream
#define RWKV_TP_V4_ATT_ARGS                                                                     \
  x, att_in, aa_in, bb_in, pp_in, rkv, rkv_d, out, out_d, rvec, lvec, part, att_out, aa_out,    \
      bb_out, pp_out, scratch, C, CL, grid_blocks, stream
#define RWKV_TP_V45_ENTRIES(suffix, wf)                                                         \
  extern "C" int rwkv_tp_v4_att##suffix##_grid(int C) {                                        \
    return tp_grid_blocks(att4_kernel(wf), att4_smem(C, wf));                                   \
  }                                                                                             \
  extern "C" int rwkv_tp_v4_att##suffix(RWKV_TP_V4_ATT_PARAMS) {                               \
    return att4_launch(wf, RWKV_TP_V4_ATT_ARGS);                                                \
  }

RWKV_TP_V45_ENTRIES(, kInt8)
RWKV_TP_V45_ENTRIES(_w4, kInt4)
RWKV_TP_V45_ENTRIES(_bf16, kBf16)
