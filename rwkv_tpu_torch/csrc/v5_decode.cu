// K7: one RWKV v5.1 / v5.2 decode step at B=1 for all layers, w8a8, w4a8
// or bf16, with ln_out and the LM head inside the kernel. One launch per
// token.
//
// Replaces rwkv_tpu/ops/megakernel.py::v5_decode_megakernel (kernel body
// _make_kernel_v5, head phases _emit_head_phases) and
// v5_decode_megakernel_tiled (_make_kernel_tiled_v5, w8 and w4), each also
// in its quant=False form (bf16 matrices and head). The TPU
// splits those two only by how a layer's weights fit VMEM; on this card one
// kernel computes their function at any width, on the serving state layout
// [L, H, S_i, S_j] (the TPU kernels transpose it to [H, S_j, S_i]).
//
// Bound on this card: the step streams every weight once -- at the World
// 1.5B width (C=2048, F=8192, 24 layers) w8a8 about 24 x 58.7 MB of int8
// matrices (rkvg 4C^2, out C^2, fk and fv 4C^2 each, fr C^2), ~0.1 MB/layer
// of scales and vectors, 1.05 MB/layer of wkv state read and written and
// the 134 MB int8 head, ~1.57 GB in all (w4a8: the five matrices at half
// the bytes, ~0.86 GB; bf16: twice the int8 bytes, ~3.1 GB) -- so HBM
// bandwidth bounds it (~0.47 / ~0.26 / ~0.93 ms at 3.35 TB/s).
//
// Design: K6's persistent cooperative kernel (one 256-thread block per SM,
// phases separated by grid-wide barriers) without K6's maa and decay LoRA
// phases, five phases a layer:
//   A  ln1 and the token shift, the 3 (5.1) or 4 (5.2) mixes in the
//      reference's op order, each quantized as a whole vector (every block
//      redundantly), the fused r, k, v(, g) rows (silu on g)
//   C  per head (one block each): the wkv step with the static decay -- the
//      output reads the OLD state plus the tf bonus, then the state decays
//      and takes k v^T -- group norm (eps 1e-5; v5_head_step,
//      v45_common.cuh), ln_x, times the gate (5.2)
//   D  out rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//   F  fv rows: x += sigmoid(fr) * fv          (E and F: v45_common.cuh)
// then ln_out and the head rows (lm_head, decode_common.cuh). Weight rows
// of any width are spread over every warp of the grid with 16-byte loads
// and __dp4a (matvec_rows, common.cuh; int4 rows unpack with two masks),
// lanes_for(K) lanes a row. As K6, the step is bound by latency: each phase
// is a chain of block reductions and dependent loads behind a grid barrier.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole, the int32 sum is scaled as (float(acc) * dx) * d, and the
// elementwise formulas use explicit round-to-nearest multiplies and adds,
// so that no fused multiply-add shifts an activation across a code
// boundary. The bf16 form (WF = kBf16, common.cuh) stages each input
// vector in f32 and reads no scales.
#include "v45_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// K7's vector rows after the shared ones (megakernel.py's _v45_blocks):
// ln_x weight and bias, then the attention mixes k, v, r(, g).
enum VecRow5 { kLnxW = kNumVec45, kLnxB, kAmix };

struct Args {
  const int* token;
  const void* emb;          // [V, C]: bf16 bits, or f32 when emb_f32
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, MatOffsets45.layer]
  const float* scales;      // [L, ScaleOffsets45.layer] (int forms)
  const float* vecs;        // [L, kAmix + NA, C]
  const int8_t* head;       // [V, C] int8 (bf16 in the bf16 form)
  const float* head_d;      // [V] (int forms)
  const float* ln_out;      // [2, C]
  const float* att_in;      // [L, C]
  const float* ffn_in;      // [L, C]
  const float* heads_in;    // [L, H, S, S]
  float* att_out;
  float* ffn_out;
  float* heads_out;
  float* logits;            // [V]
  float* scratch;           // scratch_floats(C, F); x ends at scratch[0..C)
  int C, H, S, F, L, V;
  int emb_f32;
};

// Floats of the kernel's global scratch: x, r|k|v|g (4C), xo, sigmoid(fr)
// and the relu^2 keys (F); the Python wrapper allocates the same.
__host__ __device__ inline size_t scratch_floats(int C, int F) { return 7ull * C + F; }

template <int WF, bool GATE>
__global__ void __launch_bounds__(kThreads)
v5_decode_kernel(Args p) {
  constexpr int NA = GATE ? 4 : 3;  // fused attention projections and mixes
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, H = p.H, S = p.S, F = p.F;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized
  float* hv = xl + C;                            // [5S] per-head vectors
  float* red = hv + 5 * S;                       // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(4C, F)] activations

  float* x_g = p.scratch;           // residual stream
  float* att_g = x_g + C;           // [4][C] r, k, v, silu(g)
  float* xo_g = att_g + 4 * C;      // attention output before `out`
  float* rg_g = xo_g + C;           // sigmoid(fr rows)
  float* fk_g = rg_g + C;           // [F] relu^2 keys

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, F));
  int n_marks = 0;
#endif
  // a grid-wide barrier, with a timestamp on each side in the timing build
  auto barrier = [&]() {
    PHASE_MARK();
    grid.sync();
    PHASE_MARK();
  };
  PHASE_MARK();

  const MatOffsets45 mo(C, F, NA, WF);
  const ScaleOffsets45 so(C, F, NA);

  for (int l = 0; l < p.L; ++l) {
    const int8_t* m_layer = p.mats + l * mo.layer;
    const float* s_layer = p.scales + l * so.layer;
    const float* vec = p.vecs + static_cast<size_t>(l) * (kAmix + NA) * C;
    const float* att_in = p.att_in + static_cast<size_t>(l) * C;

    // ---- phase A: ln1, shift, the mixes quantized, r k v (g) rows ---------
    load_residual(l, p.token, p.emb, p.emb_f32, p.ln0, x_g, C, xs, xl, red);
    layer_norm_block(xs, xl, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      const float* am = vec + kAmix * C;  // rows k, v, r(, g)
      act_n<WF, NA>([&](int m, int c) { return mix45(xl[c], att_in[c], am[m * C + c]); }, C,
                    q8, C, dxs, red);
      matvec_grid<WF, 1>(m_layer + mo.att, NA * C, C, 1,
          [&](int row, int) { return q8 + att_mix(row / C) * C; },
          [&](int row, int, auto acc) {
            const int part = row / C;
            float y = dequant(acc, dxs[att_mix(part)], s_layer + so.att + row);
            if (GATE && part == 3) y = mul(y, sigmoidf(y));  // silu gate
            att_g[row] = y;
          },
          lanes_for(C, WF));
    }
    barrier();

    // ---- phase C: per head: wkv with the static decay, group norm, ln_x ---
    for (int h = blockIdx.x; h < H; h += gridDim.x) {  // block-uniform
      const int c0 = h * S;
      const size_t hoff = (static_cast<size_t>(l) * H + h) * S * S;
      v5_head_step(att_g + c0, att_g + C + c0, att_g + 2 * C + c0, vec + kTD * C + c0,
                   vec + kTF * C + c0, p.heads_in + hoff, p.heads_out + hoff, S, hv, red,
                   [&](int i, float yn) {
                     const int c = c0 + i;
                     const float xo = add(mul(yn, vec[kLnxW * C + c]), vec[kLnxB * C + c]);
                     xo_g[c] = GATE ? mul(xo, att_g[3 * C + c]) : xo;
                   });
    }
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    act_n<WF, 1>([&](int, int c) { return xo_g[c]; }, C, q8, 0, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.out, C, C, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_layer + so.out + row));
        },
        lanes_for(C, WF));
    barrier();

    // ---- phases E and F: the FFN ------------------------------------------
    ffn_v45<WF>(vec, m_layer, s_layer, mo, so, p.ffn_in + static_cast<size_t>(l) * C,
                p.ffn_out + static_cast<size_t>(l) * C, x_g, rg_g, fk_g, C, F, xs, xl, red, dxs,
                q8, barrier);
  }

  // ---- head: ln_out, quantize, V rows (decode_common.cuh) -----------------
  lm_head<WF>(x_g, p.head, p.head_d, p.ln_out, p.logits, C, p.V, xs, xl, red, dxs, q8);
  PHASE_MARK();
}

// Shared memory of a launch in form wf: the floats, then the activations
// (int8 codes, or f32 in the bf16 form).
size_t smem_bytes(int C, int S, int F, int wf) {
  const int q = 4 * C > F ? 4 * C : F;
  const size_t floats = 2ull * C + 5 * S + 8 * 32 + 8;
  const size_t act = (wf == kBf16 ? sizeof(float) : 1) * static_cast<size_t>(q);
  return floats * sizeof(float) + ((act + 15) / 16) * 16;
}

template <int WF>
const void* kernel_of(bool gate) {
  return gate ? reinterpret_cast<const void*>(v5_decode_kernel<WF, true>)
              : reinterpret_cast<const void*>(v5_decode_kernel<WF, false>);
}

const void* kernel_for(int wf, bool gate) {
  if (wf == kBf16) return kernel_of<kBf16>(gate);
  return wf == kInt4 ? kernel_of<kInt4>(gate) : kernel_of<kInt8>(gate);
}

int launch(int wf, const void* token, const void* emb, const void* ln0, const void* mats,
           const void* scales, const void* vecs, const void* head, const void* head_d,
           const void* ln_out, const void* att_in, const void* ffn_in, const void* heads_in,
           void* att_out, void* ffn_out, void* heads_out, void* logits, void* scratch, int C,
           int H, int S, int F, int L, int V, int gate, int emb_f32, int grid_blocks,
           void* stream) {
  if (grid_blocks <= 0 || S <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ ||
      H * S != C)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.token = static_cast<const int*>(token);
  a.emb = emb;
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
  a.C = C; a.H = H; a.S = S; a.F = F; a.L = L; a.V = V;
  a.emb_f32 = emb_f32;
  void* kargs[] = {&a};
  const size_t smem = smem_bytes(C, S, F, wf);
  cudaError_t err = set_smem(kernel_for(wf, gate != 0), smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel_for(wf, gate != 0), dim3(grid_blocks),
                                      dim3(kThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Grid size both variants (5.1, 5.2) of a form can launch with, after
// setting their shared memory limit: blocks, or a negative CUDA error code.
int grid_blocks_for(int wf, int C, int S, int F) {
  const int n51 = cooperative_grid(kernel_for(wf, false), kThreads, smem_bytes(C, S, F, wf));
  const int n52 = cooperative_grid(kernel_for(wf, true), kThreads, smem_bytes(C, S, F, wf));
  return n51 < n52 ? n51 : n52;
}

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch (gate = 1 for 5.2). The
// bf16 entry takes one int more, emb_f32 (the embedding table is f32, not
// bf16); it reads no scales or head_d (pass null).
extern "C" int rwkv_v5_decode_grid(int C, int S, int F) { return grid_blocks_for(kInt8, C, S, F); }

extern "C" int rwkv_v5_decode_w4_grid(int C, int S, int F) {
  return grid_blocks_for(kInt4, C, S, F);
}

extern "C" int rwkv_v5_decode_bf16_grid(int C, int S, int F) {
  return grid_blocks_for(kBf16, C, S, F);
}

#define RWKV_V5_DECODE_PARAMS                                                                  \
  const void *token, const void *emb, const void *ln0, const void *mats, const void *scales,   \
      const void *vecs, const void *head, const void *head_d, const void *ln_out,              \
      const void *att_in, const void *ffn_in, const void *heads_in, void *att_out,             \
      void *ffn_out, void *heads_out, void *logits, void *scratch, int C, int H, int S, int F, \
      int L, int V, int gate
#define RWKV_V5_DECODE_ARGS                                                                    \
  token, emb, ln0, mats, scales, vecs, head, head_d, ln_out, att_in, ffn_in, heads_in, att_out, \
      ffn_out, heads_out, logits, scratch, C, H, S, F, L, V, gate

extern "C" int rwkv_v5_decode(RWKV_V5_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kInt8, RWKV_V5_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v5_decode_w4(RWKV_V5_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kInt4, RWKV_V5_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v5_decode_bf16(RWKV_V5_DECODE_PARAMS, int emb_f32, int grid_blocks,
                                   void* stream) {
  return launch(kBf16, RWKV_V5_DECODE_ARGS, emb_f32, grid_blocks, stream);
}
