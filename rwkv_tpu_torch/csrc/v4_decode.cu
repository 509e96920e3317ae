// K8: one RWKV v4 decode step at B=1 for all layers, w8a8, w4a8 or bf16,
// with ln_out and the LM head inside the kernel. One launch per token.
//
// Replaces rwkv_tpu/ops/megakernel.py::v4_decode_megakernel (kernel body
// _make_kernel_v4, head phases _emit_head_phases) and
// v4_decode_megakernel_tiled (_make_kernel_tiled_v4, w8 and w4), each also
// in its quant=False form (bf16 matrices and head). The TPU
// splits those two only by how a layer's weights fit VMEM; on this card one
// kernel computes their function at any width (C = 768 and 2048 among
// them), on the serving state layout (aa, bb, pp [L, C]).
//
// Bound on this card: the step streams every weight once -- at the World
// 0.1B width (C=768, F=3072, 12 layers) w8a8 about 12 x 7.1 MB of int8
// matrices (rkv 3C^2, out C^2, fk and fv 4C^2 each, fr C^2), the five
// state vectors of each layer read and written and the 50.3 MB int8 head,
// ~142 MB in all (w4a8: the five matrices at half the bytes, ~96 MB; bf16:
// twice the int8 bytes, ~277 MB) -- so HBM bandwidth bounds it (~43 / ~29
// / ~83 us at 3.35 TB/s).
//
// Design: K7's persistent cooperative kernel (one 256-thread block per SM,
// grid-wide barriers between phases) with four phases a layer. v4 has no
// heads: its wkv is elementwise over C, so it needs no phase of its own.
//   A  ln1 and the token shift, the three mixes (k, v, r) in the
//      reference's op order, each quantized as a whole vector (every block
//      redundantly), the fused r, k, v rows (sigmoid on r)
//   B  every block computes the whole C-wide sigmoid(r) * wkv vector
//      redundantly (its quantization needs the amax of all of it) with the
//      max-trick (wkv4_out, v45_common.cuh), the grid writes the new aa,
//      bb, pp columns, each block its share (wkv4_state); then the out
//      rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//   F  fv rows: x += sigmoid(fr) * fv          (E and F: v45_common.cuh)
// then ln_out and the head rows (lm_head, decode_common.cuh). Weight rows
// of any width are spread over every warp of the grid with 16-byte loads
// and __dp4a (matvec_rows, common.cuh; int4 rows unpack with two masks),
// lanes_for(K) lanes a row. The step is bound by latency: each phase is a
// chain of block reductions and dependent loads behind a grid barrier.
//
// Numerics follow the JAX kernel: whole-vector quantization, (float(acc) *
// dx) * d, explicit round-to-nearest multiplies and adds, expf and a true
// division in the max-trick. The blank state's pp = -1e30 gives
// exp(pp - qq) = 0, never NaN. The bf16 form (WF = kBf16, common.cuh)
// stages each input vector in f32 and reads no scales.
#include "v45_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// K8's vector rows after the shared ones (megakernel.py's _v45_blocks):
// the attention mixes k, v, r.
enum VecRow4 { kAmix = kNumVec45, kNumVec4 = kAmix + 3 };

struct Args {
  const int* token;
  const void* emb;          // [V, C]: bf16 bits, or f32 when emb_f32
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, MatOffsets45.layer]
  const float* scales;      // [L, ScaleOffsets45.layer] (int forms)
  const float* vecs;        // [L, kNumVec4, C]
  const int8_t* head;       // [V, C] int8 (bf16 in the bf16 form)
  const float* head_d;      // [V] (int forms)
  const float* ln_out;      // [2, C]
  const float* att_in;      // [L, C] each, the state in
  const float* ffn_in;
  const float* aa_in;
  const float* bb_in;
  const float* pp_in;
  float* att_out;           // [L, C] each, the state out
  float* ffn_out;
  float* aa_out;
  float* bb_out;
  float* pp_out;
  float* logits;            // [V]
  float* scratch;           // scratch_floats(C, F); x ends at scratch[0..C)
  int C, F, L, V;
  int emb_f32;
};

// Floats of the kernel's global scratch: x, sigmoid(r)|k|v (3C),
// sigmoid(fr) and the relu^2 keys (F); the Python wrapper allocates the
// same.
__host__ __device__ inline size_t scratch_floats(int C, int F) { return 5ull * C + F; }

template <int WF>
__global__ void __launch_bounds__(kThreads)
v4_decode_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, F = p.F;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized; phase B: r * wkv
  float* red = xl + C;                           // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(3C, F)] activations

  float* x_g = p.scratch;           // residual stream
  float* att_g = x_g + C;           // [3][C] sigmoid(r), k, v
  float* rg_g = att_g + 3 * C;      // sigmoid(fr rows)
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

  const MatOffsets45 mo(C, F, 3, WF);
  const ScaleOffsets45 so(C, F, 3);

  for (int l = 0; l < p.L; ++l) {
    const int8_t* m_layer = p.mats + l * mo.layer;
    const float* s_layer = p.scales + l * so.layer;
    const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec4 * C;
    const size_t lc = static_cast<size_t>(l) * C;
    const float* att_in = p.att_in + lc;

    // ---- phase A: ln1, shift, the mixes quantized, r k v rows -------------
    load_residual(l, p.token, p.emb, p.emb_f32, p.ln0, x_g, C, xs, xl, red);
    layer_norm_block(xs, xl, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.att_out[lc + c] = xl[c];
    {
      const float* am = vec + kAmix * C;  // rows k, v, r
      act_n<WF, 3>([&](int m, int c) { return mix45(xl[c], att_in[c], am[m * C + c]); }, C, q8,
                   C, dxs, red);
      matvec_grid<WF, 1>(m_layer + mo.att, 3 * C, C, 1,
          [&](int row, int) { return q8 + att_mix(row / C) * C; },
          [&](int row, int, auto acc) {
            const int part = row / C;
            const float y = dequant(acc, dxs[att_mix(part)], s_layer + so.att + row);
            att_g[row] = part == 0 ? sigmoidf(y) : y;
          },
          lanes_for(C, WF));
    }
    barrier();

    // ---- phase B: wkv4 (every block), the state, out rows + residual ------
    {
      const float* tf = vec + kTF * C;
      const float* td = vec + kTD * C;
      const float* aa_in = p.aa_in + lc;
      const float* bb_in = p.bb_in + lc;
      const float* pp_in = p.pp_in + lc;
      for (int c = tid; c < C; c += blockDim.x)
        xl[c] = mul(att_g[c], wkv4_out(tf[c], att_g[C + c], att_g[2 * C + c], aa_in[c], bb_in[c],
                                       pp_in[c]));
      for (int c = blockIdx.x * blockDim.x + tid; c < C; c += gridDim.x * blockDim.x)
        wkv4_state(td[c], att_g[C + c], att_g[2 * C + c], aa_in[c], bb_in[c], pp_in[c],
                   p.aa_out + lc + c, p.bb_out + lc + c, p.pp_out + lc + c);
      __syncthreads();
      act_n<WF, 1>([&](int, int c) { return xl[c]; }, C, q8, 0, dxs, red);
      matvec_grid<WF, 1>(m_layer + mo.out, C, C, 1, [&](int, int) { return q8; },
          [&](int row, int, auto acc) {
            x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_layer + so.out + row));
          },
          lanes_for(C, WF));
    }
    barrier();

    // ---- phases E and F: the FFN ------------------------------------------
    ffn_v45<WF>(vec, m_layer, s_layer, mo, so, p.ffn_in + lc, p.ffn_out + lc, x_g, rg_g, fk_g,
                C, F, xs, xl, red, dxs, q8, barrier);
  }

  // ---- head: ln_out, quantize, V rows (decode_common.cuh) -----------------
  lm_head<WF>(x_g, p.head, p.head_d, p.ln_out, p.logits, C, p.V, xs, xl, red, dxs, q8);
  PHASE_MARK();
}

// Shared memory of a launch in form wf: the floats, then the activations
// (int8 codes, or f32 in the bf16 form).
size_t smem_bytes(int C, int F, int wf) {
  const int q = 3 * C > F ? 3 * C : F;
  const size_t floats = 2ull * C + 8 * 32 + 8;
  const size_t act = (wf == kBf16 ? sizeof(float) : 1) * static_cast<size_t>(q);
  return floats * sizeof(float) + ((act + 15) / 16) * 16;
}

const void* kernel_for(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(v4_decode_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(v4_decode_kernel<kInt4>)
                     : reinterpret_cast<const void*>(v4_decode_kernel<kInt8>);
}

int launch(int wf, void* const* ptrs, int C, int F, int L, int V, int emb_f32, int grid_blocks,
           void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.token = static_cast<const int*>(ptrs[0]);
  a.emb = ptrs[1];
  a.ln0 = static_cast<const float*>(ptrs[2]);
  a.mats = static_cast<const int8_t*>(ptrs[3]);
  a.scales = static_cast<const float*>(ptrs[4]);
  a.vecs = static_cast<const float*>(ptrs[5]);
  a.head = static_cast<const int8_t*>(ptrs[6]);
  a.head_d = static_cast<const float*>(ptrs[7]);
  a.ln_out = static_cast<const float*>(ptrs[8]);
  a.att_in = static_cast<const float*>(ptrs[9]);
  a.ffn_in = static_cast<const float*>(ptrs[10]);
  a.aa_in = static_cast<const float*>(ptrs[11]);
  a.bb_in = static_cast<const float*>(ptrs[12]);
  a.pp_in = static_cast<const float*>(ptrs[13]);
  a.att_out = static_cast<float*>(ptrs[14]);
  a.ffn_out = static_cast<float*>(ptrs[15]);
  a.aa_out = static_cast<float*>(ptrs[16]);
  a.bb_out = static_cast<float*>(ptrs[17]);
  a.pp_out = static_cast<float*>(ptrs[18]);
  a.logits = static_cast<float*>(ptrs[19]);
  a.scratch = static_cast<float*>(ptrs[20]);
  a.C = C; a.F = F; a.L = L; a.V = V;
  a.emb_f32 = emb_f32;
  void* kargs[] = {&a};
  const size_t smem = smem_bytes(C, F, wf);
  cudaError_t err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel_for(wf), dim3(grid_blocks), dim3(kThreads), kargs,
                                      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch with 21 pointers (token,
// emb, ln0, mats, scales, vecs, head, head_d, ln_out, the five state arrays
// in and out in the order att_xx, ffn_xx, aa, bb, pp, logits, scratch). The
// bf16 entry takes one int more, emb_f32 (the embedding table is f32, not
// bf16); it reads no scales or head_d (pass null).
extern "C" int rwkv_v4_decode_grid(int C, int F) {
  return cooperative_grid(kernel_for(kInt8), kThreads, smem_bytes(C, F, kInt8));
}

extern "C" int rwkv_v4_decode_w4_grid(int C, int F) {
  return cooperative_grid(kernel_for(kInt4), kThreads, smem_bytes(C, F, kInt4));
}

extern "C" int rwkv_v4_decode_bf16_grid(int C, int F) {
  return cooperative_grid(kernel_for(kBf16), kThreads, smem_bytes(C, F, kBf16));
}

#define RWKV_V4_DECODE_PARAMS                                                                \
  void *p0, void *p1, void *p2, void *p3, void *p4, void *p5, void *p6, void *p7, void *p8,  \
      void *p9, void *p10, void *p11, void *p12, void *p13, void *p14, void *p15, void *p16, \
      void *p17, void *p18, void *p19, void *p20, int C, int F, int L, int V
#define RWKV_V4_DECODE_PTRS                                                                  \
  void* const ptrs[] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,  p8,  p9, p10,                \
                        p11, p12, p13, p14, p15, p16, p17, p18, p19, p20}

extern "C" int rwkv_v4_decode(RWKV_V4_DECODE_PARAMS, int grid_blocks, void* stream) {
  RWKV_V4_DECODE_PTRS;
  return launch(kInt8, ptrs, C, F, L, V, 0, grid_blocks, stream);
}

extern "C" int rwkv_v4_decode_w4(RWKV_V4_DECODE_PARAMS, int grid_blocks, void* stream) {
  RWKV_V4_DECODE_PTRS;
  return launch(kInt4, ptrs, C, F, L, V, 0, grid_blocks, stream);
}

extern "C" int rwkv_v4_decode_bf16(RWKV_V4_DECODE_PARAMS, int emb_f32, int grid_blocks,
                                   void* stream) {
  RWKV_V4_DECODE_PTRS;
  return launch(kBf16, ptrs, C, F, L, V, emb_f32, grid_blocks, stream);
}
