// K3: one RWKV v7 decode step at B=1 for all layers, w8a8, w4a8 or bf16,
// with ln_out and the LM head inside the kernel. One launch per token.
//
// Replaces rwkv_tpu/ops/megakernel.py::v7_decode_megakernel (kernel body
// _make_kernel, head phases _emit_head_phases, int4 matvec matv4/_w4_acc,
// and the quant=False form: bf16 matrices and head, matv's f32 branch).
//
// Bound on this card: the step streams every weight once -- at 169M w8a8
// about 12 x 7.47 MB of int8 matrices, ~0.1 MB/layer of scales and vectors,
// 0.39 MB/layer of wkv state read and written, and the 50.3 MB int8 head,
// ~146 MB in all (w4a8: the four big matrices at half the bytes, ~104 MB;
// bf16: every matrix and the head at twice the bytes, ~285 MB) -- so HBM
// bandwidth bounds it (~44 / ~31 / ~85 us at 3.35 TB/s).
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, one
// 256-thread block per SM) whose phases are separated by grid-wide
// barriers, five per layer:
//   A  ln1 + six-way token-shift mix, the six mixes quantized as whole
//      vectors in one pass (every block redundantly; C is small), then the
//      rkv and lora1 rows
//   C  per head (one block each): v7_head_step (v7_common.cuh) -- lora2
//      rows of the head's channels, wkv7 state update, group norm, gate
//   D  out rows + residual      E  ln2 + shift, fk rows with relu^2
//   F  fv rows + residual
// then ln_out and the head rows. Weight rows are spread over every warp of
// the grid with 16-byte loads and __dp4a (matvec_rows, common.cuh; int4
// rows unpack with two masks), so the weight stream keeps the whole card's
// memory system busy. The step is bound by latency, not bytes: each phase
// is a chain of block reductions and dependent loads, so phases are few and
// each quantization is one pass and one block reduction. A lane holds a
// whole row's share in registers (at most 8 16-byte chunks: C <= 1024 with
// the head's 8 lanes a row, F <= 4096); wider models decode through K4.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole (amax over all of it, codes rint(x * inv) clipped to +-127), the
// int32 sum is scaled as (float(acc) * dx) * d, and the elementwise formulas
// are evaluated with explicit round-to-nearest multiplies and adds so that
// no fused multiply-add shifts an activation across a code boundary. The
// bf16 form (template WF = kBf16, common.cuh) runs the same phases with
// every matrix and the head in bf16: the input vectors are staged in f32
// instead of quantized, and each row's f32 dot is the output as it is (no
// scales). A bf16 row is twice an int8 row's bytes, so K3 takes a row of
// up to 16 chunks a lane (two rounds; decode_shape_error).
#include "v7_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct Args {
  const int* token;
  const void* emb;          // [V, C]: bf16 bits, or f32 when emb_f32
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, MatOffsets.layer]: rkv|lora1|lora2|out|fk|fv
  const float* scales;      // [L, 9C + 4D + F] in the same order (int forms)
  const float* vecs;        // [L, kNumVec, C]
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
  float* scratch;           // scratch_floats(C, D, F); x ends at scratch[0..C)
  int C, H, S, D, F, L, V;
  int emb_f32;
};

// Floats of the kernel's global scratch (the residual stream and the
// vectors passed between phases); the Python wrapper allocates the same.
__host__ __device__ inline size_t scratch_floats(int C, int D, int F) {
  return 7ull * C + 4ull * D + F;
}

template <int WF>
__global__ void __launch_bounds__(kThreads)
v7_decode_kernel(Args p) {
  constexpr int LF = small_form(WF);  // the LoRAs' form
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, H = p.H, S = p.S, D = p.D, F = p.F;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [max(C, F)] residual / input
  float* xl = xs + (C > F ? C : F);              // [C] normalized
  float* hv = xl + C;                            // [12][S] per-head vectors
  float* red = hv + 12 * S;                      // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(6C, F, 4D)]

  float* x_g = p.scratch;          // residual stream
  float* r_g = x_g + C;
  float* k_g = r_g + C;
  float* v_g = k_g + C;
  float* dn_g = v_g + C;           // 4 x D: tanh(w), a, sigmoid(g), v downs
  float* vf_g = dn_g + 4 * D;      // layer-0 value
  float* xo_g = vf_g + C;          // attention output before `out`
  float* fk_g = xo_g + C;          // [F] relu^2 keys

#ifdef RWKV_PHASE_TIMES
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

  const MatOffsets mo(C, D, F, WF);
  const size_t sc_layer = 9ull * C + 4ull * D + F;

  for (int l = 0; l < p.L; ++l) {
    const int8_t* m_layer = p.mats + l * mo.layer;
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
      const size_t e = static_cast<size_t>(*p.token) * C;
      for (int c = tid; c < C; c += blockDim.x) xl[c] = emb_at(p.emb, p.emb_f32, e + c);
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
      act_n<WF, 6>(
          [&](int m, int c) { return add(xl[c], mul(sub(att_in[c], xl[c]), cf[m * C + c])); },
          C, q8, C, dxs, red);
      // rkv rows take mixes r(0), k(2), v(3); lora1 rows w(1), a(4), g(5), v(3)
      matvec_grid<WF, 1>(m_layer + mo.rkv, 3 * C, C, 1,
          [&](int row, int) { return q8 + rkv_mix(row / C) * C; },
          [&](int row, int, auto acc) {
            const int part = row / C;
            const float y = dequant(acc, dxs[rkv_mix(part)], s_rkv + row);
            (part == 0 ? r_g : part == 1 ? k_g : v_g)[row - part * C] = y;
          });
      matvec_grid<LF, 1>(m_layer + mo.l1, 4 * D, C, 1,
          [&](int row, int) { return q8 + lora1_mix(row / D) * C; },
          [&](int row, int, auto acc) {
            const int part = row / D;
            float y = dequant(acc, dxs[lora1_mix(part)], s_l1 + row);
            if (part == 0) y = tanhf(y);
            if (part == 2) y = sigmoidf(y);
            dn_g[row] = y;
          },
          32, true);
    }
    barrier();

    // ---- phase C: per head: lora2 rows, wkv7 step, group norm, gate -----
    {
      const size_t st_layer = static_cast<size_t>(l) * H * S * S;
      const HeadIO io{r_g, k_g, v_g, dn_g, vf_g, xo_g, p.heads_in + st_layer,
                      p.heads_out + st_layer};
      for (int h = blockIdx.x; h < H; h += gridDim.x)  // block-uniform
        v7_head_step<WF>(l, h, io, m_layer + mo.l2, s_l2, head_vecs(vec, C), C, S, D, hv, red,
                         dxs, q8);
    }
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    act_n<WF, 1>([&](int, int c) { return xo_g[c]; }, C, q8, 0, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.out, C, C, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_out + row));
        });
    barrier();

    // ---- phase E: ln2 + shift, fk rows with relu^2 -------------------------
    for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
    __syncthreads();
    layer_norm_block(xs, xl, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.ffn_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      const float* xk = vec + kXK * C;
      act_n<WF, 1>([&](int, int c) { return add(xl[c], mul(sub(ffn_in[c], xl[c]), xk[c])); },
                   C, q8, 0, dxs, red);
      matvec_grid<WF, 1>(m_layer + mo.fk, F, C, 1, [&](int, int) { return q8; },
          [&](int row, int, auto acc) {
            const float y = fmaxf(dequant(acc, dxs[0], s_fk + row), 0.f);
            fk_g[row] = mul(y, y);
          });
    }
    barrier();

    // ---- phase F: fv rows + residual --------------------------------------
    for (int c = tid; c < F; c += blockDim.x) xs[c] = fk_g[c];
    __syncthreads();
    act_n<WF, 1>([&](int, int c) { return xs[c]; }, F, q8, 0, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.fv, C, F, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_fv + row));
        });
    barrier();
  }

  // ---- head: ln_out, quantize, V rows (decode_common.cuh) -----------------
  lm_head<WF>(x_g, p.head, p.head_d, p.ln_out, p.logits, C, p.V, xs, xl, red, dxs, q8);
  PHASE_MARK();
}

// Shared memory of a launch in form wf: the floats above, then the
// activations (int8 codes, or f32 in the bf16 form).
size_t smem_bytes(int C, int S, int F, int D, int wf) {
  int q = 6 * C;
  if (F > q) q = F;
  if (4 * D > q) q = 4 * D;
  const size_t floats = static_cast<size_t>(C > F ? C : F) + C + 12ull * S + 8 * 32 + 8;
  const size_t act = (wf == kBf16 ? sizeof(float) : 1) * static_cast<size_t>(q);
  return floats * sizeof(float) + ((act + 15) / 16) * 16;
}

// Grid size a launch of kernel k in form wf uses (blocks), or a negative
// CUDA error code.
int grid_blocks_for(const void* k, int wf, int C, int S, int D, int F) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = smem_bytes(C, S, F, D, wf);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = set_smem(k, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  // one block per SM: measured ~2% faster than two (fewer blocks at each
  // barrier and in each redundant preamble), scripts/probe_torch_decode.py
  if (per_sm > 1) per_sm = 1;
  return per_sm * sms;
}

int launch(const void* k, int wf, const void* token, const void* emb, const void* ln0,
           const void* mats, const void* scales, const void* vecs, const void* head,
           const void* head_d, const void* ln_out, const void* att_in, const void* ffn_in,
           const void* heads_in, void* att_out, void* ffn_out, void* heads_out, void* logits,
           void* scratch, int C, int H, int S, int D, int F, int L, int V, int emb_f32,
           int grid_blocks, void* stream) {
  if (grid_blocks <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ)
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
  a.C = C; a.H = H; a.S = S; a.D = D; a.F = F; a.L = L; a.V = V;
  a.emb_f32 = emb_f32;
  void* kargs[] = {&a};
  const size_t smem = smem_bytes(C, S, F, D, wf);
  cudaError_t err = set_smem(k, smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(k, dim3(grid_blocks), dim3(kThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const void* const kW8 = reinterpret_cast<const void*>(v7_decode_kernel<kInt8>);
const void* const kW4 = reinterpret_cast<const void*>(v7_decode_kernel<kInt4>);
const void* const kBF = reinterpret_cast<const void*>(v7_decode_kernel<kBf16>);

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch. The bf16 entry takes one
// int more, emb_f32 (the embedding table is f32, not bf16); it reads no
// scales or head_d (pass null).
extern "C" int rwkv_v7_decode_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kW8, kInt8, C, S, D, F);
}

extern "C" int rwkv_v7_decode_w4_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kW4, kInt4, C, S, D, F);
}

extern "C" int rwkv_v7_decode_bf16_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kBF, kBf16, C, S, D, F);
}

#define RWKV_V7_DECODE_PARAMS                                                                  \
  const void *token, const void *emb, const void *ln0, const void *mats, const void *scales,   \
      const void *vecs, const void *head, const void *head_d, const void *ln_out,              \
      const void *att_in, const void *ffn_in, const void *heads_in, void *att_out,             \
      void *ffn_out, void *heads_out, void *logits, void *scratch, int C, int H, int S, int D, \
      int F, int L, int V
#define RWKV_V7_DECODE_ARGS                                                                    \
  token, emb, ln0, mats, scales, vecs, head, head_d, ln_out, att_in, ffn_in, heads_in, att_out, \
      ffn_out, heads_out, logits, scratch, C, H, S, D, F, L, V

extern "C" int rwkv_v7_decode(RWKV_V7_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kW8, kInt8, RWKV_V7_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v7_decode_w4(RWKV_V7_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kW4, kInt4, RWKV_V7_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v7_decode_bf16(RWKV_V7_DECODE_PARAMS, int emb_f32, int grid_blocks,
                                   void* stream) {
  return launch(kBF, kBf16, RWKV_V7_DECODE_ARGS, emb_f32, grid_blocks, stream);
}
