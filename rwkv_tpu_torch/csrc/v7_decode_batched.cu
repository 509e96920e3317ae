// K4: one RWKV v7 decode step for B sequences and all layers, w8a8, w4a8
// or bf16, without the LM head (the caller runs ln_out and the head: K1 at
// M=B, or the per-op head in the model's dtype under bf16 / f32). One
// launch per step.
//
// Replaces rwkv_tpu/ops/megakernel.py::v7_decode_megakernel_batched
// (_make_kernel_batched), v7_decode_megakernel_batched_packed
// (_make_kernel_batched_packed) and v7_decode_megakernel_tiled
// (_make_kernel_tiled, w8 and w4), each also in its quant=False form (bf16
// matrices, f32 activations). Those three TPU kernels differ only in
// how they fit VMEM (batch on lanes, lane-packed state, a (layer, phase)
// grid for wide models); on this card one kernel computes their function
// for any B and width, reading the serving state layout [B, L, H, S_i, S_j]
// directly, so no state packing happens around it.
//
// Bound on this card: bytes. A step reads every layer weight once (169M
// w8a8: 89.7 MB of int8 matrices + 1.2 MB of scales and vectors; bf16:
// 179 MB of matrices) and reads and writes each sequence's 4.87 MB of
// state: ~130 MB at B=8 (0.039 ms at 3.35 TB/s), ~402 MB at B=64 (0.120
// ms; bf16 ~491 MB, 0.147 ms). Its int8 operations (1.4 GOP at B=8) are
// under a microsecond of tensor-core time, the bf16 form's three bf16
// passes (34 GFLOP at B=64) about 34 us.
//
// One cooperative persistent kernel (one 256-thread block per SM, grid
// barriers between the phases of a layer, v7_common.cuh), with phase C as
// B x H independent (sequence, head) tasks spread over the blocks
// (v7_head_step on that sequence's vectors and state). Each phase's other
// matrices run as sweeps on the tensor cores with the whole batch as mma's
// N (batch_mma.cuh), so every row is read once a step for any B: int8
// mma.sync in the int forms, bf16 mma.sync in the bf16 form, whose f32
// inputs split into three bf16 parts as the fragments are loaded (the TPU
// kernels' quant=False dot at Precision.HIGHEST, which the MXU also runs
// as several bf16 passes). The activations are prepared per sequence
// (layer norm, shift mix; the int forms quantize each input vector with
// its own amax: the per-column qx of the TPU kernels; the bf16 form keeps
// it in f32) by one warp each (layer_norm_warp, quantize_warp), in one of
// two placements chosen by the launch plan (ops/megakernel.py::
// batched_plan):
//   (a) every block prepares all B itself into shared memory (only the
//       input vectors its tiles read): no extra barrier, work that grows
//       with B in every block;
//   (b) one warp of the grid prepares each sequence into a global buffer
//       (the scratch's tail), behind one more grid barrier a phase (nine a
//       layer instead of five); the blocks stage it with their rows.
// (a) up to B = 8 where it fits, (b) above and at the 1.5B width in the
// bf16 form (the readings of tools/probe_batched.py, PERF.md); each
// placement and form is a kernel of its own. At its start the kernel asks
// L2 for the read-only inputs the preparations read first (the
// token-shift states, the per-layer vectors, the row scales). The int
// forms' codes, scales and integer dots are those of the earlier
// column-tile kernel, and every float operation keeps its order, so their
// outputs are bit for bit the same. The bf16 form's f32 sums take an
// order that depends on K alone (sweep_pass_bf16), so a sequence gets the
// same bits in any batch, placement and grid.
//
// Sequences with identical inputs get bit-identical outputs in every form:
// every per-sequence computation runs the same code on its own data.
// Numerics follow K3 (explicit round-to-nearest float ops, IEEE division
// in the activation scale), so at B=1 K4 and K3 agree up to the order of
// the layer-norm sums (warp sums here, block sums in K3) and, in the bf16
// form, of the rows' sums.
#include "batch_mma.cuh"
#include "v7_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // shared memory a block of the H100 may opt into

struct Args {
  const int* tokens;        // [B]
  const void* emb;          // [V, C]: bf16 bits, or f32 when emb_f32
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, MatOffsets.layer]
  const float* scales;      // [L, 9C + 4D + F] (int forms)
  const float* vecs;        // [L, kNumVec, C]
  const float* att_in;      // [B, L, C]
  const float* ffn_in;      // [B, L, C]
  const float* heads_in;    // [B, L, H, S, S]
  float* att_out;
  float* ffn_out;
  float* heads_out;
  float* scratch;           // B * seq_scratch_floats; x [B, C] at its start
  int C, H, S, D, F, L, B;
  int emb_f32;
};

// The kernel's global scratch holds, per sequence, x, r, k, v, v_first and
// xo (C floats each), the four lora downs (4D) and the relu^2 keys (F):
// (6C + 4D + F) x B floats, laid out array by array, x first; the int
// forms add placement (b)'s activation scales (6 B floats, rounded up to
// 4), codes (max(6C, F) x B bytes, rounded up to 16) and the split
// sweeps' sums and tickets, the bf16 form placement (b)'s f32 inputs
// (max(6C, F) x B floats). The Python wrapper allocates it
// (batched_scratch_floats).

// Per-sequence vectors (n floats, n a multiple of 4, 16-byte aligned) are
// walked by one warp in float4 pieces: lane l takes pieces l, l + 32, ...
// (four elements a load, so a pass is n / 128 dependent steps a lane).
__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ void st4(float* p, int i, float4 v) {
  reinterpret_cast<float4*>(p)[i] = v;
}
__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
// xl + (xp - xl) * cf, the token-shift mix, element by element
__device__ __forceinline__ float4 mix4(float4 xl, float4 xp, float4 cf) {
  return make_float4(add(xl.x, mul(sub(xp.x, xl.x), cf.x)), add(xl.y, mul(sub(xp.y, xl.y), cf.y)),
                     add(xl.z, mul(sub(xp.z, xl.z), cf.z)), add(xl.w, mul(sub(xp.w, xl.w), cf.w)));
}

// Warp-wide layer norm of x[0..n) in place (each lane touches only its own
// pieces).
__device__ void layer_norm_warp(float* x, const float* w, const float* b, int n, float eps) {
  const int lane = threadIdx.x & 31, n4 = n >> 2;
  float s = 0.f;
#pragma unroll 2
  for (int i = lane; i < n4; i += 32) {
    const float4 v = ld4(x, i);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mu = warp_sum(s) / static_cast<float>(n);
  float var = 0.f;
#pragma unroll 2
  for (int i = lane; i < n4; i += 32) {
    const float4 v = ld4(x, i);
    const float dx = sub(v.x, mu), dy = sub(v.y, mu), dz = sub(v.z, mu), dw = sub(v.w, mu);
    var += (mul(dx, dx) + mul(dy, dy)) + (mul(dz, dz) + mul(dw, dw));
  }
  const float rs = rsqrtf(add(warp_sum(var) / static_cast<float>(n), eps));
#pragma unroll 2
  for (int i = lane; i < n4; i += 32) {
    const float4 v = ld4(x, i), wv = ld4(w, i), bv = ld4(b, i);
    st4(x, i, make_float4(add(mul(mul(sub(v.x, mu), rs), wv.x), bv.x),
                          add(mul(mul(sub(v.y, mu), rs), wv.y), bv.y),
                          add(mul(mul(sub(v.z, mu), rs), wv.z), bv.z),
                          add(mul(mul(sub(v.w, mu), rs), wv.w), bv.w)));
  }
}

// Quantize N vectors of n values by one warp, each with its own amax.
// f(i, v) fills v[m] with piece i of vector m (loading shared operands
// once for all N); codes go to q8[m * q_stride + c], scales to
// dxs[m * dx_stride] (lane 0). The bf16 form stores the f32 values there
// instead (no scales).
template <int WF, int N, typename Fn>
__device__ void quantize_warp(Fn f, int n, act_t<WF>* q8, int q_stride, float* dxs,
                              int dx_stride) {
  const int lane = threadIdx.x & 31, n4 = n >> 2;
  if constexpr (WF == kBf16) {
#pragma unroll 2
    for (int i = lane; i < n4; i += 32) {
      float4 v[N];
      f(i, v);
#pragma unroll
      for (int m = 0; m < N; ++m) st4(q8 + m * q_stride, i, v[m]);
    }
  } else {
    float amax[N];
#pragma unroll
    for (int m = 0; m < N; ++m) amax[m] = 0.f;
#pragma unroll 2
    for (int i = lane; i < n4; i += 32) {
      float4 v[N];
      f(i, v);
#pragma unroll
      for (int m = 0; m < N; ++m) amax[m] = fmaxf(amax[m], absmax4(v[m]));
    }
    float inv[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float dx = warp_max(amax[m]) / 127.0f;
      inv[m] = act_inv_scale(dx);
      if (lane == 0) dxs[m * dx_stride] = dx;
    }
#pragma unroll 2
    for (int i = lane; i < n4; i += 32) {
      float4 v[N];
      f(i, v);
#pragma unroll
      for (int m = 0; m < N; ++m) {
        *reinterpret_cast<char4*>(q8 + m * q_stride + 4 * i) =
            make_char4(act_code(v[m].x, inv[m]), act_code(v[m].y, inv[m]),
                       act_code(v[m].z, inv[m]), act_code(v[m].w, inv[m]));
      }
    }
  }
}

// Sequence b's row of the embedding table into x (C floats), by one warp
// in float4 pieces: bf16, or in the bf16 form f32 where emb_f32.
template <int WF>
__device__ void embed_warp(const Args& p, int b, float* x) {
  const int lane = threadIdx.x & 31, C = p.C;
  if constexpr (WF == kBf16) {
    if (p.emb_f32) {
      const float* e = static_cast<const float*>(p.emb) + static_cast<size_t>(p.tokens[b]) * C;
      for (int i = lane; i < C / 4; i += 32) st4(x, i, ld4(e, i));
      return;
    }
  }
  const uint2* e = reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p.emb) +
                                                  static_cast<size_t>(p.tokens[b]) * C);
  for (int i = lane; i < C / 4; i += 32) {
    const uint2 u = e[i];  // four bf16, little end first
    st4(x, i, make_float4(bf16_to_float(u.x & 0xFFFFu), bf16_to_float(u.x >> 16),
                          bf16_to_float(u.y & 0xFFFFu), bf16_to_float(u.y >> 16)));
  }
}

// Asks L2 for the 128-byte lines of n floats at p, spread over the grid's
// threads (a hint: nothing waits for it).
__device__ __forceinline__ void prefetch_l2(const float* p, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x * 32;
  for (size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 32; i < n;
       i += stride)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
}

// n floats from src to dst by one warp (each lane its own pieces).
__device__ __forceinline__ void copy_warp(float* dst, const float* src, int n) {
  for (int i = threadIdx.x & 31; i < n / 4; i += 32) st4(dst, i, ld4(src, i));
}

// PB: placement (b). Each placement is a kernel of its own, so that
// neither carries the other's preparation: registers are the kernel's
// scarcest resource.
template <int WF, bool PB>
__global__ void __launch_bounds__(kThreads, 1)
v7_decode_batched_mma_kernel(Args p, bmma::Plan pl) {
  constexpr int LF = small_form(WF);  // the LoRAs' form
  constexpr bool place_b = PB;
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, H = p.H, S = p.S, D = p.D, F = p.F, L = p.L, B = p.B;
  const int warp = threadIdx.x >> 5, blocks = gridDim.x;
  const bmma::Layout lay(WF, C, S, D, F, B, blocks, pl);
  const int nt = lay.nt, bp = lay.bp;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hv = reinterpret_cast<float*>(smem);          // [12][S] phase C's per-head vectors
  float* red = hv + 12 * S;                             // [8][32] reduction scratch
  float* dxc = red + 8 * 32;                            // phase C's activation scales
  act_t<WF>* q8c = reinterpret_cast<act_t<WF>*>(dxc + 8);  // phase C's 4D activations
  float* dxs = reinterpret_cast<float*>(smem + lay.dxs);        // [vector][bp] scales
  float* srow = reinterpret_cast<float*>(smem + lay.srow);      // a sweep's row scales
  float* xw = reinterpret_cast<float*>(smem + lay.xw);          // (a): [8][C] a warp's row
  // (a): [vector][bp] prepared inputs (codes, or f32 in the bf16 form)
  act_t<WF>* acodes = reinterpret_cast<act_t<WF>*>(smem + lay.acodes);
  unsigned char* acb = smem + lay.acodes;  // the same, as bytes
  unsigned char* work = smem + lay.work;                // a sweep's stages and sums

  float* x_g = p.scratch;                  // [B][C] residual stream (the output)
  float* r_g = x_g + static_cast<size_t>(B) * C;
  float* k_g = r_g + static_cast<size_t>(B) * C;
  float* v_g = k_g + static_cast<size_t>(B) * C;
  float* vf_g = v_g + static_cast<size_t>(B) * C;   // layer-0 values
  float* xo_g = vf_g + static_cast<size_t>(B) * C;  // attention outputs
  float* dn_g = xo_g + static_cast<size_t>(B) * C;  // [B][4D] lora downs
  float* fk_g = dn_g + static_cast<size_t>(B) * 4 * D;  // [B][F] relu^2 keys
  float* dx_g = fk_g + static_cast<size_t>(B) * F;      // (b), int forms: [6][B] scales
  // (b): the prepared inputs, [vector][B][K]: codes behind the scales, or
  // the bf16 form's f32 values (no scales)
  act_t<WF>* q_g =
      reinterpret_cast<act_t<WF>*>(WF == kBf16 ? dx_g : dx_g + bmma::round_up(6 * B, 4));
  const int code_bytes = bmma::round_up((6 * C > F ? 6 * C : F) * B, 16);
  // the int forms' split sweeps' partial sums [C / 16][bp][16] and tickets [C / 16]
  int* acc_g = reinterpret_cast<int*>(reinterpret_cast<int8_t*>(q_g) + code_bytes);
  int* tickets_g = acc_g + static_cast<size_t>(C) * bp;

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks = reinterpret_cast<unsigned long long*>(
      WF == kBf16 ? reinterpret_cast<int*>(q_g + static_cast<size_t>(6 * C > F ? 6 * C : F) * B)
                  : tickets_g + bmma::round_up(C / 16, 4));
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
  const bmma::SweepDims sw_rkv = bmma::sweep_dims(bmma::kSwRkv, WF, C, D, F);
  const bmma::SweepDims sw_l1 = bmma::sweep_dims(bmma::kSwL1, WF, C, D, F);
  const bmma::SweepDims sw_out = bmma::sweep_dims(bmma::kSwOut, WF, C, D, F);
  const bmma::SweepDims sw_fk = bmma::sweep_dims(bmma::kSwFk, WF, C, D, F);
  const bmma::SweepDims sw_fv = bmma::sweep_dims(bmma::kSwFv, WF, C, D, F);
  const bmma::Tiles t_rkv = bmma::block_tiles(sw_rkv, false), t_l1 = bmma::block_tiles(sw_l1, true);
  const bmma::Tiles t_fk = bmma::block_tiles(sw_fk, false);
  // bytes (as_) and elements (cs_) a prepared input row of C or F takes
  const int as_c = bmma::act_stride(WF, C), as_f = bmma::act_stride(WF, F);
  const int cs_c = as_c / static_cast<int>(sizeof(act_t<WF>));
  const int cs_f = as_f / static_cast<int>(sizeof(act_t<WF>));
  // the input vector each part of a sweep reads: rkv r, k, v the mixes r,
  // k, v; lora1 w, a, g, v theirs (rkv_mix, lora1_mix); out, fk, fv one
  const bmma::Mixes kRkvMixes{{rkv_mix(0), rkv_mix(1), rkv_mix(2), 0}};
  const bmma::Mixes kLora1Mixes{{lora1_mix(0), lora1_mix(1), lora1_mix(2), lora1_mix(3)}};
  const bmma::Mixes kOneVector{{0, 0, 0, 0}};
  // (b): this warp prepares sequences first, first + step, ... (spread over the SMs)
  const int first = warp * blocks + blockIdx.x, step = kWarps * blocks;
  // (a): the sequences of this warp are warp, warp + kWarps, ...
  // (a): zero the code rows of sequences B .. bp - 1 of input vectors 0 .. n - 1
  // (the bf16 form leaves them: a column of mma's B feeds only that column
  // of its product, and the epilogue reads the columns below B alone)
  auto zero_pad = [&](int n, int stride) {
    if constexpr (WF != kBf16) {
      const int rows = bp - B, chunks = stride / 16;
      for (int e = threadIdx.x; e < n * rows * chunks; e += blockDim.x) {
        const int r = e / chunks, c = e - r * chunks, m = r / rows;
        reinterpret_cast<int4*>(acodes + (static_cast<size_t>(m) * bp + B + r - m * rows) *
                                             stride)[c] = make_int4(0, 0, 0, 0);
      }
    }
  };
  // (a), bf16 form: zero the f32 inputs of sequences 0 .. B - 1 of input
  // vectors 0 .. n - 1 from k to the end of their last step (a zero weight
  // times a stale NaN would not be zero)
  auto zero_tail = [&](int n, int k, int stride) {
    const int pad = bmma::round_up(k, bmma::kBf16Step) - k;
    for (int e = threadIdx.x; e < n * B * pad; e += blockDim.x) {
      const int r = e / pad;
      float* row = reinterpret_cast<float*>(acb + static_cast<size_t>(r / B * bp + r % B) * stride);
      row[k + e % pad] = 0.f;
    }
  };
  const int8_t* codes = reinterpret_cast<const int8_t*>(place_b ? q_g : acodes);
  const bmma::Source src_a{place_b, codes, as_c, dxs, dx_g, acc_g, tickets_g};
  const bmma::Source src_f{place_b, codes, as_f, dxs, dx_g, acc_g, tickets_g};
  // the bf16 form takes each tile's K whole on one block (its sum order)
  const int split_out = WF == kBf16 ? 1 : bmma::sweep_split(bmma::kSwOut, sw_out, blocks, place_b);
  const int split_fv = WF == kBf16 ? 1 : bmma::sweep_split(bmma::kSwFv, sw_fv, blocks, place_b);
  const bmma::Tiles t_out = bmma::block_tiles(sw_out, false, split_out);
  const bmma::Tiles t_fv = bmma::block_tiles(sw_fv, false, split_fv);
  // the split sweeps' sums and tickets start at zero (each use leaves them
  // so); their first use is behind a grid barrier
  if constexpr (WF != kBf16)
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < static_cast<size_t>(C) * bp + C / 16; i += static_cast<size_t>(blocks) * blockDim.x)
      acc_g[i] = 0;
  // the read-only inputs every layer's preparation and epilogues read
  // first (the token-shift states, the per-layer vectors, the row scales)
  // towards L2 at once, so their first pass waits on L2 rather than HBM
  prefetch_l2(p.att_in, static_cast<size_t>(B) * L * C);
  prefetch_l2(p.ffn_in, static_cast<size_t>(B) * L * C);
  prefetch_l2(p.vecs, static_cast<size_t>(L) * kNumVec * C);
  if constexpr (WF != kBf16) prefetch_l2(p.scales, static_cast<size_t>(L) * sc_layer);

  for (int l = 0; l < L; ++l) {
    const int8_t* m_layer = p.mats + l * mo.layer;
    const float* s_rkv = p.scales + l * sc_layer;
    const float* s_l1 = s_rkv + 3 * C;
    const float* s_l2 = s_l1 + 4 * D;
    const float* s_out = s_l2 + 4 * C;
    const float* s_fk = s_out + C;
    const float* s_fv = s_fk + F;
    const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec * C;
    const float* cf = vec + kCoeff * C;
    const float* xk = vec + kXK * C;

    // ---- phase A: ln1, the shift mixes, rkv + lora1 rows -------------------
    // xl + (x_prev - xl) * coeff[m], m = r, w, k, v, a, g
    if constexpr (place_b) {
      for (int b = first; b < B; b += step) {
        float* x = x_g + static_cast<size_t>(b) * C;
        if (l == 0) {
          embed_warp<WF>(p, b, x);
          layer_norm_warp(x, p.ln0, p.ln0 + C, C, 1e-5f);
        }
        const size_t bl = (static_cast<size_t>(b) * L + l) * C;
        float* xl = p.att_out + bl;
        copy_warp(xl, x, C);
        layer_norm_warp(xl, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f);
        const float* att_in = p.att_in + bl;
        quantize_warp<WF, 6>(
            [&](int i, float4 (&v)[6]) {
              const float4 a = ld4(xl, i), xp = ld4(att_in, i);
#pragma unroll
              for (int m = 0; m < 6; ++m) v[m] = mix4(a, xp, ld4(cf + m * C, i));
            },
            C, q_g + static_cast<size_t>(b) * C, B * C, dx_g + b, B);
      }
      barrier();
    } else {
      // the mixes this block's tiles read: one bit each
      int mixes = 0;
      for (int sl = 0; sl < t_rkv.nslots; ++sl) mixes |= 1 << rkv_mix(t_rkv.p0 + sl);
      for (int sl = 0; sl < t_l1.nslots; ++sl) mixes |= 1 << lora1_mix(t_l1.p0 + sl);
      if (mixes != 0 || blockIdx.x == 0) {
        float* xr = xw + warp * C;
        for (int b = warp; b < B; b += kWarps) {
          if (l == 0) {
            embed_warp<WF>(p, b, xr);
            layer_norm_warp(xr, p.ln0, p.ln0 + C, C, 1e-5f);
            if (blockIdx.x == 0) copy_warp(x_g + static_cast<size_t>(b) * C, xr, C);
          } else {
            copy_warp(xr, x_g + static_cast<size_t>(b) * C, C);
          }
          layer_norm_warp(xr, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f);
          const size_t bl = (static_cast<size_t>(b) * L + l) * C;
          if (blockIdx.x == 0) copy_warp(p.att_out + bl, xr, C);
          const float* att_in = p.att_in + bl;
          for (int m = 0; m < bmma::kVectors; ++m) {  // the mixes this block's tiles read
            if (!(mixes >> m & 1)) continue;
            quantize_warp<WF, 1>(
                [&](int i, float4 (&v)[1]) {
                  v[0] = mix4(ld4(xr, i), ld4(att_in, i), ld4(cf + m * C, i));
                },
                C, acodes + (static_cast<size_t>(m) * bp + b) * cs_c, 0, dxs + m * bp + b, 0);
          }
        }
        zero_pad(bmma::kVectors, as_c);
        if constexpr (WF == kBf16) zero_tail(bmma::kVectors, C, as_c);
      }
      __syncthreads();
    }
    bmma::sweep<WF>(sw_rkv, m_layer + mo.rkv, s_rkv, pl.ks[bmma::kSwRkv], pl.ring, false, B, nt,
        src_a, work, srow, kRkvMixes, 1,
        [&](int row, int b, auto acc, float dx, const float* d) {
          const int part = row / C;
          const float y = dequant(acc, dx, d);
          (part == 0 ? r_g : part == 1 ? k_g : v_g)[static_cast<size_t>(b) * C + row - part * C] =
              y;
        });
    {
      bmma::sweep<LF>(sw_l1, m_layer + mo.l1, s_l1, pl.ks[bmma::kSwL1], pl.ring, true, B, nt,
          src_a, work, srow, kLora1Mixes, 1,
          [&](int row, int b, auto acc, float dx, const float* d) {
            const int part = row / D;
            float y = dequant(acc, dx, d);
            if (part == 0) y = tanhf(y);
            if (part == 2) y = sigmoidf(y);
            dn_g[static_cast<size_t>(b) * 4 * D + row] = y;
          });
    }
    barrier();

    // ---- phase C: (sequence, head) tasks: lora2, wkv7, group norm, gate --
    for (int task = blockIdx.x; task < B * H; task += gridDim.x) {  // block-uniform
      const int b = task / H, h = task % H;
      const size_t bc = static_cast<size_t>(b) * C;
      const size_t st = (static_cast<size_t>(b) * L + l) * H * S * S;
      const HeadIO io{r_g + bc, k_g + bc, v_g + bc, dn_g + static_cast<size_t>(b) * 4 * D,
                      vf_g + bc, xo_g + bc, p.heads_in + st, p.heads_out + st};
      v7_head_step<WF>(l, h, io, m_layer + mo.l2, s_l2, head_vecs(vec, C), C, S, D, hv, red,
                       dxc, q8c);
    }
    barrier();

    // ---- phase D: out rows + residual ----------------------------------------
    if constexpr (place_b) {
      for (int b = first; b < B; b += step) {
        const float* xo = xo_g + static_cast<size_t>(b) * C;
        quantize_warp<WF, 1>([&](int i, float4 (&v)[1]) { v[0] = ld4(xo, i); }, C,
                                          q_g + static_cast<size_t>(b) * C, 0, dx_g + b, 0);
      }
      barrier();
    } else if (t_out.nslots > 0) {
      for (int b = warp; b < B; b += kWarps) {
        const float* xo = xo_g + static_cast<size_t>(b) * C;
        quantize_warp<WF, 1>([&](int i, float4 (&v)[1]) { v[0] = ld4(xo, i); }, C,
                                          acodes + static_cast<size_t>(b) * cs_c, 0, dxs + b, 0);
      }
      zero_pad(1, as_c);
      if constexpr (WF == kBf16) zero_tail(1, C, as_c);
      __syncthreads();
    }
    bmma::sweep<WF>(sw_out, m_layer + mo.out, s_out, pl.ks[bmma::kSwOut], pl.ring, false, B, nt,
        src_a, work, srow, kOneVector, split_out,
        [&](int row, int b, auto acc, float dx, const float* d) {
          float* x = x_g + static_cast<size_t>(b) * C + row;
          *x = add(*x, dequant(acc, dx, d));
        });
    barrier();

    // ---- phase E: ln2 + shift, fk rows with relu^2 ---------------------------
    if constexpr (place_b) {
      for (int b = first; b < B; b += step) {
        const size_t bl = (static_cast<size_t>(b) * L + l) * C;
        float* xl = p.ffn_out + bl;
        copy_warp(xl, x_g + static_cast<size_t>(b) * C, C);
        layer_norm_warp(xl, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f);
        const float* ffn_in = p.ffn_in + bl;
        quantize_warp<WF, 1>(
            [&](int i, float4 (&v)[1]) { v[0] = mix4(ld4(xl, i), ld4(ffn_in, i), ld4(xk, i)); },
            C, q_g + static_cast<size_t>(b) * C, 0, dx_g + b, 0);
      }
      barrier();
    } else {
      if (t_fk.nslots > 0 || blockIdx.x == 0) {
        float* xr = xw + warp * C;
        for (int b = warp; b < B; b += kWarps) {
          copy_warp(xr, x_g + static_cast<size_t>(b) * C, C);
          layer_norm_warp(xr, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f);
          const size_t bl = (static_cast<size_t>(b) * L + l) * C;
          if (blockIdx.x == 0) copy_warp(p.ffn_out + bl, xr, C);
          const float* ffn_in = p.ffn_in + bl;
          if (t_fk.nslots > 0)
            quantize_warp<WF, 1>(
                [&](int i, float4 (&v)[1]) {
                  v[0] = mix4(ld4(xr, i), ld4(ffn_in, i), ld4(xk, i));
                },
                C, acodes + static_cast<size_t>(b) * cs_c, 0, dxs + b, 0);
        }
        if (t_fk.nslots > 0) {
          zero_pad(1, as_c);
          if constexpr (WF == kBf16) zero_tail(1, C, as_c);
        }
      }
      __syncthreads();
    }
    bmma::sweep<WF>(sw_fk, m_layer + mo.fk, s_fk, pl.ks[bmma::kSwFk], pl.ring, false, B, nt,
        src_a, work, srow, kOneVector, 1,
        [&](int row, int b, auto acc, float dx, const float* d) {
          const float y = fmaxf(dequant(acc, dx, d), 0.f);
          fk_g[static_cast<size_t>(b) * F + row] = mul(y, y);
        });
    barrier();

    // ---- phase F: fv rows + residual -----------------------------------------
    if constexpr (place_b) {
      for (int b = first; b < B; b += step) {
        const float* fk = fk_g + static_cast<size_t>(b) * F;
        quantize_warp<WF, 1>([&](int i, float4 (&v)[1]) { v[0] = ld4(fk, i); }, F,
                                          q_g + static_cast<size_t>(b) * F, 0, dx_g + b, 0);
      }
      barrier();
    } else if (t_fv.nslots > 0) {
      for (int b = warp; b < B; b += kWarps) {
        const float* fk = fk_g + static_cast<size_t>(b) * F;
        quantize_warp<WF, 1>([&](int i, float4 (&v)[1]) { v[0] = ld4(fk, i); }, F,
                                          acodes + static_cast<size_t>(b) * cs_f, 0, dxs + b, 0);
      }
      zero_pad(1, as_f);
      if constexpr (WF == kBf16) zero_tail(1, F, as_f);
      __syncthreads();
    }
    bmma::sweep<WF>(sw_fv, m_layer + mo.fv, s_fv, pl.ks[bmma::kSwFv], pl.ring, false, B, nt,
        src_f, work, srow, kOneVector, split_fv,
        [&](int row, int b, auto acc, float dx, const float* d) {
          float* x = x_g + static_cast<size_t>(b) * C + row;
          *x = add(*x, dequant(acc, dx, d));
        });
    barrier();
  }
}

// The kernel of form wf in placement (b) (place_b) or (a).
const void* kernel_for(int wf, bool place_b = false) {
  if (wf == kBf16)
    return place_b ? reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kBf16, true>)
                   : reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kBf16, false>);
  if (wf == kInt4)
    return place_b ? reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kInt4, true>)
                   : reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kInt4, false>);
  return place_b ? reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kInt8, true>)
                 : reinterpret_cast<const void*>(v7_decode_batched_mma_kernel<kInt8, false>);
}

// The static shared memory of the kernels of form wf (bytes; the larger of
// the two placements'), or a negative CUDA error code.
int static_smem(int wf) {
  int most = 0;
  for (int pb = 0; pb < 2; ++pb) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(wf, pb != 0));
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int bytes = static_cast<int>(attr.sharedSizeBytes);
    if (bytes > most) most = bytes;
  }
  return most;
}

// Grid size a launch in form wf uses (blocks), or a negative CUDA error
// code (0: the kernel does not fit on an SM at these sizes). The shared
// memory depends on B (the plan); one block an SM fits whatever a plan
// asks, up to the limit less the static bytes.
int grid_for(int wf, int C, int S, int D, int F) {
  int dev = 0, sms = 0, per_sm = 0;
  const int st = static_smem(wf);
  if (st < 0) return st;
  const size_t smem = kSmemLimit - st;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  per_sm = 1;  // one block per SM, as K3, if every kernel of the form fits one
  for (int pb = 0; pb < 2 && err == cudaSuccess; ++pb) {
    int n = 0;
    err = set_smem(kernel_for(wf, pb != 0), smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_for(wf, pb != 0), kThreads,
                                                          smem);
    if (n < per_sm) per_sm = n;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return per_sm * sms;
}

// The plan's checks: a placement and ring the kernel knows, K slices of
// whole steps (128 codes, 64 values in the bf16 form) up to each sweep's
// K, a batch whose units fit; the shared bytes Layout counts (0 on a
// refused plan).
size_t plan_smem(int wf, int C, int S, int D, int F, int B, int grid_blocks,
                 const bmma::Plan& pl) {
  if (B <= 0 || B > bmma::kMaxBatch || grid_blocks <= 0 || (pl.place != 0 && pl.place != 1) ||
      (pl.ring != 1 && pl.ring != 2))
    return 0;
  const int step = wf == kBf16 ? bmma::kBf16Step : 128;
  for (int i = 0; i < bmma::kNumSweeps; ++i) {
    const int k = bmma::sweep_dims(i, wf, C, D, F).K;
    if (pl.ks[i] < step || pl.ks[i] % step || pl.ks[i] > bmma::round_up(k, step)) return 0;
  }
  return bmma::Layout(wf, C, S, D, F, B, grid_blocks, pl).total;
}

// Launches the kernel of form wf on `grid_blocks` blocks with the plan
// `pl`, checked first (plan_smem), its shared bytes the same as Layout
// counts and within the limit with the static bytes.
int launch(int wf, const void* tokens, const void* emb, const void* ln0, const void* mats,
           const void* scales, const void* vecs, const void* att_in, const void* ffn_in,
           const void* heads_in, void* att_out, void* ffn_out, void* heads_out, void* scratch,
           int C, int H, int S, int D, int F, int L, int B, int emb_f32, int grid_blocks,
           const bmma::Plan& pl, void* stream) {
  if (kThreads % S != 0 || S * S / kThreads > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = plan_smem(wf, C, S, D, F, B, grid_blocks, pl);
  if (smem == 0 || smem != static_cast<size_t>(pl.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int st = static_smem(wf);
  if (st < 0) return -st;
  if (pl.smem + st > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.tokens = static_cast<const int*>(tokens);
  a.emb = emb;
  a.ln0 = static_cast<const float*>(ln0);
  a.mats = static_cast<const int8_t*>(mats);
  a.scales = static_cast<const float*>(scales);
  a.vecs = static_cast<const float*>(vecs);
  a.att_in = static_cast<const float*>(att_in);
  a.ffn_in = static_cast<const float*>(ffn_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.att_out = static_cast<float*>(att_out);
  a.ffn_out = static_cast<float*>(ffn_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.H = H; a.S = S; a.D = D; a.F = F; a.L = L; a.B = B;
  a.emb_f32 = emb_f32;
  bmma::Plan plan = pl;
  void* kargs[] = {&a, &plan};
  const void* kernel = kernel_for(wf, plan.place != 0);
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks), dim3(kThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int form_of(int form) { return form == 2 ? kBf16 : form == 1 ? kInt4 : kInt8; }

}  // namespace

// Grid size the launch below uses (blocks), or a negative CUDA error code
// (0: the kernel does not fit on an SM at these sizes); w4 picks w4a8.
extern "C" int rwkv_v7_decode_batched_grid(int C, int S, int D, int F, int w4) {
  return grid_for(w4 ? kInt4 : kInt8, C, S, D, F);
}

// The kernels' static shared memory of form `form` (0 w8a8, 1 w4a8, 2
// bf16; bytes), or a negative CUDA error code:
// ops/megakernel.py::K4_STATIC_SMEM must match it (a card test reads it).
extern "C" int rwkv_v7_decode_batched_static_smem(int form) {
  return static_smem(form_of(form));
}

// The dynamic shared bytes a launch of form `form` (0 w8a8, 1 w4a8, 2
// bf16) takes with the plan's ints (place, ring, five K slices; as
// ops/megakernel.py::batched_plan computes them) for B sequences on
// `blocks` blocks, or 0 for a plan the kernel refuses.
extern "C" long long rwkv_v7_decode_batched_smem(int form, int C, int S, int D, int F, int B,
                                                 int blocks, int place, int ring, int ks_rkv,
                                                 int ks_lora1, int ks_out, int ks_fk, int ks_fv) {
  const bmma::Plan pl{place, ring, {ks_rkv, ks_lora1, ks_out, ks_fk, ks_fv}, 0};
  return static_cast<long long>(plan_smem(form_of(form), C, S, D, F, B, blocks, pl));
}

// w8a8 / w4a8 (w4). The last eight ints are the plan of
// ops/megakernel.py::batched_plan: place (0: a, 1: b), ring, the K slices
// of the rkv, lora1, out, fk and fv sweeps, the dynamic shared bytes.
extern "C" int rwkv_v7_decode_batched(const void* tokens, const void* emb, const void* ln0,
                                      const void* mats, const void* scales, const void* vecs,
                                      const void* att_in, const void* ffn_in,
                                      const void* heads_in, void* att_out, void* ffn_out,
                                      void* heads_out, void* scratch,
                                      int C, int H, int S, int D, int F, int L, int B, int w4,
                                      int grid_blocks, int place, int ring, int ks_rkv,
                                      int ks_lora1, int ks_out, int ks_fk, int ks_fv, int smem,
                                      void* stream) {
  const bmma::Plan pl{place, ring, {ks_rkv, ks_lora1, ks_out, ks_fk, ks_fv}, smem};
  return launch(w4 ? kInt4 : kInt8, tokens, emb, ln0, mats, scales, vecs, att_in, ffn_in,
                heads_in, att_out, ffn_out, heads_out, scratch, C, H, S, D, F, L, B, 0,
                grid_blocks, pl, stream);
}

// The bf16 form: the same pointers (no scales are read: pass null), and
// emb_f32 in place of w4 (the embedding table is f32, not bf16); the plan
// of batched_plan("bf16", ...) as above.
extern "C" int rwkv_v7_decode_batched_bf16_grid(int C, int S, int D, int F) {
  return grid_for(kBf16, C, S, D, F);
}

extern "C" int rwkv_v7_decode_batched_bf16(const void* tokens, const void* emb, const void* ln0,
                                           const void* mats, const void* scales,
                                           const void* vecs, const void* att_in,
                                           const void* ffn_in, const void* heads_in,
                                           void* att_out, void* ffn_out, void* heads_out,
                                           void* scratch, int C, int H, int S, int D, int F,
                                           int L, int B, int emb_f32, int grid_blocks, int place,
                                           int ring, int ks_rkv, int ks_lora1, int ks_out,
                                           int ks_fk, int ks_fv, int smem, void* stream) {
  const bmma::Plan pl{place, ring, {ks_rkv, ks_lora1, ks_out, ks_fk, ks_fv}, smem};
  return launch(kBf16, tokens, emb, ln0, mats, scales, vecs, att_in, ffn_in, heads_in, att_out,
                ffn_out, heads_out, scratch, C, H, S, D, F, L, B, emb_f32, grid_blocks, pl,
                stream);
}
