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
// Design: K6's persistent kernel (one block per SM, launched cooperatively,
// phases separated by grid-wide barriers) without K6's maa and decay LoRA
// phases, five phases a layer:
//   A  ln1 and the token shift, the 3 (5.1) or 4 (5.2) mixes in the
//      reference's op order, each quantized as a whole vector (every block
//      redundantly), the fused r, k, v(, g) rows (silu on g)
//   C  per head (one block each): the wkv step with the static decay -- the
//      output reads the OLD state plus the tf bonus, then the state decays
//      and takes k v^T -- group norm (eps 1e-5), ln_x, times the gate (5.2)
//   D  out rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//   F  fv rows: x += sigmoid(fr) * fv
// then ln_out and the head rows (stream::head_phase).
//
// As K6 (decode_stream.cuh), every input that does not depend on the token
// -- the weight rows with their row scales, the vector rows a phase reads,
// att_in / ffn_in and phase C's state rows -- reaches shared memory through
// a ring of stages fed by 1-D bulk asynchronous copies, in the order the
// block consumes them. A static plan (Layout5 / Plan5 / piece_copy;
// ops/megakernel.py::v5_stream_plan mirrors it) gives each block contiguous
// ranges of each phase's rows, in 4-row groups, cut into pieces of as many
// whole rows as fit a stage, each followed by the 16-byte window of its row
// scales; a phase's vector rows go in pieces of as many rows as fit a stage
// (kMaxVecRows at most), and a head's state with its decay, bonus and ln_x
// rows in one piece. A producer warp (the block's ninth) issues each piece
// as soon as every consumer warp has released the piece before it in that
// stage, so the next phases' rows are in flight while the consumers wait at
// the grid barriers; the eight consumer warps synchronize on a named barrier
// and cross the grid on a barrier of their own. Each row is computed with
// the lanes, the chunk order and the shuffle tree that matvec_rows gives it,
// so the outputs do not depend on the grid. Phases D and F quantize their
// input vector (xo, the relu^2 keys) in one pass from an amax that the
// producing phase's epilogues published with atomicMax; A and E fold their
// mixes' amax into the layer norm's last pass (A where the ring holds all
// its vector pieces at once, phase_a_fused).
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole, the int32 sum is scaled as (float(acc) * dx) * d, and the
// elementwise formulas use explicit round-to-nearest multiplies and adds,
// so that no fused multiply-add shifts an activation across a code
// boundary. The bf16 form (WF = kBf16, common.cuh) stages each input
// vector in f32 and reads no scales.
#include "decode_stream.cuh"
#include "v45_common.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp that issues the block's stream
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

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
  float* scratch;           // scratch_floats(C, F, L); x ends at scratch[0..C)
  int C, H, S, F, L, V;
  int emb_f32;
};

// A layer's published amax slots in the scratch: xo and the relu^2 keys.
constexpr int kAmaxSlots = 2;
enum AmaxSlot { kAmXo = 0, kAmFk = 1 };

// Floats of the kernel's global scratch: x, r|k|v|g (4C), xo, sigmoid(fr)
// and the relu^2 keys (F), then kAmaxSlots amax slots a layer (the kernel
// clears them); the Python wrapper allocates the same. The timing build's
// stamps follow.
__host__ __device__ inline size_t scratch_floats(int C, int F, int L) {
  return 7ull * C + F + static_cast<size_t>(kAmaxSlots) * L;
}

// ---- the stream plan (ops/megakernel.py::v5_stream_plan mirrors it) --------

using stream::Rows;
using stream::part;
using stream::round_up;
using stream::max2;

constexpr int kMaxVecRows = 8;  // vector rows a piece at most (a copy each)

// Shared memory of a launch: xs, xl (C floats each), hv (5S), red (256),
// dxs (8), the block-local amax slots, the activations (int8 codes, or f32
// in the bf16 form; max(4C, F) of them), then the block's plan, its
// mbarriers and the ring (stream::Ring), each stage at least the largest
// piece.
__host__ __device__ inline size_t act_off5(int C, int S) {
  return round_up(4 * (2ull * C + 5ull * S + 256 + 8 + kAmaxSlots), 16);
}

__host__ __device__ inline size_t plan_off5(int C, int S, int F, int wf) {
  const size_t acts = static_cast<size_t>(4 * C > F ? 4 * C : F);
  return round_up(act_off5(C, S) + (wf == kBf16 ? 4 : 1) * acts, 16);
}

// the largest piece: two vector rows, a head's state with its four vector
// slices, one row of any matrix with its scale window
__host__ __device__ inline size_t piece5(int C, int S, int F, int wf) {
  const int sf = small_form(wf);
  const size_t piece = max2(8ull * C, 4ull * S * S + 16ull * S);
  size_t row = max2(form_bytes(wf, C), form_bytes(wf, F));
  row = max2(row, form_bytes(sf, C));
  return max2(piece, row + stream::win_bytes(1));
}

struct Layout5 : stream::Ring {
  size_t act_off;
  int vec_rows;  // vector rows a piece
  __host__ __device__ Layout5(int C, int S, int F, int wf)
      : stream::Ring(plan_off5(C, S, F, wf), piece5(C, S, F, wf)), act_off(act_off5(C, S)) {
    const size_t n = stage / (4ull * C);
    vec_rows = n < kMaxVecRows ? static_cast<int>(n) : kMaxVecRows;
  }
};

// The pieces of a layer in stream order (then those of the head). A piece
// fills one stage; a segment is a run of pieces.
enum Seg5 {
  sVecA,    // ln1 w, b, the NA attention mixes, att_in: vec_rows rows a piece
  sAtt,     // the fused r, k, v(, g) rows
  sHeads,   // per head of the block: its state, then td, tf, ln_x w, b
  sOut,
  sVecE,    // ln2 w, b, the FFN mixes k, r, ffn_in: vec_rows rows a piece
  sFk, sFr, sFv,
  kLayerSegs,
  sLnOut = kLayerSegs,  // ln_out w | b
  sHead,
  kAllSegs
};

constexpr int kVecE = 5;  // phase E's vector rows

// Pieces of a run of n vector rows, vr a piece.
__host__ __device__ inline int vec_pieces(int n, int vr) { return (n + vr - 1) / vr; }

// Block b's share of every phase.
struct Plan5 {
  Rows att, out, fk, fr, fv, head;
  int heads, na, vec_rows;
  __host__ __device__ Plan5(const Layout5& lo, int C, int F, int H, int V, int NA, int wf,
                            int blocks, int b) {
    const int sf = small_form(wf);
    const bool w = wf != kBf16;
    const int bc = static_cast<int>(form_bytes(wf, C)), sc = static_cast<int>(form_bytes(sf, C));
    const int big = lanes_for(C, wf);
    att = part(NA * C, blocks, b, false, bc, w, lo.stage, big);
    out = part(C, blocks, b, false, bc, w, lo.stage, big);
    fk = part(F, blocks, b, false, bc, w, lo.stage, big);
    fr = part(C, blocks, b, true, bc, w, lo.stage, big);
    fv = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, F)), w, lo.stage,
              lanes_for(F, wf));
    head = part(V, blocks, b, false, sc, w, lo.stage, 8);
    heads = b < H ? (H - b + blocks - 1) / blocks : 0;
    na = NA;
    vec_rows = lo.vec_rows;
  }
  __host__ __device__ const Rows* rows(int seg) const {
    switch (seg) {
      case sAtt: return &att;
      case sOut: return &out;
      case sFk: return &fk;
      case sFr: return &fr;
      case sFv: return &fv;
      case sHead: return &head;
      default: return nullptr;
    }
  }
  __host__ __device__ int count(int seg) const {
    const Rows* r = rows(seg);
    if (r != nullptr) return r->pieces();
    if (seg == sVecA) return vec_pieces(3 + na, vec_rows);
    if (seg == sVecE) return vec_pieces(kVecE, vec_rows);
    return seg == sHeads ? heads : 1;
  }
  __host__ __device__ int layer_pieces() const {
    int n = 0;
    for (int s = 0; s < kLayerSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(Plan5) <= stream::kPlanBytes, "the plan's shared bytes");

// Whether phase A holds all its vector pieces at once and folds the
// mixes' amax into the layer norm's last pass: where the ring has the
// stages. Else (5.2 at two rows a piece, as C=4096 in bf16) it releases
// ln1's piece after the layer norm and quantizes the mixes in a pass of
// their own, holding at most three pieces (the same values and codes).
__host__ __device__ inline bool phase_a_fused(int NA, int vec_rows, int stages) {
  return vec_pieces(3 + NA, vec_rows) <= stages;
}

// Copy i of piece idx of segment seg of layer l for block b of a grid of
// `blocks` (plan pl): a 16-byte multiple from a 16-byte aligned src into
// the stage at offset dst. Returns false past the piece's last copy.
__host__ __device__ inline bool piece_copy(const Args& p, const MatOffsets45& mo,
                                           const ScaleOffsets45& so, const Plan5& pl, int wf,
                                           int b, int blocks, int l, int seg, int idx, int i,
                                           const void** src, uint32_t* dst, uint32_t* bytes) {
  const int C = p.C, S = p.S;
  const bool w = wf != kBf16;
  const unsigned char* mats = reinterpret_cast<const unsigned char*>(p.mats) + l * mo.layer;
  const float* scales = w ? p.scales + l * so.layer : nullptr;
  const float* vec = p.vecs + static_cast<size_t>(l) * (kAmix + pl.na) * C;
  auto put = [&](const void* s_, uint32_t d_, uint32_t n_) {
    *src = s_;
    *dst = d_;
    *bytes = n_;
    return true;
  };
  // piece idx of r's rows from base, then the window of their row scales
  // when scl is not null
  auto rows = [&](const Rows& r, const void* base_v, const float* scl) {
    const unsigned char* base = static_cast<const unsigned char*>(base_v);
    const int c0 = r.c0(idx), c1 = r.c1(idx);
    const uint32_t nb = static_cast<uint32_t>((c1 - c0) * r.rb);
    if (i == 0) return put(base + static_cast<size_t>(c0) * r.rb, 0u, nb);
    if (i == 1 && scl != nullptr) {
      const int w0 = c0 & ~3, w1 = (c1 + 3) & ~3;
      return put(scl + w0, nb, static_cast<uint32_t>(4 * (w1 - w0)));
    }
    return false;
  };
  // row j of a run of n vector rows (vec_row(j) its address), vec_rows a
  // piece, one copy a row
  auto vec_run = [&](int n, auto vec_row) {
    const int j = idx * pl.vec_rows + i;
    return i < pl.vec_rows && j < n && put(vec_row(j), 4u * C * i, 4u * C);
  };
  switch (seg) {
    case sVecA:
      return vec_run(3 + pl.na, [&](int j) -> const float* {
        if (j < 2) return vec + (kLn1W + j) * C;
        if (j < 2 + pl.na) return vec + (kAmix + j - 2) * C;
        return p.att_in + static_cast<size_t>(l) * C;
      });
    case sAtt: return rows(pl.att, mats + mo.att, w ? scales + so.att : nullptr);
    case sHeads: {
      const int h = b + idx * blocks;
      if (i == 0)
        return put(p.heads_in + (static_cast<size_t>(l) * p.H + h) * S * S, 0u, 4u * S * S);
      const int vrows[4] = {kTD, kTF, kLnxW, kLnxB};
      return i < 5 && put(vec + vrows[i - 1] * C + h * S, 4u * S * S + 4u * S * (i - 1), 4u * S);
    }
    case sOut: return rows(pl.out, mats + mo.out, w ? scales + so.out : nullptr);
    case sVecE:
      return vec_run(kVecE, [&](int j) -> const float* {
        if (j < 4) return vec + (kLn2W + j) * C;  // ln2 w, b, fmix k, r
        return p.ffn_in + static_cast<size_t>(l) * C;
      });
    case sFk: return rows(pl.fk, mats + mo.fk, w ? scales + so.fk : nullptr);
    case sFr: return rows(pl.fr, mats + mo.fr, w ? scales + so.fr : nullptr);
    case sFv: return rows(pl.fv, mats + mo.fv, w ? scales + so.fv : nullptr);
    case sLnOut: return i == 0 && put(p.ln_out, 0u, 8u * C);
    case sHead: return rows(pl.head, p.head, w ? p.head_d : nullptr);
    default: return false;
  }
}

// The grid barrier's word (stream::grid_sync).
__device__ unsigned g_grid_count = 0;

template <int WF, bool GATE>
__global__ void __launch_bounds__(kBlockThreads, 1)
v5_decode_kernel(Args p) {
  constexpr int NA = GATE ? 4 : 3;    // fused attention projections and mixes
  constexpr int LF = small_form(WF);  // the head's form
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, H = p.H, S = p.S, F = p.F;
  const int tid = threadIdx.x;
  const Layout5 lo(C, S, F, WF);
  const MatOffsets45 mo(C, F, NA, WF);
  const ScaleOffsets45 so(C, F, NA);

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);    // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized
  float* hv = xl + C;                            // [5S] per-head vectors
  float* red = hv + 5 * S;                       // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAmaxSlots] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(4C, F)] activations
  Plan5* plan = reinterpret_cast<Plan5*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);  // one a stage
  uint64_t* empty = full + stream::kMaxStages;                      // one a stage
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);

  if (tid == 0) {
    *plan = Plan5(lo, C, F, H, p.V, NA, WF, gridDim.x, blockIdx.x);
    for (int s = 0; s < stages; ++s) {
      stream::mbar_init(&full[s], 1);
      stream::mbar_init(&empty[s], stream::kConsumerWarps);
    }
    stream::fence_mbar_init();
  }
  if (tid < kAmaxSlots) amx[tid] = 0u;
  __syncthreads();  // the last barrier of all 288 threads
  const Plan5& pl = *plan;
  if (tid >= kThreads) {
    // the producer warp
    const int b = blockIdx.x, blocks = gridDim.x;
    stream::produce<kLayerSegs, kAllSegs>(
        pl, p.L, stages, ring, lo.stage, full, empty,
        [&](int l, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return piece_copy(p, mo, so, pl, WF, b, blocks, l, seg, idx, i, src, dst, bytes);
        });
    return;
  }

  float* x_g = p.scratch;           // residual stream
  float* att_g = x_g + C;           // [4][C] r, k, v, silu(g)
  float* xo_g = att_g + 4 * C;      // attention output before `out`
  float* rg_g = xo_g + C;           // sigmoid(fr rows)
  float* fk_g = rg_g + C;           // [F] relu^2 keys
  unsigned* amax_g = reinterpret_cast<unsigned*>(p.scratch + scratch_floats(C, F, 0));

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, F, p.L));
  int n_marks = 0;
#endif
  // a grid-wide barrier of the consumers, with a timestamp on each side in
  // the timing build
  auto barrier = [&]() {
    PHASE_MARK();
    stream::csync();
    if (tid == 0) stream::grid_sync(&g_grid_count, gridDim.x);
    stream::csync();
    PHASE_MARK();
  };
  PHASE_MARK();

  // ---- the consumers' side of the stream, in piece order ------------------
  stream::Stream cs{ring, lo.stage, stages, full, empty};
  // the block-local amax slots into the layer's global ones (int forms)
  auto publish = [&](unsigned* slots) {
    if constexpr (kQuant) stream::publish_amax<kAmaxSlots>(amx, slots);
  };
  // rows [first, n) of a run of vector rows (n <= 3 + NA, first a multiple
  // of vec_rows), vec_rows a piece, into vrow[]; returns the pieces waited
  const float* vrow[3 + NA];
  auto wait_run = [&](int first, int n) {
    const float* base = nullptr;
#pragma unroll
    for (int j = 0; j < 3 + NA; ++j) {
      if (j >= first && j < n) {
        const int k = j % pl.vec_rows;
        if (k == 0) base = reinterpret_cast<const float*>(cs.wait());
        vrow[j] = base + k * C;
      }
    }
    return vec_pieces(n, pl.vec_rows) - first / pl.vec_rows;
  };
  const bool fused_a = phase_a_fused(NA, pl.vec_rows, stages);

  for (int l = 0; l < p.L; ++l) {
    unsigned* amax_l = amax_g + kAmaxSlots * l;

    // ---- phase A: ln1, shift, the mixes quantized, r k v (g) rows ---------
    if (l == 0) {
      const size_t e = static_cast<size_t>(*p.token) * C;
      for (int c = tid; c < C; c += kThreads) xl[c] = emb_at(p.emb, p.emb_f32, e + c);
      stream::csync();
      stream::layer_norm(xl, xs, p.ln0, p.ln0 + C, C, 1e-5f, red);
      if (blockIdx.x == 0) {
        for (int c = tid; c < C; c += kThreads) x_g[c] = xs[c];
        // every layer's amax slots, cleared before the first barrier
        for (int i = tid; i < kAmaxSlots * p.L; i += kThreads) amax_g[i] = 0u;
      }
    } else {
      stream::load_vec(xs, x_g, C);
      stream::csync();
    }
    {
      // ln1 w, b, the mixes k, v, r(, g), att_in
      auto mix = [&](int m, int c) { return mix45(xl[c], vrow[2 + NA][c], vrow[2 + m][c]); };
      if (fused_a) {
        const int held = wait_run(0, 3 + NA);
        stream::layer_norm_act<WF, NA>(xs, xl, vrow[0], vrow[1], C, 1e-5f, red,
                                       [](int, float) {}, mix, q8, C, dxs);
        cs.release(held);
      } else {
        const float* ln = reinterpret_cast<const float*>(cs.wait());  // ln1 w | b
        stream::layer_norm(xs, xl, ln, ln + C, C, 1e-5f, red);
        cs.release(1);
        const int held = wait_run(2, 3 + NA);
        stream::act_n<WF, NA>(mix, C, q8, C, dxs, red);
        cs.release(held);
      }
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    cs.rows<WF>(pl.att, C, [&](int row) { return q8 + att_mix(row / C) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = row / C;
                  float y = dequant(acc, dxs[att_mix(part)], d);
                  if (GATE && part == 3) y = mul(y, sigmoidf(y));  // silu gate
                  att_g[row] = y;
                });
    barrier();

    // ---- phase C: per head: wkv with the static decay, group norm, ln_x ---
    // a head's r, k, v and gate, loaded ahead of their use
    float hr = 0.f, hk = 0.f, hvv = 0.f, hg = 0.f;
    auto fetch_head = [&](int h) {
      if (tid < S) {
        const int c = h * S + tid;
        hr = __ldcg(att_g + c);
        hk = __ldcg(att_g + C + c);
        hvv = __ldcg(att_g + 2 * C + c);
        if (GATE) hg = __ldcg(att_g + 3 * C + c);
      }
    };
    if (pl.heads > 0) fetch_head(blockIdx.x);
    for (int j = 0; j < pl.heads; ++j) {  // block-uniform
      const int h = blockIdx.x + j * gridDim.x;
      float* h_r = hv;
      float* h_k = hv + S;
      float* h_v = hv + 2 * S;
      float* h_w = hv + 3 * S;
      float* h_y = hv + 4 * S;
      // the head's piece: its S x S state, then td, tf, ln_x w, ln_x b
      const float* st = reinterpret_cast<const float*>(cs.wait());
      const float* td = st + S * S;
      const float* tf = td + S;
      const float* lnx_w = tf + S;
      const float* lnx_b = lnx_w + S;
      const int c = h * S + tid;
      float dot_part = 0.f;
      const float gate = hg;
      if (tid < S) {
        h_r[tid] = hr;
        h_k[tid] = hk;
        h_v[tid] = hvv;
        h_w[tid] = td[tid];
        dot_part = mul(mul(hr, tf[tid]), hk);
      }
      if (j + 1 < pl.heads) fetch_head(h + gridDim.x);
      const float dot = stream::block_sum(dot_part, red);  // also orders the h_* stores

      // state rows: tpr threads per row i, entries j = jj * tpr + part
      const int tpr = kThreads / S;
      const int jn = S / tpr;
      const int i = tid / tpr, part = tid % tpr;
      const float* st_in = st + i * S;
      float* st_out =
          p.heads_out + (static_cast<size_t>(l) * H * S + static_cast<size_t>(h) * S + i) * S;
      const float vi = h_v[i];
      float yi = 0.f;
#pragma unroll
      for (int jj = 0; jj < kMaxJ; ++jj) {
        if (jj < jn) {
          const int jx = jj * tpr + part;
          const float sv = st_in[jx];
          yi += sv * h_r[jx];
          st_out[jx] = add(mul(sv, h_w[jx]), mul(h_k[jx], vi));
        }
      }
      for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
      if (part == 0) h_y[i] = add(yi, mul(vi, dot));
      stream::csync();

      const float yv = tid < S ? h_y[tid] : 0.f;
      const float mu = stream::block_sum(yv, red) / static_cast<float>(S);
      const float yc = tid < S ? sub(yv, mu) : 0.f;
      const float var = stream::block_sum(mul(yc, yc), red) / static_cast<float>(S);
      if (tid < S) {
        const float yn = mul(yc, rsqrtf(add(var, 1e-5f)));
        const float xo = add(mul(yn, lnx_w[tid]), lnx_b[tid]);
        const float v = GATE ? mul(xo, gate) : xo;
        xo_g[c] = v;
        if constexpr (kQuant) stream::note_amax(&amx[kAmXo], v);
      }
      stream::csync();
      cs.release(1);
    }
    publish(amax_l);
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    {
      // the residual at this block's out rows, loaded beside the codes (into
      // xs, free until E)
      const int r0 = pl.out.r0, nr = pl.out.r1 - r0;
      const float x0 = tid < nr ? __ldcg(x_g + r0 + tid) : 0.f;
      stream::act_published<WF, 1>(xo_g, C, q8, dxs, amax_l + kAmXo);
      for (int i = tid; i < nr; i += kThreads) xs[i] = i == tid ? x0 : __ldcg(x_g + r0 + i);
      stream::csync();
      cs.rows<WF>(pl.out, C, [&](int) { return q8; },
                  [&](int row, auto acc, const float* d) {
                    x_g[row] = add(xs[row - r0], dequant(acc, dxs[0], d));
                  });
    }
    barrier();

    // ---- phase E: ln2 + shift, fk rows with relu^2, fr rows with sigmoid ----
    stream::load_vec(xs, x_g, C);
    stream::csync();
    {
      const int held = wait_run(0, kVecE);  // ln2 w, b, fmix k, r, ffn_in
      const float* fin = vrow[4];
      stream::layer_norm_act<WF, 2>(
          xs, xl, vrow[0], vrow[1], C, 1e-5f, red, [](int, float) {},
          [&](int m, int c) { return mix45(xl[c], fin[c], vrow[2 + m][c]); }, q8, C, dxs);
      cs.release(held);
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.ffn_out[static_cast<size_t>(l) * C + c] = xl[c];
    cs.rows<WF>(pl.fk, C, [&](int) { return q8; },
                [&](int row, auto acc, const float* d) {
                  const float y = fmaxf(dequant(acc, dxs[0], d), 0.f);
                  const float v = mul(y, y);
                  fk_g[row] = v;
                  if constexpr (kQuant) stream::note_amax(&amx[kAmFk], v);
                });
    cs.rows<WF>(pl.fr, C, [&](int) { return q8 + C; },
                [&](int row, auto acc, const float* d) {
                  rg_g[row] = sigmoidf(dequant(acc, dxs[1], d));
                });
    publish(amax_l);
    barrier();

    // ---- phase F: fv rows, x += sigmoid(fr) * fv ----------------------------
    {
      // the residual and sigmoid(fr) at this block's fv rows, loaded beside
      // the codes (into xs and xl, free until the next layer)
      const int r0 = pl.fv.r0, nr = pl.fv.r1 - r0;
      const float x0 = tid < nr ? __ldcg(x_g + r0 + tid) : 0.f;
      const float g0 = tid < nr ? __ldcg(rg_g + r0 + tid) : 0.f;
      stream::act_published<WF, 1>(fk_g, F, q8, dxs, amax_l + kAmFk);
      for (int i = tid; i < nr; i += kThreads) {
        xs[i] = i == tid ? x0 : __ldcg(x_g + r0 + i);
        xl[i] = i == tid ? g0 : __ldcg(rg_g + r0 + i);
      }
      stream::csync();
      cs.rows<WF>(pl.fv, F, [&](int) { return q8; },
                  [&](int row, auto acc, const float* d) {
                    x_g[row] = add(xs[row - r0], mul(xl[row - r0], dequant(acc, dxs[0], d)));
                  });
    }
    barrier();
  }

  // ---- head: ln_out, quantize, the V head rows ------------------------------
  stream::head_phase<LF>(cs, pl.head, x_g, C, xs, xl, red, dxs, q8, p.logits);
  PHASE_MARK();
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

// Why K7 cannot run these shapes (a CUDA error code), or 0.
int shape_error(int wf, int C, int H, int S, int F, int V) {
  const Layout5 lo(C, S, F, wf);
  if (S <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ || S % 4 != 0 || H * S != C ||
      C % 16 != 0 || F % 16 != 0 || V % 4 != 0 || lo.vec_rows < 2 ||
      static_cast<int>(lo.stages) < stream::kMinStages)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int launch(int wf, const void* token, const void* emb, const void* ln0, const void* mats,
           const void* scales, const void* vecs, const void* head, const void* head_d,
           const void* ln_out, const void* att_in, const void* ffn_in, const void* heads_in,
           void* att_out, void* ffn_out, void* heads_out, void* logits, void* scratch, int C,
           int H, int S, int F, int L, int V, int gate, int emb_f32, int grid_blocks,
           void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = shape_error(wf, C, H, S, F, V);
  if (bad != 0) return bad;
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
  const size_t smem = Layout5(C, S, F, wf).smem;
  const void* kernel = kernel_for(wf, gate != 0);
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks), dim3(kBlockThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Grid size both variants (5.1, 5.2) of a form can launch with, after
// setting their shared memory limit: blocks, or a negative CUDA error code.
int grid_blocks_for(int wf, int C, int S, int F) {
  const size_t smem = Layout5(C, S, F, wf).smem;
  const int n51 = cooperative_grid(kernel_for(wf, false), kBlockThreads, smem);
  const int n52 = cooperative_grid(kernel_for(wf, true), kBlockThreads, smem);
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

// The stream plan of form wf (0 int8, 1 int4, 2 bf16; gate = 1 for 5.2) as
// the kernel computes it, for the card tests to hold ops/megakernel.py::
// v5_stream_plan to: out[0] the launch's dynamic shared bytes, out[1] a
// stage's bytes, out[2] the stages, out[3] block `block`'s pieces a layer
// of a grid of `blocks`, out[4] its pieces of the head, out[5] the form's
// kernel's static shared bytes. Returns a CUDA error code (0: none).
extern "C" int rwkv_v5_decode_plan(int wf, int gate, int C, int S, int F, int H, int V,
                                   int blocks, int block, long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout5 lo(C, S, F, wf);
  const Plan5 pl(lo, C, F, H, V, gate != 0 ? 4 : 3, wf, blocks, block);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(wf, gate != 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<long long>(lo.smem);
  out[1] = static_cast<long long>(lo.stage);
  out[2] = static_cast<long long>(lo.stages);
  out[3] = pl.layer_pieces();
  out[4] = pl.count(sLnOut) + pl.count(sHead);
  out[5] = static_cast<long long>(attr.sharedSizeBytes);
  return 0;
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
