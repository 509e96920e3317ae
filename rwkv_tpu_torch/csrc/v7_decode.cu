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
//
// Design: K6's and K7's persistent kernel (decode_stream.cuh; one block per
// SM, launched cooperatively, phases separated by the consumers' own grid
// barrier), five phases a layer:
//   A  ln1 and the six-way token-shift mix, the six mixes quantized as
//      whole vectors (every block redundantly), the rkv and lora1 rows
//   C  per head (one block each): the lora2 rows of the head's channels,
//      kk norm, k update, value residual, wkv7 state update, group norm,
//      bonus, gate (v7_stream.cuh's v7_stream_head, shared with K10:
//      v7_common.cuh's v7_head_step, in the same order)
//   D  out rows + residual      E  ln2 + shift, fk rows with relu^2
//   F  fv rows + residual
// then ln_out and the head rows (stream::head_phase).
//
// Every input that does not depend on the token -- the weight rows with
// their row scales, the vector rows a phase reads, att_in / ffn_in, a
// head's state with its vector slices and its lora2 rows -- reaches shared
// memory through a ring of stages fed by 1-D bulk asynchronous copies, in
// the order the block consumes them. A static plan (Layout7 / Plan7 /
// piece_copy; ops/megakernel.py::v7_stream_plan mirrors it) gives each
// block contiguous ranges of each phase's rows, in 4-row groups, so that
// every block takes a share of every phase, cut into pieces of as many
// whole rows as fit a stage, each followed by the 16-byte window of its row
// scales; phase A's nine vector rows and E's four go in pieces of as many
// rows as fit a stage. A producer warp (the block's ninth) issues each piece
// as soon as every consumer warp has released the piece before it in that
// stage, so the next phases' rows are in flight while the consumers wait at
// the grid barriers. Each row is computed with the lanes, the chunk order
// and the shuffle tree that matvec_rows (common.cuh) gives it, so the
// outputs do not depend on the grid. A and E fold their mixes' amax into
// the layer norm's last pass; C, D and F quantize their input vectors (the
// four lora downs, xo, the relu^2 keys) in one pass from an amax that the
// producing phase's epilogues published with atomicMax.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole (amax over all of it, codes rint(x * inv) clipped to +-127), the
// int32 sum is scaled as (float(acc) * dx) * d, and the elementwise formulas
// are evaluated with explicit round-to-nearest multiplies and adds so that
// no fused multiply-add shifts an activation across a code boundary. The
// bf16 form (template WF = kBf16, common.cuh) runs the same phases with
// every matrix and the head in bf16: the input vectors are staged in f32
// instead of quantized, and each row's f32 dot is the output as it is (no
// scales).
#include "v7_stream.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp that issues the block's stream
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

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
  float* scratch;           // scratch_floats(C, D, F, L); x ends at scratch[0..C)
  int C, H, S, D, F, L, V;
  int emb_f32;
};

// A layer's published amax slots: the four lora downs (tanh(w), a,
// sigmoid(g), v), xo and the relu^2 keys.
constexpr int kAmaxSlots = 6;
enum AmaxSlot { kAmDn = 0, kAmXo = 4, kAmFk = 5 };

// Floats of the kernel's global scratch: x, r, k, v, the four downs (4D),
// the layer-0 value, xo and the relu^2 keys (F) in 7C + 4D + F, then
// kAmaxSlots amax slots a layer (the kernel clears them); the Python
// wrapper allocates the same. The timing build's stamps follow.
__host__ __device__ inline size_t scratch_floats(int C, int D, int F, int L) {
  return 7ull * C + 4ull * D + F + static_cast<size_t>(kAmaxSlots) * L;
}

// Scale offsets of a layer's matrices (floats), in the pack's order.
struct ScaleOffsets {
  size_t rkv, l1, l2, out, fk, fv, layer;
  __host__ __device__ ScaleOffsets(int C, int D, int F) {
    rkv = 0;
    l1 = 3ull * C;
    l2 = l1 + 4ull * D;
    out = l2 + 4ull * C;
    fk = out + C;
    fv = fk + F;
    layer = fv + C;
  }
};

// ---- the stream plan (ops/megakernel.py::v7_stream_plan mirrors it) --------

using stream::Rows;
using stream::part;
using stream::round_up;
using stream::max2;

constexpr int kVecA = 9;         // phase A's vector rows: ln1 w, b, the six mixes, att_in
constexpr int kVecE = 4;         // phase E's: ln2 w, b, xk, ffn_in
constexpr int kMaxVecRows = 9;   // vector rows a piece at most (a copy each)
constexpr int kHeadVecs = 8;     // a head's vector slices: w0, a0, v0, kk, ka, ln_x w, b, r_k
constexpr int kHvFloats = 10;    // per-head vectors in shared memory, S floats each

// Shared memory of a launch: xs, xl (C floats each), hv (10 S), red (256),
// dxs (8), the block-local amax slots, the activations (int8 codes, or f32
// in the bf16 form; max(6C, F, 4D) of them), then the block's plan, its
// mbarriers and the ring (stream::Ring), each stage at least the largest
// piece.
__host__ __device__ inline size_t act_off7(int C, int S) {
  return round_up(4 * (2ull * C + static_cast<size_t>(kHvFloats) * S + 256 + 8 + kAmaxSlots), 16);
}

__host__ __device__ inline size_t plan_off7(int C, int S, int D, int F, int wf) {
  size_t acts = 6ull * C;
  acts = max2(acts, static_cast<size_t>(F));
  acts = max2(acts, 4ull * D);
  return round_up(act_off7(C, S) + (wf == kBf16 ? 4 : 1) * acts, 16);
}

// Bytes of one run of a head's lora2 rows (S rows of width D) with, in the
// int forms, their S row scales.
__host__ __device__ inline size_t lora2_run(int S, int D, int wf) {
  return static_cast<size_t>(S) * form_bytes(small_form(wf), D) + (wf == kBf16 ? 0 : 4ull * S);
}

// the largest piece: two vector rows, a head's state with its vector
// slices, one run of its lora2 rows, one row of any matrix with its scale
// window
__host__ __device__ inline size_t piece7(int C, int S, int D, int F, int wf) {
  const int sf = small_form(wf);
  size_t piece = max2(8ull * C, 4ull * S * S + 4ull * kHeadVecs * S);
  piece = max2(piece, lora2_run(S, D, wf));
  size_t row = max2(form_bytes(wf, C), form_bytes(wf, F));
  row = max2(row, form_bytes(sf, C));
  return max2(piece, row + stream::win_bytes(1));
}

struct Layout7 : stream::Ring {
  size_t act_off;
  int vec_rows;  // vector rows a piece
  int l2_runs;   // runs of a head's lora2 rows a piece (of the four)
  __host__ __device__ Layout7(int C, int S, int D, int F, int wf)
      : stream::Ring(plan_off7(C, S, D, F, wf), piece7(C, S, D, F, wf)), act_off(act_off7(C, S)) {
    const size_t n = stage / (4ull * C);
    vec_rows = n < kMaxVecRows ? static_cast<int>(n) : kMaxVecRows;
    const size_t r = stage / lora2_run(S, D, wf);
    l2_runs = r < 4 ? static_cast<int>(r) : 4;
  }
};

// The pieces of a layer in stream order (then those of the head). A piece
// fills one stage; a segment is a run of pieces.
enum Seg7 {
  sVecA,    // ln1 w, b, the six mixes, att_in: vec_rows rows a piece
  sRkv,     // the fused r, k, v rows
  sL1,      // the lora1 rows (w, a, g, v downs)
  sHeads,   // per head of the block: its state with its vector slices, then
            // its lora2 rows, l2_runs runs of S rows (with their scales) a piece
  sOut,
  sVecE,    // ln2 w, b, xk, ffn_in: vec_rows rows a piece
  sFk, sFv,
  kLayerSegs,
  sLnOut = kLayerSegs,  // ln_out w | b
  sHead,
  kAllSegs
};

// Pieces of a run of n rows (or runs), per a piece.
__host__ __device__ inline int run_pieces(int n, int per) { return (n + per - 1) / per; }

// Block b's share of every phase.
struct Plan7 {
  Rows rkv, l1, out, fk, fv, head;
  int heads, vec_rows, l2_runs;
  int tail0, tail1;  // the head's rows past its last whole 4-row group (the last block)
  __host__ __device__ Plan7(const Layout7& lo, int C, int D, int F, int H, int V, int wf,
                            int blocks, int b) {
    const int sf = small_form(wf);
    const bool w = wf != kBf16;
    const int bc = static_cast<int>(form_bytes(wf, C)), sc = static_cast<int>(form_bytes(sf, C));
    // the lanes the earlier grid-wide matvec gave each matrix's rows: 32 at most, 8 for the head
    rkv = part(3 * C, blocks, b, false, bc, w, lo.stage, 32);
    l1 = part(4 * D, blocks, b, true, sc, w, lo.stage, 32);
    out = part(C, blocks, b, false, bc, w, lo.stage, 32);
    fk = part(F, blocks, b, false, bc, w, lo.stage, 32);
    fv = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, F)), w, lo.stage, 32);
    head = part(V, blocks, b, false, sc, w, lo.stage, 8);
    heads = b < H ? (H - b + blocks - 1) / blocks : 0;
    vec_rows = lo.vec_rows;
    l2_runs = lo.l2_runs;
    tail0 = V & ~3;
    tail1 = b == blocks - 1 ? V : tail0;
  }
  __host__ __device__ const Rows* rows(int seg) const {
    switch (seg) {
      case sRkv: return &rkv;
      case sL1: return &l1;
      case sOut: return &out;
      case sFk: return &fk;
      case sFv: return &fv;
      case sHead: return &head;
      default: return nullptr;
    }
  }
  __host__ __device__ int count(int seg) const {
    const Rows* r = rows(seg);
    if (r != nullptr) return r->pieces();
    if (seg == sVecA) return run_pieces(kVecA, vec_rows);
    if (seg == sVecE) return run_pieces(kVecE, vec_rows);
    return seg == sHeads ? heads * (1 + run_pieces(4, l2_runs)) : 1;
  }
  __host__ __device__ int layer_pieces() const {
    int n = 0;
    for (int s = 0; s < kLayerSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(Plan7) <= stream::kPlanBytes, "the plan's shared bytes");

// Copy i of piece idx of segment seg of layer l for block b of a grid of
// `blocks` (plan pl): a 16-byte multiple from a 16-byte aligned src into
// the stage at offset dst. Returns false past the piece's last copy.
__host__ __device__ inline bool piece_copy(const Args& p, const MatOffsets& mo,
                                           const ScaleOffsets& so, const Plan7& pl, int wf,
                                           int b, int blocks, int l, int seg, int idx, int i,
                                           const void** src, uint32_t* dst, uint32_t* bytes) {
  const int C = p.C, S = p.S;
  const bool w = wf != kBf16;
  const unsigned char* mats = reinterpret_cast<const unsigned char*>(p.mats) + l * mo.layer;
  const float* scales = w ? p.scales + l * so.layer : nullptr;
  const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec * C;
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
      return vec_run(kVecA, [&](int j) -> const float* {
        if (j < 2) return vec + (kLn1W + j) * C;
        if (j < 8) return vec + (kCoeff + j - 2) * C;
        return p.att_in + static_cast<size_t>(l) * C;
      });
    case sRkv: return rows(pl.rkv, mats + mo.rkv, w ? scales + so.rkv : nullptr);
    case sL1: return rows(pl.l1, mats + mo.l1, w ? scales + so.l1 : nullptr);
    case sHeads: {
      const int per = 1 + run_pieces(4, pl.l2_runs);  // pieces a head
      const int h = b + (idx / per) * blocks, k = idx % per;
      if (k == 0) {
        // the state [S, S], then the head's slices of the vector rows
        if (i == 0)
          return put(p.heads_in + (static_cast<size_t>(l) * p.H + h) * S * S, 0u, 4u * S * S);
        const int vrows[kHeadVecs] = {kW0, kA0, kV0, kKK, kKA, kLnxW, kLnxB, kRK};
        return i <= kHeadVecs &&
               put(vec + vrows[i - 1] * C + h * S, 4u * S * S + 4u * S * (i - 1), 4u * S);
      }
      // runs q0 .. q1 - 1 of the lora2 rows (run q: rows q C + h S + [0, S),
      // width D), then their row scales
      const int q0 = (k - 1) * pl.l2_runs;
      const int q1 = q0 + pl.l2_runs < 4 ? q0 + pl.l2_runs : 4;
      const uint32_t rb = static_cast<uint32_t>(form_bytes(small_form(wf), p.D));
      const int q = q0 + i;
      if (q < q1)
        return put(mats + mo.l2 + (static_cast<size_t>(q) * C + h * S) * rb, S * rb * i, S * rb);
      const int j = q - q1;
      return w && j < q1 - q0 &&
             put(scales + so.l2 + static_cast<size_t>(q0 + j) * C + h * S,
                 S * rb * (q1 - q0) + 4u * S * j, 4u * S);
    }
    case sOut: return rows(pl.out, mats + mo.out, w ? scales + so.out : nullptr);
    case sVecE:
      return vec_run(kVecE, [&](int j) -> const float* {
        if (j < 2) return vec + (kLn2W + j) * C;
        if (j == 2) return vec + kXK * C;
        return p.ffn_in + static_cast<size_t>(l) * C;
      });
    case sFk: return rows(pl.fk, mats + mo.fk, w ? scales + so.fk : nullptr);
    case sFv: return rows(pl.fv, mats + mo.fv, w ? scales + so.fv : nullptr);
    case sLnOut: return i == 0 && put(p.ln_out, 0u, 8u * C);
    case sHead: return rows(pl.head, p.head, w ? p.head_d : nullptr);
    default: return false;
  }
}

// The grid barrier's word (stream::grid_sync).
__device__ unsigned g_grid_count = 0;
// Layer 0's amax slots of the four downs: phase A publishes them before the
// launch's first grid barrier, so they cannot be in the scratch (which the
// kernel clears before that barrier); block 0 clears them again once phase
// C of layer 0 has read them, for the next launch.
__device__ unsigned g_dn0_amax[4] = {0u, 0u, 0u, 0u};

template <int WF>
__global__ void __launch_bounds__(kBlockThreads, 1)
v7_decode_kernel(Args p) {
  constexpr int LF = small_form(WF);  // the LoRAs' and the head's form
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, H = p.H, S = p.S, D = p.D, F = p.F;
  const int tid = threadIdx.x;
  const Layout7 lo(C, S, D, F, WF);
  const MatOffsets mo(C, D, F, WF);
  const ScaleOffsets so(C, D, F);

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);    // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized
  float* hv = xl + C;                            // [10 S] per-head vectors
  float* red = hv + kHvFloats * S;               // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAmaxSlots] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(6C, F, 4D)]
  Plan7* plan = reinterpret_cast<Plan7*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);  // one a stage
  uint64_t* empty = full + stream::kMaxStages;                      // one a stage
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);

  if (tid == 0) {
    *plan = Plan7(lo, C, D, F, H, p.V, WF, gridDim.x, blockIdx.x);
    for (int s = 0; s < stages; ++s) {
      stream::mbar_init(&full[s], 1);
      stream::mbar_init(&empty[s], stream::kConsumerWarps);
    }
    stream::fence_mbar_init();
  }
  if (tid < kAmaxSlots) amx[tid] = 0u;
  __syncthreads();  // the last barrier of all 288 threads
  const Plan7& pl = *plan;
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

  float* x_g = p.scratch;          // residual stream
  float* r_g = x_g + C;
  float* k_g = r_g + C;
  float* v_g = k_g + C;
  float* dn_g = v_g + C;           // 4 x D: tanh(w), a, sigmoid(g), v downs
  float* vf_g = dn_g + 4 * D;      // layer-0 value
  float* xo_g = vf_g + C;          // attention output before `out`
  float* fk_g = xo_g + C;          // [F] relu^2 keys
  unsigned* amax_g = reinterpret_cast<unsigned*>(p.scratch + scratch_floats(C, D, F, 0));

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, D, F, p.L));
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
  // the n rows of a run of vector rows, vec_rows a piece, into vrow[];
  // returns the pieces waited
  const float* vrow[kVecA];
  auto wait_run = [&](int n) {
    const float* base = nullptr;
    int k = 0, held = 0;  // the row of the current piece; pieces waited
#pragma unroll
    for (int j = 0; j < kVecA; ++j) {
      if (j < n) {
        if (k == 0) {
          base = reinterpret_cast<const float*>(cs.wait());
          ++held;
        }
        vrow[j] = base + k * C;
        if (++k == pl.vec_rows) k = 0;
      }
    }
    return held;
  };
  // the part of row `row` of a fused matrix of 3 (rkv) or 4 (lora1) parts
  // of n rows each (comparisons: a division by a runtime n costs ~20
  // instructions)
  auto part3 = [](int row, int n) { return (row >= n) + (row >= 2 * n); };
  auto part4 = [](int row, int n) { return (row >= n) + (row >= 2 * n) + (row >= 3 * n); };

  for (int l = 0; l < p.L; ++l) {
    unsigned* amax_l = amax_g + kAmaxSlots * l;
    unsigned* dn_amax = l == 0 ? g_dn0_amax : amax_l + kAmDn;

    // ---- phase A: ln1, shift mixes, rkv + lora1 rows --------------------
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
      // ln1 w, b, the mixes r, w, k, v, a, g, att_in:
      // xl + (x_prev - xl) * coeff[m]
      const int held = wait_run(kVecA);
      const float* att_in = vrow[kVecA - 1];
      stream::layer_norm_act<WF, 6>(
          xs, xl, vrow[0], vrow[1], C, 1e-5f, red, [](int, float) {},
          [&](int m, int c) { return add(xl[c], mul(sub(att_in[c], xl[c]), vrow[2 + m][c])); },
          q8, C, dxs);
      cs.release(held);
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    // rkv rows take mixes r(0), k(2), v(3); lora1 rows w(1), a(4), g(5), v(3)
    cs.rows<WF>(pl.rkv, C, [&](int row) { return q8 + rkv_mix(part3(row, C)) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = part3(row, C);
                  const float y = dequant(acc, dxs[rkv_mix(part)], d);
                  (part == 0 ? r_g : part == 1 ? k_g : v_g)[row - part * C] = y;
                });
    cs.rows<LF>(pl.l1, C, [&](int row) { return q8 + lora1_mix(part4(row, D)) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = part4(row, D);
                  float y = dequant(acc, dxs[lora1_mix(part)], d);
                  if (part == 0) y = tanhf(y);
                  if (part == 2) y = sigmoidf(y);
                  dn_g[row] = y;
                  if constexpr (kQuant) stream::note_amax(&amx[kAmDn + part], y);
                });
    if constexpr (kQuant) stream::publish_amax<4>(amx + kAmDn, dn_amax);
    barrier();

    // ---- phase C: per head: lora2 rows, wkv7 step, group norm, gate -----
    {
      // a head's r, k, v and (l > 0) layer-0 value, loaded ahead of their use
      float hr = 0.f, hk = 0.f, hvv = 0.f, hvf = 0.f;
      auto fetch_head = [&](int h) {
        if (tid < S) {
          const int c = h * S + tid;
          hr = __ldcg(r_g + c);
          hk = __ldcg(k_g + c);
          hvv = __ldcg(v_g + c);
          if (l > 0) hvf = __ldcg(vf_g + c);
        }
      };
      if (pl.heads > 0) {
        fetch_head(blockIdx.x);
        stream::act_published<LF, 4>(dn_g, D, q8, dxs, dn_amax);
      }
      for (int j = 0; j < pl.heads; ++j) {  // block-uniform
        const int h = blockIdx.x + j * gridDim.x;
        stream::v7_stream_head<LF>(
            cs, pl.l2_runs, S, D, hr, hk, hvv, hvf, l == 0, false,
            [&](int i) {
              return p.heads_out +
                     (static_cast<size_t>(l) * H * S + static_cast<size_t>(h) * S + i) * S;
            },
            [&](float v) { vf_g[h * S + tid] = v; },
            [&](float v) {
              xo_g[h * S + tid] = v;
              if constexpr (kQuant) stream::note_amax(&amx[kAmXo], v);
            },
            hv, red, dxs, q8, [&]() {
              if (j + 1 < pl.heads) fetch_head(h + gridDim.x);
            });
      }
    }
    publish(amax_l);
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    if (l == 0 && blockIdx.x == 0 && tid < 4) g_dn0_amax[tid] = 0u;  // read by C, behind us
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

    // ---- phase E: ln2 + shift, fk rows with relu^2 -------------------------
    stream::load_vec(xs, x_g, C);
    stream::csync();
    {
      const int held = wait_run(kVecE);  // ln2 w, b, xk, ffn_in
      const float* xk = vrow[2];
      const float* fin = vrow[3];
      stream::layer_norm_act<WF, 1>(
          xs, xl, vrow[0], vrow[1], C, 1e-5f, red, [](int, float) {},
          [&](int, int c) { return add(xl[c], mul(sub(fin[c], xl[c]), xk[c])); }, q8, 0, dxs);
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
    publish(amax_l);
    barrier();

    // ---- phase F: fv rows + residual --------------------------------------
    {
      // the residual at this block's fv rows, loaded beside the codes (into
      // xs, free until the next layer)
      const int r0 = pl.fv.r0, nr = pl.fv.r1 - r0;
      const float x0 = tid < nr ? __ldcg(x_g + r0 + tid) : 0.f;
      stream::act_published<WF, 1>(fk_g, F, q8, dxs, amax_l + kAmFk);
      for (int i = tid; i < nr; i += kThreads) xs[i] = i == tid ? x0 : __ldcg(x_g + r0 + i);
      stream::csync();
      cs.rows<WF>(pl.fv, F, [&](int) { return q8; },
                  [&](int row, auto acc, const float* d) {
                    x_g[row] = add(xs[row - r0], dequant(acc, dxs[0], d));
                  });
    }
    barrier();
  }

  // ---- head: ln_out, quantize, the V head rows ------------------------------
  stream::head_phase<LF>(cs, pl.head, x_g, C, xs, xl, red, dxs, q8, p.logits);
  if (pl.tail1 > pl.tail0) {
    // the last block: the rows past the last whole 4-row group, read from
    // global memory with the lanes and order of the streamed ones
    const size_t rb = form_bytes(LF, C);
    const unsigned char* base = reinterpret_cast<const unsigned char*>(p.head) + pl.tail0 * rb;
    stream::smem_rows<LF>(base, pl.tail1 - pl.tail0, C, 8, 0, [&](int) { return q8; },
                          [&](int j, auto acc) {
                            const int row = pl.tail0 + j;
                            p.logits[row] = dequant(acc, dxs[0], kQuant ? p.head_d + row : nullptr);
                          });
  }
  PHASE_MARK();
}

const void* kernel_for(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(v7_decode_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(v7_decode_kernel<kInt4>)
                     : reinterpret_cast<const void*>(v7_decode_kernel<kInt8>);
}

// Why K3 cannot run these shapes (a CUDA error code), or 0. The Python
// side's decode_shape_error holds the rules on widths (v7_stream_plan the
// plan's); this refuses what the kernel's layout cannot take.
int shape_error(int wf, int C, int H, int S, int D, int F, int V) {
  const Layout7 lo(C, S, D, F, wf);
  if (S <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ || S % 4 != 0 || H * S != C ||
      C % 16 != 0 || D % 16 != 0 || F % 16 != 0 || V <= 0 ||
      static_cast<int>(lo.stages) < stream::kMinStages ||
      run_pieces(kVecA, lo.vec_rows) > static_cast<int>(lo.stages) || lo.l2_runs < 1 ||
      1 + run_pieces(4, lo.l2_runs) > static_cast<int>(lo.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Grid size a launch of form wf uses (one block per SM), or a negative
// CUDA error code.
int grid_blocks_for(int wf, int C, int S, int D, int F) {
  const void* k = kernel_for(wf);
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = Layout7(C, S, D, F, wf).smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem(k, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kBlockThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (per_sm > 1 ? 1 : per_sm) * sms;
}

int launch(int wf, const void* token, const void* emb, const void* ln0, const void* mats,
           const void* scales, const void* vecs, const void* head, const void* head_d,
           const void* ln_out, const void* att_in, const void* ffn_in, const void* heads_in,
           void* att_out, void* ffn_out, void* heads_out, void* logits, void* scratch, int C,
           int H, int S, int D, int F, int L, int V, int emb_f32, int grid_blocks,
           void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = shape_error(wf, C, H, S, D, F, V);
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
  a.C = C; a.H = H; a.S = S; a.D = D; a.F = F; a.L = L; a.V = V;
  a.emb_f32 = emb_f32;
  void* kargs[] = {&a};
  const size_t smem = Layout7(C, S, D, F, wf).smem;
  const void* kernel = kernel_for(wf);
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks), dim3(kBlockThreads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch. The bf16 entry takes one
// int more, emb_f32 (the embedding table is f32, not bf16); it reads no
// scales or head_d (pass null).
extern "C" int rwkv_v7_decode_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kInt8, C, S, D, F);
}

extern "C" int rwkv_v7_decode_w4_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kInt4, C, S, D, F);
}

extern "C" int rwkv_v7_decode_bf16_grid(int C, int S, int D, int F) {
  return grid_blocks_for(kBf16, C, S, D, F);
}

// The stream plan of form wf (0 int8, 1 int4, 2 bf16) as the kernel
// computes it, for the card tests to hold ops/megakernel.py::v7_stream_plan
// to: out[0] the launch's dynamic shared bytes, out[1] a stage's bytes,
// out[2] the stages, out[3] block `block`'s pieces a layer of a grid of
// `blocks`, out[4] its pieces of the head, out[5] the form's kernel's
// static shared bytes, out[6] vector rows a piece, out[7] lora2 runs a
// piece. Returns a CUDA error code (0: none).
extern "C" int rwkv_v7_decode_plan(int wf, int C, int S, int D, int F, int H, int V, int blocks,
                                   int block, long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout7 lo(C, S, D, F, wf);
  const Plan7 pl(lo, C, D, F, H, V, wf, blocks, block);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(wf));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<long long>(lo.smem);
  out[1] = static_cast<long long>(lo.stage);
  out[2] = static_cast<long long>(lo.stages);
  out[3] = pl.layer_pieces();
  out[4] = pl.count(sLnOut) + pl.count(sHead);
  out[5] = static_cast<long long>(attr.sharedSizeBytes);
  out[6] = lo.vec_rows;
  out[7] = lo.l2_runs;
  return 0;
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
  return launch(kInt8, RWKV_V7_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v7_decode_w4(RWKV_V7_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kInt4, RWKV_V7_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v7_decode_bf16(RWKV_V7_DECODE_PARAMS, int emb_f32, int grid_blocks,
                                   void* stream) {
  return launch(kBf16, RWKV_V7_DECODE_ARGS, emb_f32, grid_blocks, stream);
}
