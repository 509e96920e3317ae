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
// Design: K7's persistent kernel (one block per SM, launched cooperatively,
// phases separated by grid-wide barriers) with four phases a layer. v4 has
// no heads: its wkv is elementwise over C, so it needs no phase of its own.
//   A  ln1 and the token shift, the three mixes (k, v, r) in the
//      reference's op order, each quantized as a whole vector (every block
//      redundantly), the fused r, k, v rows (sigmoid on r)
//   B  every block computes the whole C-wide sigmoid(r) * wkv vector
//      redundantly (its quantization needs the amax of all of it) with the
//      max-trick (wkv4_out, v45_common.cuh), and the new aa, bb, pp of its
//      share of the channels (wkv4_state); then the out rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//      (where a block's fr rows are one piece, in one round with its last
//      fk piece: rows_pair)
//   F  fv rows: x += sigmoid(fr) * fv
// then ln_out and the head rows (stream::head_phase).
//
// As K3, K6 and K7 (decode_stream.cuh), every input that does not depend
// on the token -- the weight rows with their row scales, the vector rows a
// phase reads, att_in / ffn_in and phase B's state rows -- reaches shared
// memory through a ring of stages fed by 1-D bulk asynchronous copies, in
// the order the block consumes them. A static plan (Layout4 / Plan4 /
// piece_copy; ops/megakernel.py::v4_stream_plan mirrors it) gives each
// block contiguous ranges of each phase's rows, in 4-row groups, cut into
// pieces of as many whole rows as fit a stage, each followed by the
// 16-byte window of its row scales; a phase's vector rows go in pieces of
// as many rows as fit a stage (kMaxVecRows at most): A's ln1 w, b, the
// three mixes and att_in, B's td slice of the block's channels, tf and the
// old aa, bb, pp, E's ln2 w, b, the two FFN mixes and ffn_in. A producer
// warp (the block's ninth) issues each piece as soon as every consumer
// warp has released the piece before it in that stage, so the next phases'
// inputs are in flight while the consumers wait at the grid barriers; the
// eight consumer warps synchronize on a named barrier and cross the grid
// on a barrier of their own. Each row is computed with the lanes, the
// chunk order and the shuffle tree that matvec_rows gives it, so the
// outputs do not depend on the grid. A and E fold their mixes' amax into
// the layer norm's last pass, B takes its vector's amax in the pass that
// computes it, and F quantizes the relu^2 keys in one pass from an amax
// that E's epilogues published with atomicMax.
//
// Numerics follow the JAX kernel: whole-vector quantization, (float(acc) *
// dx) * d, explicit round-to-nearest multiplies and adds, expf and a true
// division in the max-trick. The blank state's pp = -1e30 gives
// exp(pp - qq) = 0, never NaN. The bf16 form (WF = kBf16, common.cuh)
// stages each input vector in f32 and reads no scales.
#include "decode_stream.cuh"
#include "v45_common.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp that issues the block's stream
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

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
  float* scratch;           // scratch_floats(C, F, L); x ends at scratch[0..C)
  int C, F, L, V;
  int emb_f32;
};

// A layer's published amax slot in the scratch: the relu^2 keys.
constexpr int kAmaxSlots = 1;

// Floats of the kernel's global scratch: x, sigmoid(r)|k|v (3C),
// sigmoid(fr) and the relu^2 keys (F), then kAmaxSlots amax slots a layer
// (the kernel clears them), padded to an even count so that the timing
// build's 8-byte stamps behind it stay aligned; the Python wrapper
// allocates the same.
__host__ __device__ inline size_t scratch_floats(int C, int F, int L) {
  const size_t slots = static_cast<size_t>(kAmaxSlots) * L;
  return 5ull * C + F + slots + (slots & 1);
}

// ---- the stream plan (ops/megakernel.py::v4_stream_plan mirrors it) --------

using stream::Rows;
using stream::part;
using stream::round_up;
using stream::max2;

constexpr int kMaxVecRows = 8;  // vector rows a piece at most (a copy each)
constexpr int kVecA = 6;        // phase A's vector rows: ln1 w, b, the three mixes, att_in
constexpr int kVecB = 5;        // phase B's: the td slice, tf, aa_in, bb_in, pp_in
constexpr int kVecE = 5;        // phase E's: ln2 w, b, the FFN mixes k, r, ffn_in

// Shared memory of a launch: xs, xl (C floats each), red (256), dxs (8),
// the block-local amax slots, the activations (int8 codes, or f32 in the
// bf16 form; max(3C, F) of them), then the block's plan, its mbarriers and
// the ring (stream::Ring), each stage at least the largest piece.
__host__ __device__ inline size_t act_off4(int C) {
  return round_up(4 * (2ull * C + 256 + 8 + kAmaxSlots), 16);
}

__host__ __device__ inline size_t plan_off4(int C, int F, int wf) {
  const size_t acts = static_cast<size_t>(3 * C > F ? 3 * C : F);
  return round_up(act_off4(C) + (wf == kBf16 ? 4 : 1) * acts, 16);
}

// the largest piece: two vector rows, one row of any matrix with its scale
// window
__host__ __device__ inline size_t piece4(int C, int F, int wf) {
  size_t row = max2(form_bytes(wf, C), form_bytes(wf, F));
  row = max2(row, form_bytes(small_form(wf), C));
  return max2(8ull * C, row + stream::win_bytes(1));
}

struct Layout4 : stream::Ring {
  size_t act_off;
  int vec_rows;  // vector rows a piece
  __host__ __device__ Layout4(int C, int F, int wf)
      : stream::Ring(plan_off4(C, F, wf), piece4(C, F, wf)), act_off(act_off4(C)) {
    const size_t n = stage / (4ull * C);
    vec_rows = n < kMaxVecRows ? static_cast<int>(n) : kMaxVecRows;
  }
};

// The pieces of a layer in stream order (then those of the head). A piece
// fills one stage; a segment is a run of pieces.
enum Seg4 {
  sVecA,    // ln1 w, b, the mixes k, v, r, att_in: vec_rows rows a piece
  sAtt,     // the fused r, k, v rows
  sVecB,    // td at the block's channels, tf, aa_in, bb_in, pp_in: vec_rows a piece
  sOut,
  sVecE,    // ln2 w, b, the FFN mixes k, r, ffn_in: vec_rows rows a piece
  sFk, sFr, sFv,
  kLayerSegs,
  sLnOut = kLayerSegs,  // ln_out w | b
  sHead,
  kAllSegs
};

// Pieces of a run of n vector rows, vr a piece.
__host__ __device__ inline int vec_pieces(int n, int vr) { return (n + vr - 1) / vr; }

// Block b's share of every phase.
struct Plan4 {
  Rows att, out, fk, fr, fv, head;
  int s0, s1;        // the channels whose aa, bb, pp the block writes (phase B)
  int vec_rows;
  int tail0, tail1;  // the head's rows past its last whole 4-row group (the last block)
  __host__ __device__ Plan4(const Layout4& lo, int C, int F, int V, int wf, int blocks, int b) {
    const int sf = small_form(wf);
    const bool w = wf != kBf16;
    const int bc = static_cast<int>(form_bytes(wf, C)), sc = static_cast<int>(form_bytes(sf, C));
    // the lanes the earlier grid-wide matvec gave each matrix's rows:
    // lanes_for(K), 8 for the head
    const int big = lanes_for(C, wf);
    att = part(3 * C, blocks, b, false, bc, w, lo.stage, big);
    out = part(C, blocks, b, false, bc, w, lo.stage, big);
    fk = part(F, blocks, b, false, bc, w, lo.stage, big);
    fr = part(C, blocks, b, true, bc, w, lo.stage, big);
    fv = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, F)), w, lo.stage,
              lanes_for(F, wf));
    head = part(V, blocks, b, false, sc, w, lo.stage, 8);
    const Rows st = part(C, blocks, b, false, 4, false, lo.stage, 1);
    s0 = st.r0;
    s1 = st.r1;
    vec_rows = lo.vec_rows;
    tail0 = V & ~3;
    tail1 = b == blocks - 1 ? V : tail0;
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
    if (seg == sVecA) return vec_pieces(kVecA, vec_rows);
    if (seg == sVecB) return vec_pieces(kVecB, vec_rows);
    if (seg == sVecE) return vec_pieces(kVecE, vec_rows);
    return 1;
  }
  __host__ __device__ int layer_pieces() const {
    int n = 0;
    for (int s = 0; s < kLayerSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(Plan4) <= stream::kPlanBytes, "the plan's shared bytes");

// Copy i of piece idx of segment seg of layer l for block b (plan pl): a
// 16-byte multiple from a 16-byte aligned src into the stage at offset
// dst. Returns false where the piece has no copy i.
__host__ __device__ inline bool piece_copy(const Args& p, const MatOffsets45& mo,
                                           const ScaleOffsets45& so, const Plan4& pl, int wf,
                                           int l, int seg, int idx, int i, const void** src,
                                           uint32_t* dst, uint32_t* bytes) {
  const int C = p.C;
  const bool w = wf != kBf16;
  const unsigned char* mats = reinterpret_cast<const unsigned char*>(p.mats) + l * mo.layer;
  const float* scales = w ? p.scales + l * so.layer : nullptr;
  const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec4 * C;
  const size_t lc = static_cast<size_t>(l) * C;
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
  // row j of a run of n vector rows (vec_row(j) its address and bytes),
  // vec_rows a piece, one copy a row, row slot i of the piece
  auto vec_run = [&](int n, auto vec_row) {
    const int j = idx * pl.vec_rows + i;
    if (i >= pl.vec_rows || j >= n) return false;
    uint32_t nb = 4u * C;
    const void* s_ = vec_row(j, &nb);
    return nb > 0 && put(s_, 4u * C * i, nb);
  };
  switch (seg) {
    case sVecA:
      return vec_run(kVecA, [&](int j, uint32_t*) -> const float* {
        if (j < 2) return vec + (kLn1W + j) * C;
        if (j < 5) return vec + (kAmix + j - 2) * C;
        return p.att_in + lc;
      });
    case sAtt: return rows(pl.att, mats + mo.att, w ? scales + so.att : nullptr);
    case sVecB:
      return vec_run(kVecB, [&](int j, uint32_t* nb) -> const float* {
        switch (j) {
          case 0: *nb = 4u * (pl.s1 - pl.s0); return vec + kTD * C + pl.s0;
          case 1: return vec + kTF * C;
          case 2: return p.aa_in + lc;
          case 3: return p.bb_in + lc;
          default: return p.pp_in + lc;
        }
      });
    case sOut: return rows(pl.out, mats + mo.out, w ? scales + so.out : nullptr);
    case sVecE:
      return vec_run(kVecE, [&](int j, uint32_t*) -> const float* {
        if (j < 4) return vec + (kLn2W + j) * C;  // ln2 w, b, fmix k, r
        return p.ffn_in + lc;
      });
    case sFk: return rows(pl.fk, mats + mo.fk, w ? scales + so.fk : nullptr);
    case sFr: return rows(pl.fr, mats + mo.fr, w ? scales + so.fr : nullptr);
    case sFv: return rows(pl.fv, mats + mo.fv, w ? scales + so.fv : nullptr);
    case sLnOut: return i == 0 && put(p.ln_out, 0u, 8u * C);
    case sHead: return rows(pl.head, p.head, w ? p.head_d : nullptr);
    default: return false;
  }
}

// Phase E's two matrices of width K in form WF, a's rows (fk) then b's
// (fr), as Stream::rows takes them one after the other, but where b's
// share is one piece, a's last piece and b's piece in one round of the
// block's lane groups: row j < na of a's piece, else row j - na of b's.
// Each row is summed as smem_rows sums it (row_dot: the same lanes, chunk
// order and shuffle tree), so the values do not change; xa / xb are the
// rows' activations, epi_a / epi_b their epilogues (row, acc, scale).
template <int WF, typename EpiA, typename EpiB>
__device__ void rows_pair(stream::Stream& cs, const Rows& a, const Rows& b, int K,
                          const act_t<WF>* xa, const act_t<WF>* xb, EpiA epi_a, EpiB epi_b) {
  const int na_pieces = a.pieces();
  if (b.pieces() != 1 || na_pieces == 0 || a.rb != b.rb || a.lpr != b.lpr) {
    cs.rows<WF>(a, K, [&](int) { return xa; }, epi_a);
    cs.rows<WF>(b, K, [&](int) { return xb; }, epi_b);
    return;
  }
  Rows first = a;  // a's pieces before its last
  first.r1 = a.c0(na_pieces - 1);
  cs.rows<WF>(first, K, [&](int) { return xa; }, epi_a);
  const int a0 = first.r1, na = a.r1 - a0, nb = b.r1 - b.r0, n = na + nb;
  const unsigned char* sa = cs.wait();
  const unsigned char* sb = cs.wait();
  const float* wa = reinterpret_cast<const float*>(sa + static_cast<size_t>(na) * a.rb);
  const float* wb = reinterpret_cast<const float*>(sb + static_cast<size_t>(nb) * b.rb);
  const int lpr = a.lpr, lg = __ffs(lpr) - 1;  // a power of two
  const int per_lane = (a.rb >> 4) >> lg;
  const int lane = threadIdx.x & 31, sub_lane = lane & (lpr - 1), gpw = 32 >> lg;
  const int groups = stream::kConsumerWarps * gpw;
  const int t = (threadIdx.x >> 5) * gpw + (lane >> lg);  // this lane group
  for (int base = 0; base < n; base += groups) {  // warp-uniform
    const int j = base + t;
    typename FormTraits<WF>::Acc acc = 0;
    if (j < n) {
      const unsigned char* row = j < na ? sa + static_cast<size_t>(j) * a.rb
                                        : sb + static_cast<size_t>(j - na) * b.rb;
      acc = stream::row_dot<WF>(reinterpret_cast<const int4*>(row), j < na ? xa : xb, per_lane,
                                lpr, sub_lane);
    }
    for (int off = lpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub_lane == 0 && j < n) {
      if constexpr (WF == kInt4) acc >>= 4;
      if (j < na) {
        epi_a(a0 + j, acc, wa + (a0 + j - (a0 & ~3)));
      } else {
        epi_b(b.r0 + j - na, acc, wb + (j - na));
      }
    }
  }
  cs.release(2);
}

// The grid barrier's word (stream::grid_sync).
__device__ unsigned g_grid_count = 0;

template <int WF>
__global__ void __launch_bounds__(kBlockThreads, 1)
v4_decode_kernel(Args p) {
  constexpr int LF = small_form(WF);  // the head's form
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, F = p.F;
  const int tid = threadIdx.x;
  const Layout4 lo(C, F, WF);

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);    // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized; phase B: r * wkv
  float* red = xl + C;                           // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAmaxSlots] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(3C, F)] activations
  Plan4* plan = reinterpret_cast<Plan4*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);  // one a stage
  uint64_t* empty = full + stream::kMaxStages;                      // one a stage
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);

  if (tid == 0) {
    *plan = Plan4(lo, C, F, p.V, WF, gridDim.x, blockIdx.x);
    for (int s = 0; s < stages; ++s) {
      stream::mbar_init(&full[s], 1);
      stream::mbar_init(&empty[s], stream::kConsumerWarps);
    }
    stream::fence_mbar_init();
  }
  if (tid < kAmaxSlots) amx[tid] = 0u;
  __syncthreads();  // the last barrier of all 288 threads
  const Plan4& pl = *plan;
  if (tid >= kThreads) {
    // the producer warp (the pack's offsets computed here: the consumers
    // need none of them)
    const MatOffsets45 mo(C, F, 3, WF);
    const ScaleOffsets45 so(C, F, 3);
    stream::produce<kLayerSegs, kAllSegs>(
        pl, p.L, stages, ring, lo.stage, full, empty,
        [&](int l, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return piece_copy(p, mo, so, pl, WF, l, seg, idx, i, src, dst, bytes);
        });
    return;
  }

  float* x_g = p.scratch;           // residual stream
  float* att_g = x_g + C;           // [3][C] sigmoid(r), k, v
  float* rg_g = att_g + 3 * C;      // sigmoid(fr rows)
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
  // the n rows of a run of vector rows, vec_rows a piece, into vrow[];
  // returns the pieces waited
  const float* vrow[kVecA];
  auto wait_run = [&](int n) {
    const float* base = nullptr;
#pragma unroll
    for (int j = 0; j < kVecA; ++j) {
      if (j < n) {
        const int k = j % pl.vec_rows;
        if (k == 0) base = reinterpret_cast<const float*>(cs.wait());
        vrow[j] = base + k * C;
      }
    }
    return vec_pieces(n, pl.vec_rows);
  };

  for (int l = 0; l < p.L; ++l) {
    const size_t lc = static_cast<size_t>(l) * C;
    unsigned* amax_l = amax_g + kAmaxSlots * l;

    // ---- phase A: ln1, shift, the mixes quantized, r k v rows -------------
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
      const int held = wait_run(kVecA);  // ln1 w, b, the mixes k, v, r, att_in
      const float* ain = vrow[5];
      float* att_out = p.att_out + lc;
      const bool first = blockIdx.x == 0;
      stream::layer_norm_act<WF, 3>(
          xs, xl, vrow[0], vrow[1], C, 1e-5f, red,
          [&](int c, float y) {
            if (first) att_out[c] = y;
          },
          [&](int m, int c) { return mix45(xl[c], ain[c], vrow[2 + m][c]); }, q8, C, dxs);
      cs.release(held);
    }
    cs.rows<WF>(pl.att, C,
                [&](int row) { return q8 + att_mix(row >= 2 * C ? 2 : row >= C ? 1 : 0) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = row >= 2 * C ? 2 : row >= C ? 1 : 0;
                  const float y = dequant(acc, dxs[att_mix(part)], d);
                  att_g[row] = part == 0 ? sigmoidf(y) : y;
                });
    barrier();

    // ---- phase B: wkv4 (every block), the state, out rows + residual ------
    {
      const int held = wait_run(kVecB);  // the td slice, tf, aa_in, bb_in, pp_in
      const float* td = vrow[0] - pl.s0;
      const float* tf = vrow[1];
      const float* aa = vrow[2];
      const float* bb = vrow[3];
      const float* pp = vrow[4];
      float amax[1] = {0.f};
      for (int c = tid; c < C; c += kThreads) {
        const float kk = __ldcg(att_g + C + c), vv = __ldcg(att_g + 2 * C + c);
        const float y = mul(__ldcg(att_g + c), wkv4_out(tf[c], kk, vv, aa[c], bb[c], pp[c]));
        if (c >= pl.s0 && c < pl.s1)
          wkv4_state(td[c], kk, vv, aa[c], bb[c], pp[c], p.aa_out + lc + c, p.bb_out + lc + c,
                     p.pp_out + lc + c);
        if constexpr (kQuant) {
          xl[c] = y;
          amax[0] = fmaxf(amax[0], fabsf(y));
        } else {
          q8[c] = y;
        }
      }
      cs.release(held);
      if constexpr (kQuant) {
        // act_n's quantization of the vector, its amax taken above
        stream::block_max_n<1>(amax, red);
        const float dx = amax[0] / 127.0f;
        const float inv = act_inv_scale(dx);
        if (tid == 0) dxs[0] = dx;
        for (int c = tid; c < C; c += kThreads) q8[c] = act_code(xl[c], inv);
      }
      // the residual at this block's out rows (into xs, free until E)
      const int r0 = pl.out.r0, nr = pl.out.r1 - r0;
      for (int i = tid; i < nr; i += kThreads) xs[i] = __ldcg(x_g + r0 + i);
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
      const int held = wait_run(kVecE);  // ln2 w, b, fmix k, r, ffn_in
      const float* fin = vrow[4];
      float* ffn_out = p.ffn_out + lc;
      const bool first = blockIdx.x == 0;
      stream::layer_norm_act<WF, 2>(
          xs, xl, vrow[0], vrow[1], C, 1e-5f, red,
          [&](int c, float y) {
            if (first) ffn_out[c] = y;
          },
          [&](int m, int c) { return mix45(xl[c], fin[c], vrow[2 + m][c]); }, q8, C, dxs);
      cs.release(held);
    }
    rows_pair<WF>(cs, pl.fk, pl.fr, C, q8, q8 + C,
                  [&](int row, auto acc, const float* d) {
                    const float y = fmaxf(dequant(acc, dxs[0], d), 0.f);
                    const float v = mul(y, y);
                    fk_g[row] = v;
                    if constexpr (kQuant) stream::note_amax(&amx[0], v);
                  },
                  [&](int row, auto acc, const float* d) {
                    rg_g[row] = sigmoidf(dequant(acc, dxs[1], d));
                  });
    if constexpr (kQuant) stream::publish_amax<kAmaxSlots>(amx, amax_l);
    barrier();

    // ---- phase F: fv rows, x += sigmoid(fr) * fv ----------------------------
    {
      // the residual and sigmoid(fr) at this block's fv rows, loaded beside
      // the codes (into xs and xl, free until the next layer)
      const int r0 = pl.fv.r0, nr = pl.fv.r1 - r0;
      const float x0 = tid < nr ? __ldcg(x_g + r0 + tid) : 0.f;
      const float g0 = tid < nr ? __ldcg(rg_g + r0 + tid) : 0.f;
      stream::act_published<WF, 1>(fk_g, F, q8, dxs, amax_l);
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
  if (wf == kBf16) return reinterpret_cast<const void*>(v4_decode_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(v4_decode_kernel<kInt4>)
                     : reinterpret_cast<const void*>(v4_decode_kernel<kInt8>);
}

// Why K8 cannot run these shapes (a CUDA error code), or 0. The Python
// side's v4_decode_shape_error holds the rules on widths (v4_stream_plan the
// plan's); this refuses what the kernel's layout cannot take.
int shape_error(int wf, int C, int F, int V) {
  const Layout4 lo(C, F, wf);
  if (C <= 0 || F <= 0 || C % 16 != 0 || F % 16 != 0 || V <= 0 || lo.vec_rows < 2 ||
      static_cast<int>(lo.stages) < stream::kMinStages ||
      vec_pieces(kVecA, lo.vec_rows) > static_cast<int>(lo.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int launch(int wf, void* const* ptrs, int C, int F, int L, int V, int emb_f32, int grid_blocks,
           void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = shape_error(wf, C, F, V);
  if (bad != 0) return bad;
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
  const size_t smem = Layout4(C, F, wf).smem;
  cudaError_t err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel_for(wf), dim3(grid_blocks), dim3(kBlockThreads),
                                      kargs, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int grid_blocks_for(int wf, int C, int F) {
  return cooperative_grid(kernel_for(wf), kBlockThreads, Layout4(C, F, wf).smem);
}

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch with 21 pointers (token,
// emb, ln0, mats, scales, vecs, head, head_d, ln_out, the five state arrays
// in and out in the order att_xx, ffn_xx, aa, bb, pp, logits, scratch). The
// bf16 entry takes one int more, emb_f32 (the embedding table is f32, not
// bf16); it reads no scales or head_d (pass null).
extern "C" int rwkv_v4_decode_grid(int C, int F) { return grid_blocks_for(kInt8, C, F); }

extern "C" int rwkv_v4_decode_w4_grid(int C, int F) { return grid_blocks_for(kInt4, C, F); }

extern "C" int rwkv_v4_decode_bf16_grid(int C, int F) { return grid_blocks_for(kBf16, C, F); }

// The stream plan of form wf (0 int8, 1 int4, 2 bf16) as the kernel
// computes it, for ops/megakernel.py to hold v4_stream_plan to: out[0] the
// launch's dynamic shared bytes, out[1] a stage's bytes, out[2] the stages,
// out[3] block `block`'s pieces a layer of a grid of `blocks`, out[4] its
// pieces of the head, out[5] the form's kernel's static shared bytes,
// out[6] vector rows a piece. Returns a CUDA error code (0: none).
extern "C" int rwkv_v4_decode_plan(int wf, int C, int F, int V, int blocks, int block,
                                   long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout4 lo(C, F, wf);
  const Plan4 pl(lo, C, F, V, wf, blocks, block);
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
  return 0;
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
