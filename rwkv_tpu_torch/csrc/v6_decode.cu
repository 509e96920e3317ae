// K6: one RWKV v6 (Finch) decode step at B=1 for all layers, w8a8, w4a8 or
// bf16, with ln_out and the LM head inside the kernel. One launch per token.
//
// Replaces rwkv_tpu/ops/megakernel.py::v6_decode_megakernel (kernel body
// _make_kernel_v6, head phases _emit_head_phases) and
// v6_decode_megakernel_tiled (_make_kernel_tiled_v6, w8 and w4), each also
// in its quant=False form (bf16 matrices and head, f32 maa2). The TPU
// splits those two only by how a layer's weights fit VMEM; on this card
// one kernel computes their function at any width, on the serving state
// layout [L, H, S_i, S_j] (the TPU kernels transpose it to [H, S_j, S_i]).
//
// Bound on this card: the step streams every weight once -- at the 1.6B
// width (C=2048, F=8192, d_maa 32, d_dec 64) w8a8 about 24 x 59.3 MB of
// int8 matrices, 1.31 MB/layer of f32 maa2, ~0.2 MB/layer of scales and
// vectors, 1.05 MB/layer of wkv state read and written, and the 134 MB
// int8 head, ~1.62 GB in all (w4a8: the five big matrices at half the
// bytes, ~0.92 GB; bf16: every matrix and the head at twice the int8
// bytes, ~3.2 GB) -- so HBM bandwidth bounds it (~0.48 / ~0.27 / ~0.96 ms
// at 3.35 TB/s).
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel,
// one 256-thread block per SM, phases separated by grid-wide barriers),
// seven phases a layer:
//   A  ln1, token shift, xxx = xl + sx * maa_x quantized, the maa1 rows
//      (5 d_maa) with tanh
//   M  the five maa2 up-projections in float32 (f32 FMAs: int8, bf16 or
//      TF32 there drift far from the per-op path), each row's epilogue
//      writing its mix xl + sx * (maa5 + m) (w, k, v, r, g)
//   B  the five mixes quantized as whole vectors, the rkvg rows (r, k, v,
//      silu(g)) and the d_dec dw1 rows with tanh
//   C  per head (one block each): the head's dw2 rows, exp(-exp(.)) decay,
//      the wkv6 step (the output reads the OLD state plus the time_faaaa
//      bonus, then the state decays and takes k v^T), group norm (eps
//      64e-5), ln_x, times the gate
//   D  out rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//   F  fv rows: x += sigmoid(fr) * fv
// then ln_out and the head rows.
//
// Every input that does not depend on the token -- the weight rows with
// their row scales, the vector rows a phase reads, maa2, att_in / ffn_in
// and phase C's state rows -- reaches shared memory through a ring of
// stages fed by 1-D bulk asynchronous copies (decode_stream.cuh), in the
// order the block consumes them. A static plan (Layout6 / Plan6 /
// piece_copy; ops/megakernel.py::v6_stream_plan mirrors it) gives each
// block contiguous ranges of each phase's rows, in 4-row groups, cut into
// pieces of as many whole rows as fit a stage, each followed by the
// 16-byte window of its row scales. A producer warp (the block's ninth)
// issues each piece as soon as every consumer warp has released the piece
// before it in that stage, so the next phases' rows are in flight while
// the consumers wait at the grid barriers; the eight consumer warps
// synchronize on a named barrier and cross the grid on a barrier of their
// own. The block's lane groups take a matrix's rows in turn and compute
// each from shared memory with the lanes, the chunk order and the shuffle
// tree that matvec_rows (common.cuh) gives the row, so which block or warp
// computes a row changes nothing in its value: the outputs do not depend
// on the grid. The phases whose input vector other blocks wrote (B: the
// five mixes, C: the dw1 outputs, D: xo, F: the relu^2 keys) quantize it
// in one pass from an amax that the producing phase's epilogues published
// with atomicMax (the max is exact in any order, so the codes equal
// quantize_n's); the others fold their quantization's amax into the layer
// norm's last pass.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole (amax over all of it, codes rint(x * inv) clipped to +-127), the
// int32 sum is scaled as (float(acc) * dx) * d, and the elementwise formulas
// use explicit round-to-nearest multiplies and adds, so that no fused
// multiply-add shifts an activation across a code boundary. The bf16 form
// (WF = kBf16, common.cuh) stages each input vector in f32 instead of
// quantizing it, and each row's f32 dot is the output as it is (no scales).
#include "decode_stream.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp that issues the block's stream
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

// rows of the per-layer vector block [L, kNumVec6, C] (megakernel.py's
// V6_VEC_KEYS, then maa5, tdecay, tf)
enum VecRow6 {
  kLn1W = 0, kLn1B, kLn2W, kLn2B, kLnxW, kLnxB, kMaaX, kFXK, kFXR,
  kMaa5,           // five rows: w, k, v, r, g
  kTDecay = kMaa5 + 5,
  kTF,
  kNumVec6
};

// Byte offsets of a layer's eight matrices in the flat pack's [L, bytes]
// buffer (rkvg | maa1 | dw1 | dw2 | out | fk | fv | fr), and the layer's
// size, for weight form wf. Under w4 the big ones (rkvg, out, fk, fv, fr)
// hold int4 codes, two a byte, and the LoRA ones int8; in the bf16 form
// all eight are bf16.
struct MatOffsets6 {
  size_t rkvg, maa1, dw1, dw2, out, fk, fv, fr, layer;
  __host__ __device__ MatOffsets6(int C, int DM, int DD, int F, int wf) {
    const int sf = small_form(wf);
    rkvg = 0;
    maa1 = rkvg + form_bytes(wf, 4ull * C * C);
    dw1 = maa1 + form_bytes(sf, 5ull * DM * C);
    dw2 = dw1 + form_bytes(sf, 1ull * DD * C);
    out = dw2 + form_bytes(sf, 1ull * C * DD);
    fk = out + form_bytes(wf, 1ull * C * C);
    fv = fk + form_bytes(wf, 1ull * F * C);
    fr = fv + form_bytes(wf, 1ull * C * F);
    layer = fr + form_bytes(wf, 1ull * C * C);
  }
};

// Row scales of a layer (int forms), in the same order: 8C + 5 DM + DD + F
// floats.
struct ScaleOffsets6 {
  size_t rkvg, maa1, dw1, dw2, out, fk, fv, fr, layer;
  __host__ __device__ ScaleOffsets6(int C, int DM, int DD, int F) {
    rkvg = 0;
    maa1 = rkvg + 4ull * C;
    dw1 = maa1 + 5ull * DM;
    dw2 = dw1 + DD;
    out = dw2 + C;
    fk = out + C;
    fv = fk + F;
    fr = fv + C;
    layer = fr + C;
  }
};

// Which of the five mixes (w, k, v, r, g) feeds each part of the fused
// rkvg rows (r, k, v, g).
__device__ __forceinline__ int rkvg_mix(int part) { return part == 0 ? 3 : part == 3 ? 4 : part; }

struct Args {
  const int* token;
  const void* emb;          // [V, C]: bf16 bits, or f32 when emb_f32
  const float* ln0;         // [2, C]
  const int8_t* mats;       // [L, MatOffsets6.layer]
  const float* scales;      // [L, ScaleOffsets6.layer] (int forms)
  const float* vecs;        // [L, kNumVec6, C]
  const float* maa2;        // [L, 5C, DM] f32
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
  float* scratch;           // scratch_floats(C, DM, DD, F, L); x ends at scratch[0..C)
  int C, H, S, DM, DD, F, L, V;
  int emb_f32;
};

// A layer's published amax slots in the scratch: the five mixes (w, k, v,
// r, g), the dw1 outputs, xo and the relu^2 keys.
constexpr int kAmaxSlots = 8;
enum AmaxSlot { kAmMix = 0, kAmDn = 5, kAmXo = 6, kAmFk = 7 };

// Floats of the kernel's global scratch: x, mixdn (5 DM), the five mixes
// (5C), r|k|v|silu(g) (4C), the dw1 downs (DD), xo, sigmoid(fr), the
// relu^2 keys (F), then kAmaxSlots amax slots a layer (the kernel clears
// them); the Python wrapper allocates the same. The timing build's stamps
// follow.
__host__ __device__ inline size_t scratch_floats(int C, int DM, int DD, int F, int L) {
  return 12ull * C + 5ull * DM + DD + F + static_cast<size_t>(kAmaxSlots) * L;
}

// Floats of the per-head / maa2 staging area in shared memory.
__host__ __device__ inline int hv_floats(int S, int DM) {
  return 8 * S > 5 * DM ? 8 * S : 5 * DM;
}

// ---- the stream plan (ops/megakernel.py::v6_stream_plan mirrors it) --------

using stream::Rows;
using stream::part;
using stream::round_up;
using stream::max2;

// Shared memory of a launch: xs, xl (C floats each), hv, red (256), dxs
// (8), eight block-local amax slots, the activations (int8 codes, or f32 in
// the bf16 form; max(5C, F) of them), then the block's plan, its mbarriers
// and the ring (stream::Ring), each stage at least the largest piece.
__host__ __device__ inline size_t act_off6(int C, int S, int DM) {
  return 4 * (2ull * C + hv_floats(S, DM) + 256 + 8 + kAmaxSlots);
}

__host__ __device__ inline size_t plan_off6(int C, int S, int DM, int F, int wf) {
  const size_t acts = static_cast<size_t>(5 * C > F ? 5 * C : F);
  return round_up(act_off6(C, S, DM) + (wf == kBf16 ? 4 : 1) * acts, 16);
}

// the largest piece: two vector rows, a head's state, a head's dw2 piece,
// one row of any matrix with its scale window
__host__ __device__ inline size_t piece6(int C, int S, int DM, int DD, int F, int wf) {
  const int sf = small_form(wf);
  size_t piece = max2(8ull * C, 4ull * S * S);
  piece = max2(piece, S * form_bytes(sf, DD) + (wf == kBf16 ? 16ull : 20ull) * S);
  size_t row = max2(form_bytes(wf, C), form_bytes(wf, F));
  row = max2(row, max2(form_bytes(sf, C), 4ull * DM));
  return max2(piece, row + stream::win_bytes(1));
}

struct Layout6 : stream::Ring {
  size_t act_off;
  __host__ __device__ Layout6(int C, int S, int DM, int DD, int F, int wf)
      : stream::Ring(plan_off6(C, S, DM, F, wf), piece6(C, S, DM, DD, F, wf)),
        act_off(act_off6(C, S, DM)) {}
};

// The pieces of a layer in stream order (then those of the head). A piece
// fills one stage; a segment is a run of pieces.
enum Seg6 {
  sLn1,     // ln1 w | b
  sMixA,    // maa_x | att_in
  sMaa1, sMaa2, sRkvg, sDw1,
  sHeads,   // per head of the block: (dw2 rows, scales, tdecay, tf, ln_x w, b), (state)
  sOut,
  sLn2,     // ln2 w | b
  sMixE,    // ffn maa_k | maa_r
  sFfnIn,
  sFk, sFr, sFv,
  kLayerSegs,
  sLnOut = kLayerSegs,  // ln_out w | b
  sHead,
  kAllSegs
};

// Block b's share of every phase.
struct Plan6 {
  Rows maa1, maa2, rkvg, dw1, out, fk, fr, fv, head;
  int heads;
  __host__ __device__ Plan6(const Layout6& lo, int C, int DM, int DD, int F, int H, int V,
                            int wf, int blocks, int b) {
    const int sf = small_form(wf);
    const bool w = wf != kBf16;
    const int bc = static_cast<int>(form_bytes(wf, C)), sc = static_cast<int>(form_bytes(sf, C));
    const int big = lanes_for(C, wf);
    maa1 = part(5 * DM, blocks, b, false, sc, w, lo.stage, 32);
    maa2 = part(5 * C, blocks, b, false, 4 * DM, true, lo.stage, 32);
    rkvg = part(4 * C, blocks, b, false, bc, w, lo.stage, big);
    dw1 = part(DD, blocks, b, true, sc, w, lo.stage, 32);
    out = part(C, blocks, b, false, bc, w, lo.stage, big);
    fk = part(F, blocks, b, false, bc, w, lo.stage, big);
    fr = part(C, blocks, b, true, bc, w, lo.stage, big);
    fv = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, F)), w, lo.stage,
              lanes_for(F, wf));
    head = part(V, blocks, b, false, sc, w, lo.stage, 8);
    heads = b < H ? (H - b + blocks - 1) / blocks : 0;
  }
  __host__ __device__ const Rows* rows(int seg) const {
    switch (seg) {
      case sMaa1: return &maa1;
      case sMaa2: return &maa2;
      case sRkvg: return &rkvg;
      case sDw1: return &dw1;
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
    return seg == sHeads ? 2 * heads : 1;
  }
  __host__ __device__ int layer_pieces() const {
    int n = 0;
    for (int s = 0; s < kLayerSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(Plan6) <= stream::kPlanBytes, "the plan's shared bytes");

// Copy i of piece idx of segment seg of layer l for block b of a grid of
// `blocks` (plan pl): a 16-byte multiple from a 16-byte aligned src into
// the stage at offset dst. Returns false past the piece's last copy.
__host__ __device__ inline bool piece_copy(const Args& p, const MatOffsets6& mo,
                                           const ScaleOffsets6& so, const Plan6& pl, int wf,
                                           int b, int blocks, int l, int seg, int idx, int i,
                                           const void** src, uint32_t* dst, uint32_t* bytes) {
  const int C = p.C, S = p.S, DM = p.DM;
  const int sf = small_form(wf);
  const bool w = wf != kBf16;
  const unsigned char* mats = reinterpret_cast<const unsigned char*>(p.mats) + l * mo.layer;
  const float* scales = w ? p.scales + l * so.layer : nullptr;
  const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec6 * C;
  auto put = [&](const void* s_, uint32_t d_, uint32_t n_) {
    *src = s_;
    *dst = d_;
    *bytes = n_;
    return true;
  };
  // piece idx of r's rows from base, then the window of their floats in
  // win (scales, or maa5) when win is not null
  auto rows = [&](const Rows& r, const void* base_v, const float* win) {
    const unsigned char* base = static_cast<const unsigned char*>(base_v);
    const int c0 = r.c0(idx), c1 = r.c1(idx);
    const uint32_t bytes = static_cast<uint32_t>((c1 - c0) * r.rb);
    if (i == 0) return put(base + static_cast<size_t>(c0) * r.rb, 0u, bytes);
    if (i == 1 && win != nullptr) {
      const int w0 = c0 & ~3, w1 = (c1 + 3) & ~3;
      return put(win + w0, bytes, static_cast<uint32_t>(4 * (w1 - w0)));
    }
    return false;
  };
  switch (seg) {
    case sLn1: return i == 0 && put(vec + kLn1W * C, 0u, 8u * C);
    case sMixA:
      if (i == 0) return put(vec + kMaaX * C, 0u, 4u * C);
      return i == 1 && put(p.att_in + static_cast<size_t>(l) * C, 4u * C, 4u * C);
    case sMaa1: return rows(pl.maa1, mats + mo.maa1, w ? scales + so.maa1 : nullptr);
    case sMaa2: return rows(pl.maa2, p.maa2 + static_cast<size_t>(l) * 5 * C * DM, vec + kMaa5 * C);
    case sRkvg: return rows(pl.rkvg, mats + mo.rkvg, w ? scales + so.rkvg : nullptr);
    case sDw1: return rows(pl.dw1, mats + mo.dw1, w ? scales + so.dw1 : nullptr);
    case sHeads: {
      const int h = b + (idx >> 1) * blocks;
      if ((idx & 1) == 1)
        return i == 0 && put(p.heads_in + (static_cast<size_t>(l) * p.H + h) * S * S, 0u,
                             4u * S * S);
      const uint32_t rb = static_cast<uint32_t>(form_bytes(sf, p.DD));
      if (i == 0) return put(mats + mo.dw2 + static_cast<size_t>(h) * S * rb, 0u, S * rb);
      uint32_t off = S * rb;
      int j = i - 1;
      if (w) {
        if (j == 0) return put(scales + so.dw2 + static_cast<size_t>(h) * S, off, 4u * S);
        off += 4 * S;
        --j;
      }
      const int vrows[4] = {kTDecay, kTF, kLnxW, kLnxB};
      return j < 4 && put(vec + vrows[j] * C + h * S, off + 4u * S * j, 4u * S);
    }
    case sOut: return rows(pl.out, mats + mo.out, w ? scales + so.out : nullptr);
    case sLn2: return i == 0 && put(vec + kLn2W * C, 0u, 8u * C);
    case sMixE: return i == 0 && put(vec + kFXK * C, 0u, 8u * C);
    case sFfnIn: return i == 0 && put(p.ffn_in + static_cast<size_t>(l) * C, 0u, 4u * C);
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

template <int WF>
__global__ void __launch_bounds__(kBlockThreads, 1)
v6_decode_kernel(Args p) {
  constexpr int LF = small_form(WF);  // the LoRAs' (and the head's) form
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, H = p.H, S = p.S, DM = p.DM, DD = p.DD, F = p.F;
  const int tid = threadIdx.x;
  const Layout6 lo(C, S, DM, DD, F, WF);
  const MatOffsets6 mo(C, DM, DD, F, WF);
  const ScaleOffsets6 so(C, DM, DD, F);

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);    // [C] residual / ln input, then sx = att_in - xl
  float* xl = xs + C;                            // [C] normalized (kept from A to M)
  float* hv = xl + C;                            // [hv_floats] per-head vectors / mixdn
  float* red = hv + hv_floats(S, DM);            // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAmaxSlots] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(5C, F)] activations
  Plan6* plan = reinterpret_cast<Plan6*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);  // one a stage
  uint64_t* empty = full + stream::kMaxStages;                      // one a stage
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);

  if (tid == 0) {
    *plan = Plan6(lo, C, DM, DD, F, H, p.V, WF, gridDim.x, blockIdx.x);
    for (int s = 0; s < stages; ++s) {
      stream::mbar_init(&full[s], 1);
      stream::mbar_init(&empty[s], stream::kConsumerWarps);
    }
    stream::fence_mbar_init();
  }
  if (tid < kAmaxSlots) amx[tid] = 0u;
  __syncthreads();  // the last barrier of all 288 threads
  const Plan6& pl = *plan;
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
  float* mixdn_g = x_g + C;         // [5 DM] tanh(maa1 rows)
  float* mix_g = mixdn_g + 5 * DM;  // [5][C] mixes w, k, v, r, g
  float* rkvg_g = mix_g + 5 * C;    // [4][C] r, k, v, silu(g)
  float* dn_g = rkvg_g + 4 * C;     // [DD] tanh(dw1 rows)
  float* xo_g = dn_g + DD;          // attention output before `out`
  float* rg_g = xo_g + C;           // sigmoid(fr rows)
  float* fk_g = rg_g + C;           // [F] relu^2 keys
  unsigned* amax_g = reinterpret_cast<unsigned*>(p.scratch + scratch_floats(C, DM, DD, F, 0));

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, DM, DD, F, p.L));
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
  const int lane = tid & 31;
  stream::Stream cs{ring, lo.stage, stages, full, empty};
  // the block-local amax slots into the layer's global ones (int forms)
  auto publish = [&](unsigned* slots) {
    if constexpr (kQuant) stream::publish_amax<kAmaxSlots>(amx, slots);
  };

  for (int l = 0; l < p.L; ++l) {
    unsigned* amax_l = amax_g + kAmaxSlots * l;

    // ---- phase A: ln1, shift, xxx, maa1 rows with tanh ---------------------
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
      const float* ln = reinterpret_cast<const float*>(cs.wait());  // ln1 w | b
      const float* mx = reinterpret_cast<const float*>(cs.wait());  // maa_x | att_in
      const float* ai = mx + C;
      stream::layer_norm_act<WF, 1>(
          xs, xl, ln, ln + C, C, 1e-5f, red,
          [&](int c, float y) { xs[c] = sub(ai[c], y); },  // sx, kept for M
          [&](int, int c) { return add(xl[c], mul(xs[c], mx[c])); }, q8, 0, dxs);
      cs.release(2);
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    cs.rows<LF>(pl.maa1, C, [&](int) { return q8; },
                [&](int row, auto acc, const float* d) {
                  mixdn_g[row] = tanhf(dequant(acc, dxs[0], d));
                });
    barrier();

    // ---- phase M: maa2 up-projections (f32) into the five mixes ------------
    {
      float* mdn = hv;  // [5 DM]
      stream::load_vec(mdn, mixdn_g, 5 * DM);
      stream::csync();
      // lpr lanes share a maa2 row of DM floats, one float4 at a time
      const int pieces = DM >> 2;
      const int lpr = pl.maa2.lpr;
      const int gpw = 32 / lpr, sub_lane = lane % lpr, grp = lane / lpr;
      for (int k = 0; k < pl.maa2.pieces(); ++k) {
        const int c0 = pl.maa2.c0(k), n = pl.maa2.c1(k) - c0;
        const unsigned char* st = cs.wait();
        const float4* m2 = reinterpret_cast<const float4*>(st);
        const float* cf = reinterpret_cast<const float*>(st + 4ull * n * DM);  // maa5 window
        const int w0 = c0 & ~3;
        for (int base = (tid >> 5) * gpw; base < n; base += stream::kConsumerWarps * gpw) {
          const int i = base + grp, row = c0 + i;
          float acc = 0.f;
          if (i < n) {
            const float* md = mdn + (row / C) * DM;
            for (int q = sub_lane; q < pieces; q += lpr) {
              const float4 w = m2[static_cast<size_t>(i) * pieces + q];
              acc = fmaf(w.x, md[4 * q], acc);
              acc = fmaf(w.y, md[4 * q + 1], acc);
              acc = fmaf(w.z, md[4 * q + 2], acc);
              acc = fmaf(w.w, md[4 * q + 3], acc);
            }
          }
          for (int off = lpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          if (sub_lane == 0 && i < n) {
            const int c = row % C;
            const float v = add(xl[c], mul(xs[c], add(cf[row - w0], acc)));
            mix_g[row] = v;
            if constexpr (kQuant) stream::note_amax(&amx[kAmMix + row / C], v);
          }
        }
        cs.release(1);
      }
    }
    publish(amax_l);
    barrier();

    // ---- phase B: five mixes quantized, rkvg rows, dw1 rows with tanh ------
    stream::act_published<WF, 5>(mix_g, C, q8, dxs, amax_l + kAmMix);
    cs.rows<WF>(pl.rkvg, C,
                [&](int row) { return q8 + rkvg_mix(row / C) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = row / C;
                  float y = dequant(acc, dxs[rkvg_mix(part)], d);
                  if (part == 3) y = mul(y, sigmoidf(y));  // silu gate
                  rkvg_g[row] = y;
                });
    cs.rows<LF>(pl.dw1, C, [&](int) { return q8; },  // mix w
                [&](int row, auto acc, const float* d) {
                  const float v = tanhf(dequant(acc, dxs[0], d));
                  dn_g[row] = v;
                  if constexpr (kQuant) stream::note_amax(&amx[kAmDn], v);
                });
    publish(amax_l);
    barrier();

    // ---- phase C: per head: dw2 rows, decay, wkv6, group norm, ln_x, gate --
    // a head's r, k, v and gate, loaded ahead of their use
    float hr = 0.f, hk = 0.f, hvv = 0.f, hg = 0.f;
    auto fetch_head = [&](int h) {
      if (tid < S) {
        const int c = h * S + tid;
        hr = __ldcg(rkvg_g + c);
        hk = __ldcg(rkvg_g + C + c);
        hvv = __ldcg(rkvg_g + 2 * C + c);
        hg = __ldcg(rkvg_g + 3 * C + c);
      }
    };
    if (pl.heads > 0) {
      fetch_head(blockIdx.x);
      stream::act_published<LF, 1>(dn_g, DD, q8, dxs, amax_l + kAmDn);
    }
    for (int j = 0; j < pl.heads; ++j) {  // block-uniform
      const int h = blockIdx.x + j * gridDim.x;
      float* h_r = hv;
      float* h_k = hv + S;
      float* h_v = hv + 2 * S;
      float* h_w = hv + 3 * S;
      float* h_y = hv + 4 * S;
      // the head's piece: dw2 rows, (scales,) tdecay, tf, ln_x w, ln_x b
      const unsigned char* hp = cs.wait();
      const size_t w2_bytes = S * form_bytes(LF, DD);
      const float* d2 = reinterpret_cast<const float*>(hp + w2_bytes);
      const float* tdecay = d2 + (kQuant ? S : 0);
      const float* tf = tdecay + S;
      const float* lnx_w = tf + S;
      const float* lnx_b = lnx_w + S;
      stream::smem_rows<LF>(hp, S, DD, 32, 0, [&](int) { return q8; }, [&](int r, auto acc) {
        const float wl = add(dequant(acc, dxs[0], d2 + r), tdecay[r]);
        h_w[r] = expf(-expf(wl));
      });
      const int c = h * S + tid;
      float dot_part = 0.f;
      const float gate = hg;
      if (tid < S) {
        h_r[tid] = hr;
        h_k[tid] = hk;
        h_v[tid] = hvv;
        dot_part = mul(mul(hr, tf[tid]), hk);
      }
      if (j + 1 < pl.heads) fetch_head(h + gridDim.x);
      const float dot = stream::block_sum(dot_part, red);  // also orders the h_* stores

      // state rows: tpr threads per row i, entries j = jj * tpr + part
      const float* st = reinterpret_cast<const float*>(cs.wait());
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
        const float yn = mul(yc, rsqrtf(add(var, 64e-5f)));
        const float xo = add(mul(yn, lnx_w[tid]), lnx_b[tid]);
        const float v = mul(xo, gate);
        xo_g[c] = v;
        if constexpr (kQuant) stream::note_amax(&amx[kAmXo], v);
      }
      stream::csync();
      cs.release(2);
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
      const float* ln = reinterpret_cast<const float*>(cs.wait());   // ln2 w | b
      const float* fx = reinterpret_cast<const float*>(cs.wait());   // maa_k | maa_r
      const float* fin = reinterpret_cast<const float*>(cs.wait());  // ffn_in
      stream::layer_norm_act<WF, 2>(
          xs, xl, ln, ln + C, C, 1e-5f, red, [](int, float) {},
          [&](int m, int c) { return add(xl[c], mul(sub(fin[c], xl[c]), fx[m * C + c])); }, q8, C,
          dxs);
      cs.release(3);
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

const void* kernel_for(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(v6_decode_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(v6_decode_kernel<kInt4>)
                     : reinterpret_cast<const void*>(v6_decode_kernel<kInt8>);
}

// Why K6 cannot run these shapes (a CUDA error code), or 0.
int shape_error(int wf, int C, int H, int S, int DM, int DD, int F, int V) {
  const Layout6 lo(C, S, DM, DD, F, wf);
  if (kThreads % S != 0 || S * S / kThreads > kMaxJ || S % 4 != 0 || DM % 4 != 0 ||
      H * S != C || C % 16 != 0 || DD % 16 != 0 || F % 16 != 0 || V % 4 != 0 ||
      static_cast<int>(lo.stages) < stream::kMinStages)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Grid size a launch in form wf uses (blocks), or a negative CUDA error
// code (0: the kernel does not fit on an SM at these sizes).
int grid_blocks_for(int wf, int C, int S, int DM, int DD, int F) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = Layout6(C, S, DM, DD, F, wf).smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(wf), kBlockThreads,
                                                        smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm > 1) per_sm = 1;  // one block per SM, as K3
  return per_sm * sms;
}

int launch(int wf, const void* token, const void* emb, const void* ln0, const void* mats,
           const void* scales, const void* vecs, const void* maa2, const void* head,
           const void* head_d, const void* ln_out, const void* att_in, const void* ffn_in,
           const void* heads_in, void* att_out, void* ffn_out, void* heads_out, void* logits,
           void* scratch, int C, int H, int S, int DM, int DD, int F, int L, int V, int emb_f32,
           int grid_blocks, void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bad = shape_error(wf, C, H, S, DM, DD, F, V);
  if (bad != 0) return bad;
  Args a;
  a.token = static_cast<const int*>(token);
  a.emb = emb;
  a.ln0 = static_cast<const float*>(ln0);
  a.mats = static_cast<const int8_t*>(mats);
  a.scales = static_cast<const float*>(scales);
  a.vecs = static_cast<const float*>(vecs);
  a.maa2 = static_cast<const float*>(maa2);
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
  a.C = C; a.H = H; a.S = S; a.DM = DM; a.DD = DD; a.F = F; a.L = L; a.V = V;
  a.emb_f32 = emb_f32;
  void* kargs[] = {&a};
  const size_t smem = Layout6(C, S, DM, DD, F, wf).smem;
  cudaError_t err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel_for(wf), dim3(grid_blocks), dim3(kBlockThreads), kargs,
                                      smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The w8a8, w4a8 and bf16 entries: the grid size the launch uses (blocks,
// or a negative CUDA error code), and one launch. The bf16 entry takes one
// int more, emb_f32 (the embedding table is f32, not bf16); it reads no
// scales or head_d (pass null).
extern "C" int rwkv_v6_decode_grid(int C, int S, int DM, int DD, int F) {
  return grid_blocks_for(kInt8, C, S, DM, DD, F);
}

extern "C" int rwkv_v6_decode_w4_grid(int C, int S, int DM, int DD, int F) {
  return grid_blocks_for(kInt4, C, S, DM, DD, F);
}

extern "C" int rwkv_v6_decode_bf16_grid(int C, int S, int DM, int DD, int F) {
  return grid_blocks_for(kBf16, C, S, DM, DD, F);
}

// The stream plan of form wf (0 int8, 1 int4, 2 bf16) as the kernel
// computes it, for the card tests to hold ops/megakernel.py::
// v6_stream_plan to: out[0] the launch's dynamic shared bytes, out[1] a
// stage's bytes, out[2] the stages, out[3] block `block`'s pieces a layer
// of a grid of `blocks`, out[4] its pieces of the head, out[5] the form's
// kernel's static shared bytes. Returns a CUDA error code (0: none).
extern "C" int rwkv_v6_decode_plan(int wf, int C, int S, int DM, int DD, int F, int H, int V,
                                   int blocks, int block, long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout6 lo(C, S, DM, DD, F, wf);
  const Plan6 pl(lo, C, DM, DD, F, H, V, wf, blocks, block);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(wf));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<long long>(lo.smem);
  out[1] = static_cast<long long>(lo.stage);
  out[2] = static_cast<long long>(lo.stages);
  out[3] = pl.layer_pieces();
  out[4] = pl.count(sLnOut) + pl.count(sHead);
  out[5] = static_cast<long long>(attr.sharedSizeBytes);
  return 0;
}

#define RWKV_V6_DECODE_PARAMS                                                                  \
  const void *token, const void *emb, const void *ln0, const void *mats, const void *scales,   \
      const void *vecs, const void *maa2, const void *head, const void *head_d,                \
      const void *ln_out, const void *att_in, const void *ffn_in, const void *heads_in,        \
      void *att_out, void *ffn_out, void *heads_out, void *logits, void *scratch, int C,       \
      int H, int S, int DM, int DD, int F, int L, int V
#define RWKV_V6_DECODE_ARGS                                                                    \
  token, emb, ln0, mats, scales, vecs, maa2, head, head_d, ln_out, att_in, ffn_in, heads_in,   \
      att_out, ffn_out, heads_out, logits, scratch, C, H, S, DM, DD, F, L, V

extern "C" int rwkv_v6_decode(RWKV_V6_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kInt8, RWKV_V6_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v6_decode_w4(RWKV_V6_DECODE_PARAMS, int grid_blocks, void* stream) {
  return launch(kInt4, RWKV_V6_DECODE_ARGS, 0, grid_blocks, stream);
}

extern "C" int rwkv_v6_decode_bf16(RWKV_V6_DECODE_PARAMS, int emb_f32, int grid_blocks,
                                   void* stream) {
  return launch(kBf16, RWKV_V6_DECODE_ARGS, emb_f32, grid_blocks, stream);
}
