// K12, K13, K15 and K11: one layer of an RWKV v6 (Finch) decode step at
// B=1 on one shard of a tensor-parallel mesh (K12 the attention, K13 the
// gated FFN), the attention of an RWKV v5.1 / v5.2 layer (K15, a form of
// K12's kernel) and the FFN of an RWKV v7 layer (K11, a form of K13's),
// w8a8, w4a8 or bf16. One launch per shard per layer each; the caller sums
// the shards' full-C partials and gathers the FFN gate between them
// (ops/megakernel_tp.py).
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call_v6 (kernel
// _make_att_kernel_v6: K12), _ffn_layer_call_v6 (_make_ffn_kernel_v6:
// K13; its mix45 switch selects the v4/v5 token-shift mix, the FFN of the
// v4 / v5 TP paths beside K14 in tp_v45.cu and K15 here),
// _att_layer_call_v5 (_make_att_kernel_v5: K15) and _ffn_layer_call
// (_make_ffn_kernel: K11, beside K10 in tp_v7.cu), in their int8, int4 and
// bf16 forms (maa2 stays f32 in all three).
//
// Bound on this card: bytes. At the 1.6B v6 width (C=2048, F=8192, d_maa
// 32, d_dec 64) and tp=2 a K12 launch reads its shard's rkvg rows (4 x
// 1024 x 2048) and out columns (2048 x 1024), the replicated maa1 (160 x
// 2048), dw1 (64 x 2048) and f32 maa2 (5 x 2048 x 32, 1.31 MB), its dw2
// rows, ~12.2 MB, and its wkv state twice (0.52 MB); a K13 launch its fr,
// fk and fv rows, ~18.9 MB int8: ~4 us and ~6 us at 3.35 TB/s. A K15
// launch (v5.2, World 1.5B width) reads its rkvg rows and out columns,
// ~10.5 MB, and its state twice: ~3.3 us; a K11 launch (v7, World 1.5B
// width) its fk and fv rows, 16.8 MB: ~5 us. int4 moves about half, bf16
// twice.
//
// Design: the phases of K6 (v6_decode.cu) and K7 (v5_decode.cu) for one
// layer and one shard, on their input stream (decode_stream.cuh,
// tp_stream.cuh): a persistent cooperative kernel, one block per SM, each
// block eight consumer warps and one producer warp.
//   K12  A  ln1, shift, xxx quantized, the maa1 rows with tanh (replicated)
//        M  the five maa2 up-projections in f32 (replicated, all 5C rows)
//           into the five mixes w, k, v, r, g
//        B  the mixes quantized, the shard's rkvg rows (r, k, v, silu(g))
//           and the whole dw1 (d_dec rows) with tanh
//        C  per head of the shard (one block each): its dw2 rows,
//           exp(-exp(.)) decay, wkv6 with the time_faaaa bonus, group
//           norm, ln_x, gate
//        D  the shard's xo quantized with its own scale, the C rows of out
//           [C, CL] into the partial
//   K15  A  ln1, shift, the 3 (v5.1) or 4 (v5.2) mixes k, v, r(, g) in the
//           v4/v5 op order, quantized, the shard's rkvg rows (silu on g)
//        C  per head: K12's step with the static decay td and bonus tf in
//           K7's order, group norm (eps 1e-5), ln_x, the gate (v5.2)
//        D  as K12's
//   K13  A  ln2 + shift (v6's, or v4/v5's in the MIX45 form), the two
//           mixes quantized, the shard's fk rows (nf tiles) with relu^2 and
//           its fr gate rows with sigmoid
//        B  per tile, its keys quantized with their own scale, the tile's
//           fv rows [C, FT] summed into the partial in tile order
//   K11  A  ln2 + v6's shift with v7's one mix x_k, quantized, the fk rows
//           with relu^2 (no gate rows)
//        B  as K13's
// Every input that does not depend on another block -- the weight rows
// with their row scales, the vector rows a phase reads, maa2, att_in /
// ffn_in and phase C's dw2 rows, vector slices and state -- reaches shared
// memory through the block's ring of stages, fed by the producer warp with
// bulk asynchronous copies in the order the consumers take them (a static
// plan: AttLayout / AttPlan / att_copy and FfnLayout / FfnPlan / ffn_copy
// here, ops/megakernel_tp.py::tp_v6_stream_plan mirrors it, kinds "att",
// "att5", "ffn" and "ffn7"). A launch is one layer, so its start is on the
// critical path: the host computes the layout, the producer the block's
// plan (32-bit arithmetic) while the consumers load x and take its layer
// norm's statistics, and the producer then issues a piece as soon as its
// stage is free, so the rows of later phases are in flight while the
// consumers wait at the grid barriers (stream::grid_sync: one atomic a
// block). The block's lane groups take a matrix's rows in turn, each row
// with the lanes, the chunk order and the shuffle tree matvec_rows
// (common.cuh) gives it, so the outputs are the earlier K12 / K13 / K15's
// bit for bit on any grid (K11: the earlier cooperative kernel's, whose
// grid-wide matvec gave each fk row lanes_for(C) lanes and each fv row
// lanes_for(FT)). The phases whose input vector other blocks wrote (K12's
// B: the five mixes, C: the dw1 outputs, D: xo; K15's D: xo; K13's and
// K11's B: the relu^2 keys of each tile) quantize it in one pass from an
// amax the producing phase published with atomicMax (exact in any order,
// so the codes are act_n's); the others fold their amax into the layer
// norm's last pass.
//
// Numerics follow the JAX kernels as K6 and K7 do (explicit
// round-to-nearest float ops; each matvec input quantized as a whole, the
// split contractions' inputs the shard's local slices with their own
// scales).
#include "tp_stream.cuh"
#include "v45_common.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;
constexpr int kMaxTiles = 32;  // K13's FFN tiles at most (one published amax each)

// rows of a shard's replicated vector block [L, kNumRVec6, C] and of its
// own [L, kNumLVec6, C/tp] (ops/megakernel_tp.py TP6_RVECS, TP6_LVECS)
enum RVec6 {
  kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRMaaX, kRFXK, kRFXR,
  kRMaa5,  // five rows: w, k, v, r, g
  kNumRVec6 = kRMaa5 + 5
};
enum LVec6 { kLTDecay = 0, kLLnxW, kLLnxB, kLTF, kNumLVec6 };
// K15's: the v5 blocks (TP5_RVECS, TP5_LVECS) hold ln1 at rows 0, 1, ln2
// and the FFN mixes at RVec6's rows 2, 3, 5, 6 (K13's MIX45 form reads
// them there), the attention mixes k at row 4, v, r, g from row 7; the
// shard's td, tf, ln_x weight, ln_x bias
enum RVec5 { kR5MixK = 4, kR5MixV = 7 };
enum LVec5 { kL5TD = 0, kL5TF, kL5LnxW, kL5LnxB, kNumLVec5 };

// The attention kernels: K12 (v6) and K15 (v5.1: mixes k, v, r; v5.2:
// and the gate g); the FFN kernels: K13 (v6's mix), its MIX45 form (the
// v4 / v5 mix) and K11 (v7: v6's mix of the one row x_k, no gate rows).
enum AttKind { kAttV6 = 0, kAttV51 = 1, kAttV52 = 2 };
enum FfnKind { kFfnV6 = 0, kFfnV45 = 1, kFfnV7 = 2 };
// K11's row of x_k in the v7 replicated block (ops/megakernel_tp.py
// TP_RVECS, whose ln2 rows are RVec6's)
constexpr int kR7XK = 4;

using stream::Rows;
using stream::part;
using stream::round_up;

// Which of the five mixes (w, k, v, r, g) feeds each part of the fused
// rkvg rows (r, k, v, g).
__device__ __forceinline__ int rkvg_mix(int part) { return part == 0 ? 3 : part == 3 ? 4 : part; }

// The v5 attention mix m's row (amix order k, v, r, g) of the replicated block.
__host__ __device__ __forceinline__ int mix5_row(int m) {
  return m == 0 ? kR5MixK : kR5MixV + m - 1;
}

// ---- K12 and K15 --------------------------------------------------------------

struct AttArgs {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* heads_in;   // [HL, S, S] the shard's heads
  const int8_t* rkvg;      // [NA, CL, C] form WF (K12 and v5.2: NA = 4; v5.1: 3)
  const float* rkvg_d;     // [NA CL] (int forms)
  const int8_t* maa1;      // [5 DM, C] int8 (bf16); K12 only, as the four below
  const float* maa1_d;     // [5 DM]
  const int8_t* dw1;       // [DD, C] int8 (bf16)
  const float* dw1_d;      // [DD]
  const int8_t* dw2;       // [CL, DD] int8 (bf16)
  const float* dw2_d;      // [CL]
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* maa2;       // [5C, DM] f32
  const float* rvec;       // [kNumRVec6, C] (K15: TP5_RVECS)
  const float* lvec;       // [kNumLVec6, CL] (K15: kNumLVec5)
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x)
  float* heads_out;        // [HL, S, S]
  float* scratch;          // att_scratch_floats(C, CL, DM, DD, kind)
  int C, CL, S, DM, DD;    // K15: DM = DD = 0
  TpLayout lo;
};

// The published amax slots (behind the scratch): K12's five mixes (w, k,
// v, r, g), the dw1 outputs, xo; K15's xo.
constexpr int kAttAmax = 8;
enum AttAmax { kAmMix = 0, kAmDn = 5, kAmXo = 6 };

// Phase A's vector rows: K12 ln1 w, ln1 b, maa_x, att_in; K15 ln1 w, ln1
// b, att_in and its 3 or 4 mixes.
__host__ __device__ inline int att_vec_rows(int kind) {
  return kind == kAttV6 ? 4 : kind == kAttV51 ? 6 : 7;
}

// Floats of the global scratch: mixdn (5 DM), the five mixes (5C; K12
// only), r|k|v|silu(g) (4 CL), the dw1 downs (DD), xo (CL), then the amax
// slots (the kernel clears them); the timing build's stamps follow.
__host__ __device__ inline size_t att_scratch_floats(int C, int CL, int DM, int DD, int kind) {
  return 5ull * DM + (kind == kAttV6 ? 5ull * C : 0ull) + 5ull * CL + DD + kAttAmax;
}

// Floats of the per-head / maa2 staging area in shared memory.
__host__ __device__ inline int hv_floats(int S, int DM) { return 8 * S > 5 * DM ? 8 * S : 5 * DM; }

// Shared memory of a launch: xs, xl (C floats each), hv, red (256), dxs
// (8), the block-local amax slots, the activations (int8 codes, or f32 in
// the bf16 form; 5C of them), then the block's plan, its mbarriers and the
// ring.
__host__ __device__ inline size_t att_act_off(int C, int S, int DM) {
  return 4 * (2ull * C + hv_floats(S, DM) + 256 + 8 + kAttAmax);
}

// the largest piece: two vector rows; K12: a head's state, a head's dw2
// piece; K15: a head's state with its four vector slices; one row of any
// matrix with its scale window
__host__ __device__ inline size_t att_piece(int C, int CL, int S, int DM, int DD, int wf,
                                            int kind) {
  const int sf = small_form(wf);
  const bool v6 = kind == kAttV6;
  size_t piece = stream::max2(8ull * C, 4ull * S * S + (v6 ? 0ull : 4ull * kNumLVec5 * S));
  if (v6)
    piece = stream::max2(piece, S * form_bytes(sf, DD) + (wf == kBf16 ? 16ull : 20ull) * S);
  size_t row = stream::max2(form_bytes(wf, C), form_bytes(wf, CL));
  if (v6) row = stream::max2(row, stream::max2(form_bytes(sf, C), 4ull * DM));
  return stream::max2(piece, row + stream::win_bytes(1));
}

struct AttLayout : stream::Ring {
  size_t act_off;
  int vec_rows;
  __host__ __device__ AttLayout(int C, int CL, int S, int DM, int DD, int wf, int kind)
      : stream::Ring(round_up(att_act_off(C, S, DM) + (wf == kBf16 ? 4 : 1) * 5ull * C, 16),
                     att_piece(C, CL, S, DM, DD, wf, kind)),
        act_off(att_act_off(C, S, DM)),
        vec_rows(vec_rows_for(stage, C, att_vec_rows(kind))) {}
};

// The pieces in stream order; a segment is a run of pieces (K15's maa1,
// maa2 and dw1 segments are empty).
enum AttSeg {
  aVec,    // phase A's vector rows: vec_rows rows a piece
  aMaa1, aMaa2, aRkvg, aDw1,
  aHeads,  // per head of the block: K12 (dw2 rows, scales, tdecay, tf, ln_x
           // w, b), (state); K15 (state, td, tf, ln_x w, b)
  aOut,
  kAttSegs
};

// Block b's share of every phase.
struct AttPlan {
  Rows maa1, maa2, rkvg, dw1, out;
  int heads, vec_pieces, head_pieces;  // head_pieces: a head's pieces
  __host__ __device__ AttPlan(const TpLayout& lo, int C, int CL, int S, int DM, int DD, int wf,
                              int kind, int blocks, int b) {
    const int sf = small_form(wf), st = static_cast<int>(lo.stage);
    const bool w = wf != kBf16, v6 = kind == kAttV6;
    const int bc = static_cast<int>(form_bytes(wf, C)), sc = static_cast<int>(form_bytes(sf, C));
    const Rows none{0, 0, 1, 16, 1};
    maa1 = v6 ? part(5 * DM, blocks, b, false, sc, w, st, 32) : none;
    maa2 = v6 ? part(5 * C, blocks, b, false, 4 * DM, true, st, 32) : none;
    rkvg = part((kind == kAttV51 ? 3 : 4) * CL, blocks, b, false, bc, w, st, lanes_for(C, wf));
    dw1 = v6 ? part(DD, blocks, b, true, sc, w, st, 32) : none;
    out = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, CL)), w, st,
               lanes_for(CL, wf));
    const int hl = CL / S;
    heads = b < hl ? (hl - b + blocks - 1) / blocks : 0;
    head_pieces = v6 ? 2 : 1;
    vec_pieces = (att_vec_rows(kind) + lo.vec_rows - 1) / lo.vec_rows;
  }
  __host__ __device__ int count(int seg) const {
    switch (seg) {
      case aVec: return vec_pieces;
      case aMaa1: return maa1.pieces();
      case aMaa2: return maa2.pieces();
      case aRkvg: return rkvg.pieces();
      case aDw1: return dw1.pieces();
      case aHeads: return head_pieces * heads;
      case aOut: return out.pieces();
      default: return 0;
    }
  }
  __host__ __device__ int pieces() const {
    int n = 0;
    for (int s = 0; s < kAttSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(AttPlan) <= stream::kPlanBytes, "the plan's shared bytes");

// Copy i of piece idx of segment seg for block b of a grid of `blocks`.
__host__ __device__ inline bool att_copy(const AttArgs& p, const AttPlan& pl, int vec_rows, int wf,
                                         int kind, int b, int blocks, int seg, int idx, int i,
                                         const void** src, uint32_t* dst, uint32_t* bytes) {
  const int C = p.C, CL = p.CL, S = p.S;
  const bool w = wf != kBf16, v6 = kind == kAttV6;
  auto put = [&](const void* s_, uint32_t d_, uint32_t n_) {
    *src = s_;
    *dst = d_;
    *bytes = n_;
    return true;
  };
  switch (seg) {
    case aVec: {
      const int j = idx * vec_rows + i;
      if (i >= vec_rows || j >= att_vec_rows(kind)) return false;
      const float* row;
      if (v6) {
        const int vrows[3] = {kRLn1W, kRLn1B, kRMaaX};
        row = j < 3 ? p.rvec + vrows[j] * C : p.att_in;
      } else {
        row = j < 2 ? p.rvec + (kRLn1W + j) * C : j == 2 ? p.att_in : p.rvec + mix5_row(j - 3) * C;
      }
      return put(row, 4u * C * i, 4u * C);
    }
    case aMaa1: return rows_copy(pl.maa1, p.maa1, w ? p.maa1_d : nullptr, idx, i, src, dst, bytes);
    case aMaa2: return rows_copy(pl.maa2, p.maa2, p.rvec + kRMaa5 * C, idx, i, src, dst, bytes);
    case aRkvg: return rows_copy(pl.rkvg, p.rkvg, w ? p.rkvg_d : nullptr, idx, i, src, dst, bytes);
    case aDw1: return rows_copy(pl.dw1, p.dw1, w ? p.dw1_d : nullptr, idx, i, src, dst, bytes);
    case aHeads: {
      if (!v6) {
        // the state [S, S], then the head's slices of td, tf, ln_x w, ln_x b
        const int h = b + idx * blocks;
        if (i == 0) return put(p.heads_in + static_cast<size_t>(h) * S * S, 0u, 4u * S * S);
        return i <= kNumLVec5 &&
               put(p.lvec + (i - 1) * CL + h * S, 4u * S * S + 4u * S * (i - 1), 4u * S);
      }
      const int h = b + (idx >> 1) * blocks;
      if ((idx & 1) == 1)
        return i == 0 && put(p.heads_in + static_cast<size_t>(h) * S * S, 0u, 4u * S * S);
      const uint32_t rb = static_cast<uint32_t>(form_bytes(small_form(wf), p.DD));
      if (i == 0) return put(p.dw2 + static_cast<size_t>(h) * S * rb, 0u, S * rb);
      uint32_t off = S * rb;
      int j = i - 1;
      if (w) {
        if (j == 0) return put(p.dw2_d + h * S, off, 4u * S);
        off += 4 * S;
        --j;
      }
      const int lrows[4] = {kLTDecay, kLTF, kLLnxW, kLLnxB};
      return j < 4 && put(p.lvec + lrows[j] * CL + h * S, off + 4u * S * j, 4u * S);
    }
    case aOut: return rows_copy(pl.out, p.out, w ? p.out_d : nullptr, idx, i, src, dst, bytes);
    default: return false;
  }
}

// The grid barriers' words (stream::grid_sync), one a kernel (K12 and K15
// share theirs, as K13, its MIX45 form and K11 share theirs: no model runs
// two of one). Each is safe only while the launches
// on the card run one after another, as every TP launch does (the device's
// current stream, ops/megakernel_tp.py).
__device__ unsigned g_att_count = 0;
__device__ unsigned g_ffn_count = 0;

template <int WF, int KIND>
__global__ void __launch_bounds__(kBlockThreads, 1) tp_v6_att_kernel(AttArgs p) {
  unsigned long long t_entry = 0;
  ENTRY_TIME(t_entry);
  constexpr int LF = small_form(WF);  // the LoRAs' form
  constexpr bool kQuant = WF != kBf16;
  constexpr bool kV6 = KIND == kAttV6;
  constexpr bool kGate = KIND != kAttV51;
  const int C = p.C, CL = p.CL, S = p.S, DM = p.DM, DD = p.DD;
  const int tid = threadIdx.x;
  const TpLayout& lo = p.lo;

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x, then sx = att_in - xl
  float* xl = xs + C;                           // [C] ln1(x), kept from A to M
  float* hv = xl + C;                           // [hv_floats] per-head vectors / mixdn
  float* red = hv + hv_floats(S, DM);           // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAttAmax] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [5C] activations
  AttPlan* plan = reinterpret_cast<AttPlan*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);
  uint64_t* empty = full + stream::kMaxStages;
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);
  const AttPlan& pl = *plan;  // read by the consumers after stream_ready_wait

  if (tid >= kThreads) {
    // the producer warp
    const int b = blockIdx.x, blocks = gridDim.x, vr = lo.vec_rows;
    if (tid == kThreads) {
      init_mbarriers(full, empty, stages);
      *plan = AttPlan(lo, C, CL, S, DM, DD, WF, KIND, blocks, b);
    }
    __syncwarp();
    stream_ready_arrive();
    stream::produce<kAttSegs, kAttSegs>(
        pl, 1, stages, ring, lo.stage, full, empty,
        [&](int, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return att_copy(p, pl, vr, WF, KIND, b, blocks, seg, idx, i, src, dst, bytes);
        });
    return;
  }
  if (tid < kAttAmax) amx[tid] = 0u;  // ordered before their use by csync

  float* mixdn_g = p.scratch;                   // [5 DM]
  float* mix_g = mixdn_g + 5 * DM;              // [5][C] w, k, v, r, g (K12)
  float* rkvg_g = mix_g + (kV6 ? 5 * C : 0);    // [4][CL] r, k, v, silu(g)
  float* dn_g = rkvg_g + 4 * CL;                // [DD]
  float* xo_g = dn_g + DD;                      // [CL]
  unsigned* amax_g = reinterpret_cast<unsigned*>(xo_g + CL);

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + att_scratch_floats(C, CL, DM, DD, KIND));
  int n_marks = 0;
#endif
  auto barrier = [&]() {
    PHASE_MARK();
    stream::csync();
    if (tid == 0) stream::grid_sync(&g_att_count, gridDim.x);
    stream::csync();
    PHASE_MARK();
  };
  PHASE_ENTRY(t_entry);
  PHASE_MARK();
  const int lane = tid & 31;
  stream::Stream cs{ring, lo.stage, stages, full, empty};
  auto publish = [&]() {
    if constexpr (kQuant) stream::publish_amax<kAttAmax>(amx, amax_g);
  };

  stream::load_vec(xs, p.x, C);
  if (blockIdx.x == 0 && tid < kAttAmax) amax_g[tid] = 0u;  // published after a barrier
  stream::csync();
  // the vector pieces are the stream's first, in stages 0, 1, ...; the
  // layer norm's statistics need only x, so they run while they land
  const int vr = lo.vec_rows;
  auto vrow = [&](int j) {
    return reinterpret_cast<const float*>(ring + (j / vr) * lo.stage + (j % vr) * 4ull * C);
  };
  auto vec_ready = [&]() {
    stream_ready_wait();  // the mbarriers and the plan
    for (int k = 0; k < pl.vec_pieces; ++k) cs.wait();
  };
  if constexpr (kV6) {
    // ---- A: ln1, shift, xxx, maa1 rows with tanh ---------------------------
    {
      const float *ln_w = vrow(0), *ln_b = vrow(1), *mx = vrow(2), *ai = vrow(3);
      stream::layer_norm_act<WF, 1>(
          xs, xl, ln_w, ln_b, C, 1e-5f, red,
          [&](int c, float y) { xs[c] = sub(ai[c], y); },  // sx, kept for M
          [&](int, int c) { return add(xl[c], mul(xs[c], mx[c])); }, q8, 0, dxs, vec_ready);
      cs.release(pl.vec_pieces);
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.att_out[c] = xl[c];
    cs.rows<LF>(pl.maa1, C, [&](int) { return q8; },
                [&](int row, auto acc, const float* d) {
                  mixdn_g[row] = tanhf(dequant(acc, dxs[0], d));
                });
    barrier();

    // ---- M: maa2 up-projections (f32) into the five mixes ------------------
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
          for (int off = lpr >> 1; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
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
    publish();
    barrier();

    // ---- B: the mixes quantized, rkvg rows, dw1 rows with tanh -------------
    {
      // the codes of the mixes this block's rows read: its rkvg rows' parts
      // (r, k, v, g: one or two of them), and w where it has dw1 rows
      unsigned need = pl.dw1.pieces() > 0 ? 1u : 0u;
      if (pl.rkvg.pieces() > 0)
        for (int part = pl.rkvg.r0 / CL; part <= (pl.rkvg.r1 - 1) / CL; ++part)
          need |= 1u << rkvg_mix(part);
      for (int m = 0; m < 5; ++m)  // block-uniform
        if (need & (1u << m))
          stream::act_published<WF, 1>(mix_g + m * C, C, q8 + m * C, dxs + m,
                                       amax_g + kAmMix + m);
    }
    cs.rows<WF>(pl.rkvg, C, [&](int row) { return q8 + rkvg_mix(row / CL) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = row / CL;
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
    publish();
    barrier();
  } else {
    // ---- A (K15): ln1, shift, the mixes quantized, the shard's rkvg rows ---
    {
      constexpr int NA = kGate ? 4 : 3;
      const float *ln_w = vrow(0), *ln_b = vrow(1), *ai = vrow(2);
      const float* mx[NA];  // k, v, r(, g)
#pragma unroll
      for (int m = 0; m < NA; ++m) mx[m] = vrow(3 + m);
      stream::layer_norm_act<WF, NA>(
          xs, xl, ln_w, ln_b, C, 1e-5f, red, [](int, float) {},
          [&](int m, int c) { return mix45(xl[c], ai[c], mx[m][c]); }, q8, C, dxs, vec_ready);
      cs.release(pl.vec_pieces);
    }
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += kThreads) p.att_out[c] = xl[c];
    cs.rows<WF>(pl.rkvg, C, [&](int row) { return q8 + att_mix(row / CL) * C; },
                [&](int row, auto acc, const float* d) {
                  const int part = row / CL;
                  float y = dequant(acc, dxs[att_mix(part)], d);
                  if (part == 3) y = mul(y, sigmoidf(y));  // silu gate
                  rkvg_g[row] = y;
                });
    barrier();
  }

  // ---- C: per head: the decay, wkv, group norm, ln_x, gate -----------------
  // a head's r, k, v and gate, loaded ahead of their use
  float hr = 0.f, hk = 0.f, hvv = 0.f, hg = 0.f;
  auto fetch_head = [&](int h) {
    if (tid < S) {
      const int c = h * S + tid;
      hr = __ldcg(rkvg_g + c);
      hk = __ldcg(rkvg_g + CL + c);
      hvv = __ldcg(rkvg_g + 2 * CL + c);
      if (kGate) hg = __ldcg(rkvg_g + 3 * CL + c);
    }
  };
  if (pl.heads > 0) {
    fetch_head(blockIdx.x);
    if constexpr (kV6) stream::act_published<LF, 1>(dn_g, DD, q8, dxs, amax_g + kAmDn);
  }
  for (int j = 0; j < pl.heads; ++j) {  // block-uniform
    const int h = blockIdx.x + j * gridDim.x;
    float* h_r = hv;
    float* h_k = hv + S;
    float* h_v = hv + 2 * S;
    float* h_w = hv + 3 * S;
    float* h_y = hv + 4 * S;
    // K12: the head's piece of dw2 rows, (scales,) tdecay, tf, ln_x w, ln_x
    // b; K15: its state, then td, tf, ln_x w, ln_x b
    const unsigned char* hp = cs.wait();
    const float* tdecay;  // K12: the decay's bias; K15: the static decay
    if constexpr (kV6) {
      const size_t w2_bytes = S * form_bytes(LF, DD);
      const float* d2 = reinterpret_cast<const float*>(hp + w2_bytes);
      tdecay = d2 + (kQuant ? S : 0);
      stream::smem_rows<LF>(hp, S, DD, 32, 0, [&](int) { return q8; }, [&](int r, auto acc) {
        const float wl = add(dequant(acc, dxs[0], d2 + r), tdecay[r]);
        h_w[r] = expf(-expf(wl));
      });
    } else {
      tdecay = reinterpret_cast<const float*>(hp) + S * S;
    }
    const float* tf = tdecay + S;
    const float* lnx_w = tf + S;
    const float* lnx_b = lnx_w + S;
    const int c = h * S + tid;
    float dot_part = 0.f;
    const float gate = hg;
    if (tid < S) {
      h_r[tid] = hr;
      h_k[tid] = hk;
      h_v[tid] = hvv;
      if (!kV6) h_w[tid] = tdecay[tid];
      dot_part = mul(mul(hr, tf[tid]), hk);
    }
    if (j + 1 < pl.heads) fetch_head(h + gridDim.x);
    const float dot = stream::block_sum(dot_part, red);  // also orders the h_* stores

    // state rows: tpr threads per row i, entries j = jj * tpr + part
    const float* st = kV6 ? reinterpret_cast<const float*>(cs.wait())
                          : reinterpret_cast<const float*>(hp);
    const int tpr = kThreads / S;
    const int jn = S / tpr;
    const int i = tid / tpr, part = tid % tpr;
    const float* st_in = st + i * S;
    float* st_out = p.heads_out + (static_cast<size_t>(h) * S + i) * S;
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
      const float yn = mul(yc, rsqrtf(add(var, kV6 ? 64e-5f : 1e-5f)));
      const float xo = add(mul(yn, lnx_w[tid]), lnx_b[tid]);
      const float v = kGate ? mul(xo, gate) : xo;
      xo_g[c] = v;
      if constexpr (kQuant) stream::note_amax(&amx[kAmXo], v);
    }
    stream::csync();
    cs.release(pl.head_pieces);
  }
  publish();
  barrier();

  // ---- D: the shard's xo quantized, the C rows of out into the partial ----
  stream::act_published<WF, 1>(xo_g, CL, q8, dxs, amax_g + kAmXo);
  cs.rows<WF>(pl.out, CL, [&](int) { return q8; },
              [&](int row, auto acc, const float* d) { p.part[row] = dequant(acc, dxs[0], d); });
  PHASE_MARK();
}

// ---- K13 --------------------------------------------------------------------

struct FfnArgs {
  const float* x;          // [C]
  const float* ffn_in;     // [C]
  const int8_t* fr;        // [CL, C] form WF: the shard's gate rows (K11: none)
  const float* fr_d;       // [CL]
  const int8_t* fk;        // [FL, C] form WF
  const float* fk_d;       // [FL]
  const int8_t* fv;        // [nf, C, FT] form WF
  const float* fv_d;       // [C]
  const float* rvec;       // [kNumRVec6, C] (K11: TP_RVECS)
  float* part;             // [C] the shard's partial of fv
  float* rg;               // [CL] sigmoid(fr rows) (K11: none)
  float* ffn_out;          // [C] ln2(x)
  float* scratch;          // [FL] relu^2 keys (the timing build's stamps follow)
  int C, CL, FL, nf;
  TpLayout lo;
};

// Phase A's vector rows: K13 ln2 w, ln2 b, the FFN mixes k and r, ffn_in;
// K11 ln2 w, ln2 b, x_k, ffn_in.
__host__ __device__ inline int ffn_vec_rows(int kind) { return kind == kFfnV7 ? 4 : 5; }

// Shared memory of a K13 launch: xs, xl (C floats each), red (256), dxs
// and the block-local amax slots (kMaxTiles each), the launch's amax set
// (padded to 16 bytes), the activations (max(2C, FL) codes, or f32 in the
// bf16 form), then the plan, the mbarriers and the ring.
__host__ __device__ inline size_t ffn_act_off(int C) {
  return 4 * (2ull * C + 256 + 2 * kMaxTiles + 4);
}

// the largest piece: two vector rows, one fk / fr row or one row of an fv
// tile with its scale window
__host__ __device__ inline size_t ffn_piece(int C, int FT, int wf) {
  const size_t row = stream::max2(form_bytes(wf, C), form_bytes(wf, FT));
  return stream::max2(8ull * C, row + stream::win_bytes(1));
}

struct FfnLayout : stream::Ring {
  size_t act_off;
  int vec_rows;
  __host__ __device__ FfnLayout(int C, int FL, int nf, int wf, int kind)
      : stream::Ring(round_up(ffn_act_off(C) + (wf == kBf16 ? 4ull : 1ull) *
                                                  stream::max2(2ull * C, FL), 16),
                     ffn_piece(C, FL / nf, wf)),
        act_off(ffn_act_off(C)),
        vec_rows(vec_rows_for(stage, C, ffn_vec_rows(kind))) {}
};

enum FfnSeg {
  fVec,  // phase A's vector rows: vec_rows rows a piece
  fFk, fFr,  // K11: no fr pieces
  fFv,   // the fv rows of tile 0, then of tile 1, ...
  kFfnSegs
};

struct FfnPlan {
  Rows fk, fr, fv;  // fv: the block's rows of each tile
  int nf, vec_pieces;
  __host__ __device__ FfnPlan(const TpLayout& lo, int C, int CL, int FL, int nf_, int wf,
                              int kind, int blocks, int b) {
    const bool w = wf != kBf16;
    const int bc = static_cast<int>(form_bytes(wf, C)), ft = FL / nf_, st = static_cast<int>(lo.stage);
    fk = part(FL, blocks, b, false, bc, w, st, lanes_for(C, wf));
    fr = part(kind == kFfnV7 ? 0 : CL, blocks, b, true, bc, w, st, lanes_for(C, wf));
    fv = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, ft)), w, st,
                 lanes_for(ft, wf));
    nf = nf_;
    vec_pieces = (ffn_vec_rows(kind) + lo.vec_rows - 1) / lo.vec_rows;
  }
  __host__ __device__ int count(int seg) const {
    switch (seg) {
      case fVec: return vec_pieces;
      case fFk: return fk.pieces();
      case fFr: return fr.pieces();
      case fFv: return nf * fv.pieces();
      default: return 0;
    }
  }
  __host__ __device__ int pieces() const {
    int n = 0;
    for (int s = 0; s < kFfnSegs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(FfnPlan) <= stream::kPlanBytes, "the plan's shared bytes");

__host__ __device__ inline bool ffn_copy(const FfnArgs& p, const FfnPlan& pl, int vec_rows,
                                         int wf, int kind, int seg, int idx, int i,
                                         const void** src, uint32_t* dst, uint32_t* bytes) {
  const int C = p.C;
  const bool w = wf != kBf16;
  switch (seg) {
    case fVec: {
      // the rows of rvec (K13: RVec6's ln2 w, b, mix k, r; K11: ln2 w, b,
      // x_k), then ffn_in
      const int j = idx * vec_rows + i, n = ffn_vec_rows(kind);
      if (i >= vec_rows || j >= n) return false;
      const int vrows[4] = {kRLn2W, kRLn2B, kind == kFfnV7 ? kR7XK : kRFXK, kRFXR};
      *src = j < n - 1 ? p.rvec + vrows[j] * C : p.ffn_in;
      *dst = 4u * C * i;
      *bytes = 4u * C;
      return true;
    }
    case fFk: return rows_copy(pl.fk, p.fk, w ? p.fk_d : nullptr, idx, i, src, dst, bytes);
    case fFr: return rows_copy(pl.fr, p.fr, w ? p.fr_d : nullptr, idx, i, src, dst, bytes);
    case fFv: {
      const int np = pl.fv.pieces(), t = idx / np;
      const int8_t* tile = p.fv + form_bytes(wf, static_cast<size_t>(t) * C * (p.FL / pl.nf));
      return rows_copy(pl.fv, tile, w ? p.fv_d : nullptr, idx - t * np, i, src, dst, bytes);
    }
    default: return false;
  }
}

// The FFN kernels' published amax slots (every KIND's: one barrier word,
// g_ffn_count, for all of them): two sets of kMaxTiles. A launch publishes
// into set (barriers its kernel has crossed) & 1 -- the top bit of its
// barrier word when it starts, for each launch crosses one -- and clears
// the other set, which the launch before it used, for the next one. Every
// launch finds its set cleared, with no barrier before its first publish.
__device__ unsigned g_ffn_amax[2 * kMaxTiles];

template <int WF, int KIND>
__global__ void __launch_bounds__(kBlockThreads, 1) tp_v6_ffn_kernel(FfnArgs p) {
  unsigned long long t_entry = 0;
  ENTRY_TIME(t_entry);
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, FL = p.FL, nf = p.nf, FT = FL / nf;
  const int tid = threadIdx.x;
  const TpLayout& lo = p.lo;

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x; in B the fv partials of the block's rows
  float* xl = xs + C;                           // [C] ln2(x)
  float* red = xl + C;                          // [8][32]
  float* dxs = red + 8 * 32;                    // [kMaxTiles]
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + kMaxTiles);  // [kMaxTiles] block-local amax
  unsigned* set = amx + kMaxTiles;                                 // this launch's amax set
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(2C, FL)]
  FfnPlan* plan = reinterpret_cast<FfnPlan*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);
  uint64_t* empty = full + stream::kMaxStages;
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);
  const FfnPlan& pl = *plan;  // read by the consumers after stream_ready_wait

  if (tid >= kThreads) {
    // the producer warp
    const int vr = lo.vec_rows;
    if (tid == kThreads) {
      init_mbarriers(full, empty, stages);
      *plan = FfnPlan(lo, C, p.CL, FL, nf, WF, KIND, gridDim.x, blockIdx.x);
    }
    __syncwarp();
    stream_ready_arrive();
    stream::produce<kFfnSegs, kFfnSegs>(
        pl, 1, stages, ring, lo.stage, full, empty,
        [&](int, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return ffn_copy(p, pl, vr, WF, KIND, seg, idx, i, src, dst, bytes);
        });
    return;
  }
  // the barrier word as this launch finds it (no block of it can have
  // crossed the barrier yet); its set is written before the publication
  const unsigned word = tid == 0 ? __ldcg(&g_ffn_count) : 0u;
  if (tid < kMaxTiles) amx[tid] = 0u;  // ordered before their use by csync

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks = reinterpret_cast<unsigned long long*>(p.scratch + FL);
  int n_marks = 0;
#endif
  PHASE_ENTRY(t_entry);
  PHASE_MARK();
  stream::Stream cs{ring, lo.stage, stages, full, empty};

  // ---- A: ln2 + shift, fk rows with relu^2, fr rows with sigmoid ----------
  stream::load_vec(xs, p.x, C);
  stream::csync();
  {
    // the vector pieces (stages 0, 1, ...) land during the statistics
    const int vr = lo.vec_rows;
    auto vrow = [&](int j) {
      return reinterpret_cast<const float*>(ring + (j / vr) * lo.stage + (j % vr) * 4ull * C);
    };
    auto ready = [&]() {
      stream_ready_wait();  // the mbarriers and the plan
      for (int k = 0; k < pl.vec_pieces; ++k) cs.wait();
    };
    const float *ln_w = vrow(0), *ln_b = vrow(1), *mk = vrow(2);
    if constexpr (KIND == kFfnV7) {
      const float* fin = vrow(3);
      stream::layer_norm_act<WF, 1>(
          xs, xl, ln_w, ln_b, C, 1e-5f, red, [](int, float) {},
          [&](int, int c) { return add(xl[c], mul(sub(fin[c], xl[c]), mk[c])); }, q8, C, dxs,
          ready);
    } else {
      const float *mr = vrow(3), *fin = vrow(4);
      stream::layer_norm_act<WF, 2>(
          xs, xl, ln_w, ln_b, C, 1e-5f, red, [](int, float) {},
          [&](int m, int c) {
            const float cf = m == 0 ? mk[c] : mr[c], prev = fin[c];
            return KIND == kFfnV45 ? add(mul(xl[c], cf), sub(prev, mul(prev, cf)))
                                   : add(xl[c], mul(sub(prev, xl[c]), cf));
          },
          q8, C, dxs, ready);
    }
    cs.release(pl.vec_pieces);
  }
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += kThreads) p.ffn_out[c] = xl[c];
  cs.rows<WF>(pl.fk, C, [&](int) { return q8; },
              [&](int row, auto acc, const float* d) {
                const float y = fmaxf(dequant(acc, dxs[0], d), 0.f);
                const float v = mul(y, y);
                p.scratch[row] = v;
                if constexpr (kQuant) stream::note_amax(&amx[row / FT], v);
              });
  if constexpr (KIND != kFfnV7)
    cs.rows<WF>(pl.fr, C, [&](int) { return q8 + C; },
                [&](int row, auto acc, const float* d) {
                  p.rg[row] = sigmoidf(dequant(acc, dxs[1], d));
                });
  if (tid == 0) *set = word >> 31;
  stream::csync();
  unsigned* amax_g = g_ffn_amax + *set * kMaxTiles;
  if (blockIdx.x == 0 && tid < kMaxTiles) g_ffn_amax[(*set ^ 1u) * kMaxTiles + tid] = 0u;
  if constexpr (kQuant) {  // the tiles' amax
    if (tid < nf) {
      const unsigned v = amx[tid];
      if (v != 0u) atomicMax(amax_g + tid, v);
    }
  }
  PHASE_MARK();
  stream::csync();
  if (tid == 0) stream::grid_sync(&g_ffn_count, gridDim.x);
  stream::csync();
  PHASE_MARK();

  // ---- B: each tile's keys quantized, its fv rows into the partial --------
  if (nf == 2) {  // the 1.5B / 1.6B widths at tp=2: both tiles in one pass
    stream::act_published<WF, 2>(p.scratch, FT, q8, dxs, amax_g);
  } else {
    for (int t = 0; t < nf; ++t)
      stream::act_published<WF, 1>(p.scratch + t * FT, FT, q8 + t * FT, dxs + t, amax_g + t);
  }
  const int r0 = pl.fv.r0;
  for (int t = 0; t < nf; ++t) {
    // a row's lane group is the same in every tile (the same rows a piece),
    // so the thread that sums tile t - 1 into xs sums tile t onto it
    cs.rows<WF>(pl.fv, FT, [&](int) { return q8 + t * FT; },
                [&](int row, auto acc, const float* d) {
                  const float y = dequant(acc, dxs[t], d);
                  const float v = t == 0 ? y : add(xs[row - r0], y);
                  if (t + 1 < nf) {
                    xs[row - r0] = v;
                  } else {
                    p.part[row] = v;
                  }
                });
  }
  PHASE_MARK();
}

// ---- launches ----------------------------------------------------------------

template <int WF>
const void* att_of(int kind) {
  if (kind == kAttV6) return reinterpret_cast<const void*>(tp_v6_att_kernel<WF, kAttV6>);
  return kind == kAttV51 ? reinterpret_cast<const void*>(tp_v6_att_kernel<WF, kAttV51>)
                         : reinterpret_cast<const void*>(tp_v6_att_kernel<WF, kAttV52>);
}

// K12 (kind kAttV6) or K15 (kAttV51, kAttV52)
const void* att_kernel(int wf, int kind) {
  if (wf == kBf16) return att_of<kBf16>(kind);
  return wf == kInt4 ? att_of<kInt4>(kind) : att_of<kInt8>(kind);
}

template <int WF>
const void* ffn_of(int kind) {
  if (kind == kFfnV6) return reinterpret_cast<const void*>(tp_v6_ffn_kernel<WF, kFfnV6>);
  return kind == kFfnV45 ? reinterpret_cast<const void*>(tp_v6_ffn_kernel<WF, kFfnV45>)
                         : reinterpret_cast<const void*>(tp_v6_ffn_kernel<WF, kFfnV7>);
}

// K13 (kind kFfnV6), its MIX45 form the v4 / v5 TP paths take (kFfnV45:
// their replicated block holds ln2 and the FFN mixes at RVec6's rows), or
// K11 (kFfnV7)
const void* ffn_kernel(int wf, int kind) {
  if (wf == kBf16) return ffn_of<kBf16>(kind);
  return wf == kInt4 ? ffn_of<kInt4>(kind) : ffn_of<kInt8>(kind);
}

// Why K12 / K15 cannot run these shapes (a CUDA error code), or 0.
int att_shape_error(int wf, int kind, int C, int CL, int S, int DM, int DD) {
  if (kind < kAttV6 || kind > kAttV52 || S <= 0 || S % 4 != 0 || kThreads % S != 0 ||
      S * S / kThreads > kMaxJ || CL % S != 0 || DM % 4 != 0 || C % 16 != 0 || CL % 16 != 0 ||
      DD % 16 != 0 || CL > C || (kind != kAttV6 && (DM != 0 || DD != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AttLayout lo(C, CL, S, DM, DD, wf, kind);
  if (static_cast<int>(lo.stages) < stream::kMinStages || lo.vec_rows < 2 ||
      (att_vec_rows(kind) + lo.vec_rows - 1) / lo.vec_rows > static_cast<int>(lo.stages))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Why K13 / K11 cannot run these shapes (a CUDA error code), or 0.
int ffn_shape_error(int wf, int kind, int C, int CL, int FL, int nf) {
  if (nf <= 0 || nf > kMaxTiles || FL % nf != 0 || C % 16 != 0 || CL % 4 != 0 ||
      (FL / nf) % 16 != 0 || CL > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const FfnLayout lo(C, FL, nf, wf, kind);
  if (static_cast<int>(lo.stages) < stream::kMinStages || lo.vec_rows < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int att_launch(int wf, int kind, const void* x, const void* att_in, const void* heads_in,
               const void* rkvg, const void* rkvg_d, const void* maa1, const void* maa1_d,
               const void* dw1, const void* dw1_d, const void* dw2, const void* dw2_d,
               const void* out, const void* out_d, const void* maa2, const void* rvec,
               const void* lvec, void* part, void* att_out, void* heads_out, void* scratch, int C,
               int CL, int S, int DM, int DD, int grid_blocks, void* stream) {
  const int bad = att_shape_error(wf, kind, C, CL, S, DM, DD);
  if (bad != 0) return bad;
  if (grid_blocks <= 0 || !stream::part_fits(5ll * C, grid_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({x, att_in, heads_in, rkvg, rkvg_d, maa1, maa1_d, dw1, dw1_d, dw2, dw2_d, out,
                  out_d, maa2, rvec, lvec, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  AttArgs a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.rkvg = static_cast<const int8_t*>(rkvg);
  a.rkvg_d = static_cast<const float*>(rkvg_d);
  a.maa1 = static_cast<const int8_t*>(maa1);
  a.maa1_d = static_cast<const float*>(maa1_d);
  a.dw1 = static_cast<const int8_t*>(dw1);
  a.dw1_d = static_cast<const float*>(dw1_d);
  a.dw2 = static_cast<const int8_t*>(dw2);
  a.dw2_d = static_cast<const float*>(dw2_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.maa2 = static_cast<const float*>(maa2);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.S = S; a.DM = DM; a.DD = DD;
  a.lo = tp_layout(AttLayout(C, CL, S, DM, DD, wf, kind));
  return tp_launch_of(att_kernel(wf, kind), a, a.lo.smem, grid_blocks, kBlockThreads, stream);
}

int ffn_launch(int wf, int kind, const void* x, const void* ffn_in, const void* fr,
               const void* fr_d, const void* fk, const void* fk_d, const void* fv,
               const void* fv_d, const void* rvec, void* part, void* rg, void* ffn_out,
               void* scratch, int C, int CL, int FL, int nf, int grid_blocks, void* stream) {
  const int bad = ffn_shape_error(wf, kind, C, CL, FL, nf);
  if (bad != 0) return bad;
  if (grid_blocks <= 0 || !stream::part_fits(FL > C ? FL : C, grid_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({x, ffn_in, fr, fr_d, fk, fk_d, fv, fv_d, rvec, scratch}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  FfnArgs a;
  a.x = static_cast<const float*>(x);
  a.ffn_in = static_cast<const float*>(ffn_in);
  a.fr = static_cast<const int8_t*>(fr);
  a.fr_d = static_cast<const float*>(fr_d);
  a.fk = static_cast<const int8_t*>(fk);
  a.fk_d = static_cast<const float*>(fk_d);
  a.fv = static_cast<const int8_t*>(fv);
  a.fv_d = static_cast<const float*>(fv_d);
  a.rvec = static_cast<const float*>(rvec);
  a.part = static_cast<float*>(part);
  a.rg = static_cast<float*>(rg);
  a.ffn_out = static_cast<float*>(ffn_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.FL = FL; a.nf = nf;
  a.lo = tp_layout(FfnLayout(C, FL, nf, wf, kind));
  return tp_launch_of(ffn_kernel(wf, kind), a, a.lo.smem, grid_blocks, kBlockThreads, stream);
}

}  // namespace

// The stream plan of K12, K13, K15 or K11 in form wf (0 int8, 1 int4, 2
// bf16) as the kernels compute it, for ops/megakernel_tp.py::
// tp_v6_stream_plan to be held to: kind 0 K12 (C, CL, S, DM, DD), 1 K13
// (C, CL, FL, nf; either of its forms: the same plan), 2 K15 on v5.1 and 3
// on v5.2 (C, CL, S), 4 K11 (C, FL, nf). out[0] the launch's dynamic
// shared bytes, out[1] a stage's bytes, out[2] the stages, out[3] block
// `block`'s pieces of a grid of `blocks`, out[4] the kernel's static
// shared bytes, out[5] the vector rows a piece. Returns a CUDA error code
// (0: none).
extern "C" int rwkv_tp_v6_plan(int wf, int kind, int C, int CL, int FL, int nf, int S, int DM,
                               int DD, int blocks, int block, long long* out) {
  if (wf < kInt8 || wf > kBf16 || kind < 0 || kind > 4 || blocks <= 0 || block < 0 ||
      block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ffn = kind == 1 || kind == 4;
  const int att = kind == 0 ? kAttV6 : kind == 2 ? kAttV51 : kAttV52;
  const int fk = kind == 4 ? kFfnV7 : kFfnV6;
  const int bad = ffn ? ffn_shape_error(wf, fk, C, CL, FL, nf)
                      : att_shape_error(wf, att, C, CL, S, DM, DD);
  if (bad != 0) return bad;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, ffn ? ffn_kernel(wf, fk) : att_kernel(wf, att));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ffn) {
    const TpLayout lo = tp_layout(AttLayout(C, CL, S, DM, DD, wf, att));
    const AttPlan pl(lo, C, CL, S, DM, DD, wf, att, blocks, block);
    out[0] = static_cast<long long>(lo.smem);
    out[1] = static_cast<long long>(lo.stage);
    out[2] = static_cast<long long>(lo.stages);
    out[3] = pl.pieces();
    out[5] = lo.vec_rows;
  } else {
    const TpLayout lo = tp_layout(FfnLayout(C, FL, nf, wf, fk));
    const FfnPlan pl(lo, C, CL, FL, nf, wf, fk, blocks, block);
    out[0] = static_cast<long long>(lo.smem);
    out[1] = static_cast<long long>(lo.stage);
    out[2] = static_cast<long long>(lo.stages);
    out[3] = pl.pieces();
    out[5] = lo.vec_rows;
  }
  out[4] = static_cast<long long>(attr.sharedSizeBytes);
  return 0;
}

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code) and one launch, of
// K12, K13, K13's MIX45 form (rwkv_tp_v45_ffn*, the v4 / v5 FFN), K15
// (rwkv_tp_v5_att*; gate 0 on v5.1, 1 on v5.2) and K11 (rwkv_tp_v7_ffn*).
// The bf16 ones read no scales (pass null). Every pointer but the outputs'
// must be 16-byte aligned.
#define RWKV_TP_V6_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *heads_in, const void *rkvg,                    \
      const void *rkvg_d, const void *maa1, const void *maa1_d, const void *dw1,                \
      const void *dw1_d, const void *dw2, const void *dw2_d, const void *out,                   \
      const void *out_d, const void *maa2, const void *rvec, const void *lvec, void *part,      \
      void *att_out, void *heads_out, void *scratch, int C, int CL, int S, int DM, int DD,      \
      int grid_blocks, void *stream
#define RWKV_TP_V6_ATT_ARGS                                                                     \
  x, att_in, heads_in, rkvg, rkvg_d, maa1, maa1_d, dw1, dw1_d, dw2, dw2_d, out, out_d, maa2,    \
      rvec, lvec, part, att_out, heads_out, scratch, C, CL, S, DM, DD, grid_blocks, stream
#define RWKV_TP_V6_FFN_PARAMS                                                                   \
  const void *x, const void *ffn_in, const void *fr, const void *fr_d, const void *fk,          \
      const void *fk_d, const void *fv, const void *fv_d, const void *rvec, void *part,         \
      void *rg, void *ffn_out, void *scratch, int C, int CL, int FL, int nf, int grid_blocks,   \
      void *stream
#define RWKV_TP_V6_FFN_ARGS                                                                     \
  x, ffn_in, fr, fr_d, fk, fk_d, fv, fv_d, rvec, part, rg, ffn_out, scratch, C, CL, FL, nf,    \
      grid_blocks, stream
// The grid entries take the widths that set the launch's shared memory:
// K12 (C, CL, S, DM, DD), K13 and K11 (C, FL, nf), K15 (C, CL, S, gate).
#define RWKV_TP_V7_FFN_PARAMS                                                                   \
  const void *x, const void *ffn_in, const void *fk, const void *fk_d, const void *fv,          \
      const void *fv_d, const void *rvec, void *part, void *ffn_out, void *scratch, int C,      \
      int FL, int nf, int grid_blocks, void *stream
#define RWKV_TP_V5_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *heads_in, const void *rkvg,                    \
      const void *rkvg_d, const void *out, const void *out_d, const void *rvec,                 \
      const void *lvec, void *part, void *att_out, void *heads_out, void *scratch, int C,       \
      int CL, int S, int gate, int grid_blocks, void *stream
#define RWKV_TP_V6_ENTRIES(suffix, wf)                                                          \
  extern "C" int rwkv_tp_v6_att##suffix##_grid(int C, int CL, int S, int DM, int DD) {         \
    return tp_grid_blocks_of(att_kernel(wf, kAttV6),                                          \
                             AttLayout(C, CL, S, DM, DD, wf, kAttV6).smem, kBlockThreads);      \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_att##suffix(RWKV_TP_V6_ATT_PARAMS) {                               \
    return att_launch(wf, kAttV6, RWKV_TP_V6_ATT_ARGS);                                         \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_ffn##suffix##_grid(int C, int FL, int nf) {                        \
    return tp_grid_blocks_of(ffn_kernel(wf, kFfnV6), FfnLayout(C, FL, nf, wf, kFfnV6).smem,    \
                             kBlockThreads);                                                    \
  }                                                                                             \
  extern "C" int rwkv_tp_v6_ffn##suffix(RWKV_TP_V6_FFN_PARAMS) {                               \
    return ffn_launch(wf, kFfnV6, RWKV_TP_V6_FFN_ARGS);                                         \
  }                                                                                             \
  extern "C" int rwkv_tp_v45_ffn##suffix##_grid(int C, int FL, int nf) {                       \
    return tp_grid_blocks_of(ffn_kernel(wf, kFfnV45), FfnLayout(C, FL, nf, wf, kFfnV45).smem,  \
                             kBlockThreads);                                                    \
  }                                                                                             \
  extern "C" int rwkv_tp_v45_ffn##suffix(RWKV_TP_V6_FFN_PARAMS) {                              \
    return ffn_launch(wf, kFfnV45, RWKV_TP_V6_FFN_ARGS);                                        \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_ffn##suffix##_grid(int C, int FL, int nf) {                        \
    return tp_grid_blocks_of(ffn_kernel(wf, kFfnV7), FfnLayout(C, FL, nf, wf, kFfnV7).smem,    \
                             kBlockThreads);                                                    \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_ffn##suffix(RWKV_TP_V7_FFN_PARAMS) {                               \
    return ffn_launch(wf, kFfnV7, x, ffn_in, nullptr, nullptr, fk, fk_d, fv, fv_d, rvec, part,  \
                      nullptr, ffn_out, scratch, C, 0, FL, nf, grid_blocks, stream);            \
  }                                                                                             \
  extern "C" int rwkv_tp_v5_att##suffix##_grid(int C, int CL, int S, int gate) {               \
    const int kind = gate ? kAttV52 : kAttV51;                                                  \
    return tp_grid_blocks_of(att_kernel(wf, kind), AttLayout(C, CL, S, 0, 0, wf, kind).smem,   \
                             kBlockThreads);                                                    \
  }                                                                                             \
  extern "C" int rwkv_tp_v5_att##suffix(RWKV_TP_V5_ATT_PARAMS) {                               \
    return att_launch(wf, gate ? kAttV52 : kAttV51, x, att_in, heads_in, rkvg, rkvg_d, nullptr, \
                      nullptr, nullptr, nullptr, nullptr, nullptr, out, out_d, nullptr, rvec,   \
                      lvec, part, att_out, heads_out, scratch, C, CL, S, 0, 0, grid_blocks,     \
                      stream);                                                                  \
  }

RWKV_TP_V6_ENTRIES(, kInt8)
RWKV_TP_V6_ENTRIES(_w4, kInt4)
RWKV_TP_V6_ENTRIES(_bf16, kBf16)
