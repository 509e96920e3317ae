// K10: the attention of one layer of an RWKV v7 decode step at B=1 on one
// shard of a tensor-parallel mesh, w8a8, w4a8 or bf16. One launch per
// shard per layer; the caller sums the shards' full-C partials (all_reduce
// in ops/megakernel_tp.py), then runs the FFN (K11, a form of K13's kernel
// in tp_v6.cu).
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call (kernel
// _make_att_kernel), in its int8 (w8a8), int4 (w4a8: matv4) and bf16
// (quant=False) forms.
//
// Bound on this card: bytes. At the World 1.5B v7 width (C=2048, d_lora
// 96) and tp=2 a launch reads its shard's rkv rows (3 x 1024 x 2048), the
// whole lora1 (4 x 96 x 2048: replicated, so every shard reads it), its
// lora2 rows and out columns (2048 x 1024), ~9.2 MB int8, and the shard's
// wkv state (16 heads, 0.26 MB) twice: ~3 us at 3.35 TB/s; the int4 form
// halves the big matrices, the bf16 form doubles every matrix.
//
// Design: K3's phases (v7_decode.cu) for one layer and one shard, on the
// shared input stream (decode_stream.cuh, tp_stream.cuh): a persistent
// cooperative kernel, one block per SM, each block eight consumer warps and
// one producer warp.
//   A  ln1 + six-way token-shift mix of the replicated x, the six mixes
//      quantized as whole vectors (every block; their amax folded into the
//      layer norm's last pass), the shard's rkv rows (3 C/tp) and the whole
//      lora1 (4 d_lora rows)
//   B  per head of the shard (one block each): K3's streamed head step
//      (v7_stream.cuh) on the shard's channels -- lora2 rows, kk, value
//      residual (v_first written when `first`, read otherwise), wkv7,
//      group norm, r_k bonus, gate
//   C  the shard's xo quantized with its own scale, the C rows of out
//      [C, C/tp] into the partial
// Every input that does not depend on another block -- phase A's vector
// rows and att_in, the weight rows with their row scales, a head's state
// with its vector slices (and v_first, which an earlier launch wrote) and
// its lora2 rows -- reaches shared memory through the block's ring of
// stages, fed by the producer warp with bulk asynchronous copies in the
// order the consumers take them (AttLayout / AttPlan / att_copy;
// ops/megakernel_tp.py::tp_v6_stream_plan, kind "att7", mirrors it). The
// host computes the layout, the producer the block's plan while the
// consumers take x's statistics (K12's start, tp_stream.cuh). Each row is
// summed with the lanes, the chunk order and the shuffle tree that
// matvec_rows (common.cuh) gave it in the earlier K10, so the outputs are
// that kernel's bit for bit on any grid. Phase B quantizes the four lora
// downs and C the shard's xo in one pass from an amax the producing phase
// published with atomicMax (exact in any order).
//
// Numerics follow the JAX kernel (explicit round-to-nearest float ops,
// IEEE division in the activation scale): each matvec input is quantized
// as a whole, and the out input is the shard's local slice with its own
// scale, as the TP kernels do (and the single-device ones do not). The
// bf16 form stages f32 activations and reads no scales.
#include "v7_stream.cuh"
#include "tp_stream.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

// rows of a shard's replicated vector block [L, kNumRVec7, C] and of its
// own [L, kNumLVec7, C/tp] (ops/megakernel_tp.py TP_RVECS, TP_LVECS; K11
// reads ln2 and x_k at rows 2-4)
enum RVec7 { kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRXK, kRCoeff, kNumRVec7 = kRCoeff + 6 };
enum LVec7 { kLW0 = 0, kLA0, kLV0, kLKK, kLKA, kLLnxW, kLLnxB, kLRK, kNumLVec7 };

using stream::Rows;
using stream::max2;
using stream::part;
using stream::round_up;

// ---- K10 --------------------------------------------------------------------

struct AttArgs {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* heads_in;   // [HL, S, S] the shard's heads
  float* vf;               // [CL] v_first: written when first, read otherwise
  const int8_t* rkv;       // [3, CL, C] form WF
  const float* rkv_d;      // [3 CL] (int forms)
  const int8_t* lora1;     // [4D, C] int8 (bf16)
  const float* lora1_d;    // [4D]
  const int8_t* lora2;     // [4, CL, D] int8 (bf16)
  const float* lora2_d;    // [4 CL]
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* rvec;       // [kNumRVec7, C]
  const float* lvec;       // [kNumLVec7, CL]
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x), the new att_xx
  float* heads_out;        // [HL, S, S]
  float* scratch;          // att_scratch_floats(CL, D)
  int C, CL, S, D, first;
  TpLayout lo;
};

constexpr int kAttVecRows = 9;  // phase A's: ln1 w, ln1 b, the six coefficient rows, att_in
constexpr int kHvFloats = 10;   // per-head vectors in shared memory, S floats each
constexpr int kAttAmx = 8;      // block-local amax slots: the four lora downs, then xo
constexpr int kAttAmax = 4;     // published slots behind the scratch: xo (then padding)

// Floats of K10's global scratch: r | k | v (3 CL), the four lora downs
// (4D), xo (CL), then xo's published amax (kAttAmax slots; the kernel
// clears them); the timing build's stamps follow.
__host__ __device__ inline size_t att_scratch_floats(int CL, int D) {
  return 4ull * CL + 4ull * D + kAttAmax;
}

// Shared memory of a K10 launch: xs, xl (C floats each), hv (10 S), red
// (256), dxs (8), the block-local amax slots, the activations (int8
// codes, or f32 in the bf16 form; max(6C, 4D) of them), then the block's
// plan, its mbarriers and the ring.
__host__ __device__ inline size_t att_act_off(int C, int S) {
  return round_up(4 * (2ull * C + static_cast<size_t>(kHvFloats) * S + 256 + 8 + kAttAmx), 16);
}

// Bytes of one run of a head's lora2 rows (S rows of width D) with, in the
// int forms, their S row scales.
__host__ __device__ inline size_t lora2_run(int S, int D, int wf) {
  return static_cast<size_t>(S) * form_bytes(small_form(wf), D) + (wf == kBf16 ? 0 : 4ull * S);
}

// the largest piece: two vector rows, a head's state with its eight vector
// slices and v_first, one run of its lora2 rows, one row of any matrix
// with its scale window
__host__ __device__ inline size_t att_piece(int C, int CL, int S, int D, int wf) {
  const int sf = small_form(wf);
  size_t piece = max2(8ull * C, 4ull * S * S + 4ull * (kNumLVec7 + 1) * S);
  piece = max2(piece, lora2_run(S, D, wf));
  size_t row = max2(form_bytes(wf, C), form_bytes(wf, CL));
  row = max2(row, form_bytes(sf, C));
  return max2(piece, row + stream::win_bytes(1));
}

struct AttLayout : stream::Ring {
  size_t act_off;
  int vec_rows;  // vector rows a piece
  int l2_runs;   // runs of a head's lora2 rows a piece (of the four)
  __host__ __device__ AttLayout(int C, int CL, int S, int D, int wf)
      : stream::Ring(round_up(att_act_off(C, S) + (wf == kBf16 ? 4 : 1) * max2(6ull * C, 4ull * D),
                              16),
                     att_piece(C, CL, S, D, wf)),
        act_off(att_act_off(C, S)),
        vec_rows(vec_rows_for(stage, C, kAttVecRows)) {
    const size_t r = stage / lora2_run(S, D, wf);
    l2_runs = r < 4 ? static_cast<int>(r) : 4;
  }
};

TpLayout att_tp_layout(int C, int CL, int S, int D, int wf) {
  const AttLayout lo(C, CL, S, D, wf);
  TpLayout t = tp_layout(lo);
  t.l2_runs = lo.l2_runs;
  return t;
}

// K10's pieces in stream order; a segment is a run of pieces.
enum AttSeg {
  aVec,    // ln1 w, ln1 b, the six coefficient rows, att_in: vec_rows rows a piece
  aRkv,    // the fused r, k, v rows of the shard
  aL1,     // the lora1 rows (w, a, g, v downs)
  aHeads,  // per head of the block: its state with its vector slices (and
           // v_first), then its lora2 rows, l2_runs runs of S rows a piece
  aOut,
  kAttSegs
};

__host__ __device__ inline int run_pieces(int n, int per) { return (n + per - 1) / per; }

// Block b's share of every phase.
struct AttPlan {
  Rows rkv, l1, out;
  int heads, vec_pieces, head_pieces;  // head_pieces: a head's pieces
  __host__ __device__ AttPlan(const TpLayout& lo, int C, int CL, int S, int D, int wf,
                              int blocks, int b) {
    const int sf = small_form(wf), st = static_cast<int>(lo.stage);
    const bool w = wf != kBf16;
    // the lanes the grid-wide matvec gave each matrix's rows in the earlier K10
    rkv = part(3 * CL, blocks, b, false, static_cast<int>(form_bytes(wf, C)), w, st,
               lanes_for(C, wf));
    l1 = part(4 * D, blocks, b, true, static_cast<int>(form_bytes(sf, C)), w, st, 32);
    out = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, CL)), w, st,
               lanes_for(CL, wf));
    const int hl = CL / S;
    heads = b < hl ? (hl - b + blocks - 1) / blocks : 0;
    vec_pieces = run_pieces(kAttVecRows, lo.vec_rows);
    head_pieces = 1 + run_pieces(4, lo.l2_runs);
  }
  __host__ __device__ int count(int seg) const {
    switch (seg) {
      case aVec: return vec_pieces;
      case aRkv: return rkv.pieces();
      case aL1: return l1.pieces();
      case aHeads: return heads * head_pieces;
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

// Copy i of piece idx of segment seg for block b of a grid of `blocks`: a
// 16-byte multiple from a 16-byte aligned src into the stage at offset dst.
// Returns false past the piece's last copy.
__host__ __device__ inline bool att_copy(const AttArgs& p, const AttPlan& pl, int vec_rows,
                                         int l2_runs, int wf, int b, int blocks, int seg, int idx,
                                         int i, const void** src, uint32_t* dst,
                                         uint32_t* bytes) {
  const int C = p.C, CL = p.CL, S = p.S;
  const bool w = wf != kBf16;
  auto put = [&](const void* s_, uint32_t d_, uint32_t n_) {
    *src = s_;
    *dst = d_;
    *bytes = n_;
    return true;
  };
  switch (seg) {
    case aVec: {
      const int j = idx * vec_rows + i;
      if (i >= vec_rows || j >= kAttVecRows) return false;
      const float* row = j < 2   ? p.rvec + (kRLn1W + j) * C
                         : j < 8 ? p.rvec + (kRCoeff + j - 2) * C
                                 : p.att_in;
      return put(row, 4u * C * i, 4u * C);
    }
    case aRkv: return rows_copy(pl.rkv, p.rkv, w ? p.rkv_d : nullptr, idx, i, src, dst, bytes);
    case aL1: return rows_copy(pl.l1, p.lora1, w ? p.lora1_d : nullptr, idx, i, src, dst, bytes);
    case aHeads: {
      const int h = b + (idx / pl.head_pieces) * blocks, k = idx % pl.head_pieces;
      if (k == 0) {
        // the state [S, S], then the head's slices of the lvec rows (w0, a0,
        // v0, kk, ka, ln_x w, ln_x b, r_k), then its v_first where read
        if (i == 0) return put(p.heads_in + static_cast<size_t>(h) * S * S, 0u, 4u * S * S);
        if (i <= kNumLVec7)
          return put(p.lvec + (i - 1) * CL + h * S, 4u * S * S + 4u * S * (i - 1), 4u * S);
        return i == kNumLVec7 + 1 && p.first == 0 &&
               put(p.vf + h * S, 4u * S * S + 4u * S * kNumLVec7, 4u * S);
      }
      // runs q0 .. q1 - 1 of the lora2 rows (run q: rows q CL + h S + [0, S),
      // width D), then their row scales
      const int q0 = (k - 1) * l2_runs;
      const int q1 = q0 + l2_runs < 4 ? q0 + l2_runs : 4;
      const uint32_t rb = static_cast<uint32_t>(form_bytes(small_form(wf), p.D));
      const int q = q0 + i;
      if (q < q1)
        return put(p.lora2 + (static_cast<size_t>(q) * CL + h * S) * rb, S * rb * i, S * rb);
      const int j = q - q1;
      return w && j < q1 - q0 &&
             put(p.lora2_d + static_cast<size_t>(q0 + j) * CL + h * S,
                 S * rb * (q1 - q0) + 4u * S * j, 4u * S);
    }
    case aOut: return rows_copy(pl.out, p.out, w ? p.out_d : nullptr, idx, i, src, dst, bytes);
    default: return false;
  }
}

// The grid barrier's word (stream::grid_sync), safe while the launches on
// the card run one after another, as every TP launch does (the device's
// current stream, ops/megakernel_tp.py).
__device__ unsigned g_att_count = 0;
// The four lora downs' amax slots: phase A publishes them before the
// launch's first grid barrier, so they cannot be in the scratch (which
// block 0 clears before that barrier); block 0 clears them again in phase
// C, once every block's phase B has read them, for the next launch.
__device__ unsigned g_dn_amax[4] = {0u, 0u, 0u, 0u};

template <int WF>
__global__ void __launch_bounds__(kBlockThreads, 1) tp_v7_att_kernel(AttArgs p) {
  unsigned long long t_entry = 0;
  ENTRY_TIME(t_entry);
  constexpr int LF = small_form(WF);  // the LoRAs' form
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, CL = p.CL, S = p.S, D = p.D;
  const int tid = threadIdx.x;
  const TpLayout& lo = p.lo;

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x
  float* xl = xs + C;                           // [C] ln1(x)
  float* hv = xl + C;                           // [10 S] per-head vectors
  float* red = hv + kHvFloats * S;              // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  unsigned* amx = reinterpret_cast<unsigned*>(dxs + 8);  // [kAttAmx] block-local amax
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [max(6C, 4D)]
  AttPlan* plan = reinterpret_cast<AttPlan*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);
  uint64_t* empty = full + stream::kMaxStages;
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);
  const AttPlan& pl = *plan;  // read by the consumers after stream_ready_wait

  if (tid >= kThreads) {
    // the producer warp
    const int b = blockIdx.x, blocks = gridDim.x, vr = lo.vec_rows, l2 = lo.l2_runs;
    if (tid == kThreads) {
      init_mbarriers(full, empty, stages);
      *plan = AttPlan(lo, C, CL, S, D, WF, blocks, b);
    }
    __syncwarp();
    stream_ready_arrive();
    stream::produce<kAttSegs, kAttSegs>(
        pl, 1, stages, ring, lo.stage, full, empty,
        [&](int, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return att_copy(p, pl, vr, l2, WF, b, blocks, seg, idx, i, src, dst, bytes);
        });
    return;
  }
  if (tid < kAttAmx) amx[tid] = 0u;  // ordered before their use by csync

  float* r_g = p.scratch;      // [3][CL] r, k, v
  float* dn_g = r_g + 3 * CL;  // [4D] tanh(w), a, sigmoid(g), v downs
  float* xo_g = dn_g + 4 * D;  // [CL]
  unsigned* amax_g = reinterpret_cast<unsigned*>(xo_g + CL);  // [kAttAmax] xo's

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + att_scratch_floats(CL, D));
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
  stream::Stream cs{ring, lo.stage, stages, full, empty};
  // the part of row `row` of a fused matrix of 3 (rkv) or 4 (lora1) parts
  // of n rows each (comparisons: a division by a runtime n costs ~20
  // instructions)
  auto part3 = [](int row, int n) { return (row >= n) + (row >= 2 * n); };
  auto part4 = [](int row, int n) { return (row >= n) + (row >= 2 * n) + (row >= 3 * n); };

  // ---- A: ln1, shift mixes, rkv rows and lora1 rows ----------------------
  stream::load_vec(xs, p.x, C);
  if (blockIdx.x == 0 && tid < kAttAmax) amax_g[tid] = 0u;  // published from B on
  stream::csync();
  {
    // the vector pieces are the stream's first, in stages 0, 1, ...; the
    // layer norm's statistics need only x, so they run while they land
    const int vr = lo.vec_rows;
    auto vrow = [&](int j) {
      return reinterpret_cast<const float*>(ring + (j / vr) * lo.stage + (j % vr) * 4ull * C);
    };
    const float* cf[6];  // the mixes r, w, k, v, a, g: xl + (att_in - xl) * coeff
#pragma unroll
    for (int m = 0; m < 6; ++m) cf[m] = vrow(2 + m);
    const float* ai = vrow(8);
    stream::layer_norm_act<WF, 6>(
        xs, xl, vrow(0), vrow(1), C, 1e-5f, red, [](int, float) {},
        [&](int m, int c) { return add(xl[c], mul(sub(ai[c], xl[c]), cf[m][c])); }, q8, C, dxs,
        [&]() {
          stream_ready_wait();  // the mbarriers and the plan
          for (int k = 0; k < pl.vec_pieces; ++k) cs.wait();
        });
    cs.release(pl.vec_pieces);
  }
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += kThreads) p.att_out[c] = xl[c];
  // rkv rows take mixes r(0), k(2), v(3); lora1 rows w(1), a(4), g(5), v(3)
  cs.rows<WF>(pl.rkv, C, [&](int row) { return q8 + rkv_mix(part3(row, CL)) * C; },
              [&](int row, auto acc, const float* d) {
                r_g[row] = dequant(acc, dxs[rkv_mix(part3(row, CL))], d);
              });
  cs.rows<LF>(pl.l1, C, [&](int row) { return q8 + lora1_mix(part4(row, D)) * C; },
              [&](int row, auto acc, const float* d) {
                const int part = part4(row, D);
                float y = dequant(acc, dxs[lora1_mix(part)], d);
                if (part == 0) y = tanhf(y);
                if (part == 2) y = sigmoidf(y);
                dn_g[row] = y;
                if constexpr (kQuant) stream::note_amax(&amx[part], y);
              });
  if constexpr (kQuant) stream::publish_amax<4>(amx, g_dn_amax);
  barrier();

  // ---- B: the shard's heads ------------------------------------------------
  {
    // a head's r, k, v, loaded ahead of their use
    float hr = 0.f, hk = 0.f, hvv = 0.f;
    auto fetch_head = [&](int h) {
      if (tid < S) {
        const int c = h * S + tid;
        hr = __ldcg(r_g + c);
        hk = __ldcg(r_g + CL + c);
        hvv = __ldcg(r_g + 2 * CL + c);
      }
    };
    if (pl.heads > 0) {
      fetch_head(blockIdx.x);
      stream::act_published<LF, 4>(dn_g, D, q8, dxs, g_dn_amax);
    }
    const bool first = p.first != 0;
    for (int j = 0; j < pl.heads; ++j) {  // block-uniform
      const int h = blockIdx.x + j * gridDim.x;
      stream::v7_stream_head<LF>(
          cs, lo.l2_runs, S, D, hr, hk, hvv, 0.f, first, !first,
          [&](int i) { return p.heads_out + (static_cast<size_t>(h) * S + i) * S; },
          [&](float v) { p.vf[h * S + tid] = v; },
          [&](float v) {
            xo_g[h * S + tid] = v;
            if constexpr (kQuant) stream::note_amax(&amx[4], v);
          },
          hv, red, dxs, q8, [&]() {
            if (j + 1 < pl.heads) fetch_head(h + gridDim.x);
          });
    }
  }
  if constexpr (kQuant) stream::publish_amax<1>(amx + 4, amax_g);
  barrier();

  // ---- C: the shard's xo quantized, the C rows of out into the partial ----
  if (blockIdx.x == 0 && tid < 4) g_dn_amax[tid] = 0u;  // read by B, behind us
  stream::act_published<WF, 1>(xo_g, CL, q8, dxs, amax_g);
  cs.rows<WF>(pl.out, CL, [&](int) { return q8; },
              [&](int row, auto acc, const float* d) { p.part[row] = dequant(acc, dxs[0], d); });
  PHASE_MARK();
}

// ---- launches ----------------------------------------------------------------

const void* att_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v7_att_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v7_att_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v7_att_kernel<kInt8>);
}

// Why K10 cannot run these shapes (a CUDA error code), or 0.
int att_shape_error(int wf, int C, int CL, int S, int D) {
  if (S <= 0 || S % 4 != 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ || CL % S != 0 ||
      C % 16 != 0 || CL % 16 != 0 || D <= 0 || D % 16 != 0 || CL > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttLayout lo(C, CL, S, D, wf);
  const int stages = static_cast<int>(lo.stages);
  if (stages < stream::kMinStages || lo.vec_rows < 2 ||
      run_pieces(kAttVecRows, lo.vec_rows) > stages || lo.l2_runs < 1 ||
      1 + run_pieces(4, lo.l2_runs) > stages)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int att_launch(int wf, const void* x, const void* att_in, const void* heads_in, void* vf,
               const void* rkv, const void* rkv_d, const void* lora1, const void* lora1_d,
               const void* lora2, const void* lora2_d, const void* out, const void* out_d,
               const void* rvec, const void* lvec, void* part, void* att_out, void* heads_out,
               void* scratch, int C, int CL, int S, int D, int first, int grid_blocks,
               void* stream) {
  const int bad = att_shape_error(wf, C, CL, S, D);
  if (bad != 0) return bad;
  const long long rows = 3ll * CL > 4ll * D ? 3ll * CL : 4ll * D;
  if (grid_blocks <= 0 || !stream::part_fits(rows > C ? rows : C, grid_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({x, att_in, heads_in, rkv, rkv_d, lora1, lora1_d, lora2, lora2_d, out, out_d,
                  rvec, lvec, scratch, first ? nullptr : vf}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  AttArgs a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.heads_in = static_cast<const float*>(heads_in);
  a.vf = static_cast<float*>(vf);
  a.rkv = static_cast<const int8_t*>(rkv);
  a.rkv_d = static_cast<const float*>(rkv_d);
  a.lora1 = static_cast<const int8_t*>(lora1);
  a.lora1_d = static_cast<const float*>(lora1_d);
  a.lora2 = static_cast<const int8_t*>(lora2);
  a.lora2_d = static_cast<const float*>(lora2_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.heads_out = static_cast<float*>(heads_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL; a.S = S; a.D = D; a.first = first;
  a.lo = att_tp_layout(C, CL, S, D, wf);
  return tp_launch_of(att_kernel(wf), a, a.lo.smem, grid_blocks, kBlockThreads, stream);
}

}  // namespace

// K10's stream plan in form wf (0 int8, 1 int4, 2 bf16) as the kernel
// computes it, for ops/megakernel_tp.py::tp_v6_stream_plan (kind "att7") to
// be held to: out[0] the launch's dynamic shared bytes, out[1] a stage's
// bytes, out[2] the stages, out[3] block `block`'s pieces of a grid of
// `blocks`, out[4] the kernel's static shared bytes, out[5] the vector rows
// a piece, out[6] the lora2 runs a piece. Returns a CUDA error code (0:
// none).
extern "C" int rwkv_tp_v7_plan(int wf, int C, int CL, int S, int D, int blocks, int block,
                               long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bad = att_shape_error(wf, C, CL, S, D);
  if (bad != 0) return bad;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, att_kernel(wf));
  if (err != cudaSuccess) return static_cast<int>(err);
  const TpLayout lo = att_tp_layout(C, CL, S, D, wf);
  const AttPlan pl(lo, C, CL, S, D, wf, blocks, block);
  out[0] = static_cast<long long>(lo.smem);
  out[1] = static_cast<long long>(lo.stage);
  out[2] = static_cast<long long>(lo.stages);
  out[3] = pl.pieces();
  out[4] = static_cast<long long>(attr.sharedSizeBytes);
  out[5] = lo.vec_rows;
  out[6] = lo.l2_runs;
  return 0;
}

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code) and one launch. The
// bf16 ones read no scales (pass null). K10's pointers but its outputs'
// (and v_first's when `first`) must be 16-byte aligned.
#define RWKV_TP_V7_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *heads_in, void *vf, const void *rkv,           \
      const void *rkv_d, const void *lora1, const void *lora1_d, const void *lora2,             \
      const void *lora2_d, const void *out, const void *out_d, const void *rvec,                \
      const void *lvec, void *part, void *att_out, void *heads_out, void *scratch, int C,       \
      int CL, int S, int D, int first, int grid_blocks, void *stream
#define RWKV_TP_V7_ATT_ARGS                                                                     \
  x, att_in, heads_in, vf, rkv, rkv_d, lora1, lora1_d, lora2, lora2_d, out, out_d, rvec, lvec,  \
      part, att_out, heads_out, scratch, C, CL, S, D, first, grid_blocks, stream

// The grid entry takes the widths that set the launch's shared memory.
#define RWKV_TP_V7_ENTRIES(suffix, wf)                                                          \
  extern "C" int rwkv_tp_v7_att##suffix##_grid(int C, int CL, int S, int D) {                  \
    return tp_grid_blocks_of(att_kernel(wf), AttLayout(C, CL, S, D, wf).smem, kBlockThreads);  \
  }                                                                                             \
  extern "C" int rwkv_tp_v7_att##suffix(RWKV_TP_V7_ATT_PARAMS) {                               \
    return att_launch(wf, RWKV_TP_V7_ATT_ARGS);                                                 \
  }

RWKV_TP_V7_ENTRIES(, kInt8)
RWKV_TP_V7_ENTRIES(_w4, kInt4)
RWKV_TP_V7_ENTRIES(_bf16, kBf16)
