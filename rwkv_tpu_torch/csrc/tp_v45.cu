// K14: the attention of one layer of an RWKV v4 decode step at B=1 on one
// shard of a tensor-parallel mesh, w8a8, w4a8 or bf16. One launch per
// shard per layer; the caller sums the shards' full-C partials, then runs
// the gated FFN on K13's MIX45 form (tp_v6.cu) and gathers its gate
// (ops/megakernel_tp.py). The v5 attention (K15) is a form of K12's kernel
// in tp_v6.cu.
//
// Replaces rwkv_tpu/ops/megakernel_tp.py::_att_layer_call_v4 (kernel
// _make_att_kernel_v4), in its int8, int4 and bf16 forms.
//
// Bound on this card: bytes. At the World 1.5B width (C=2048) and tp=2 a
// launch reads its shard's rkv rows (3 x 1024 x 2048) and out columns
// (2048 x 1024), ~8.4 MB int8: ~2.5 us at 3.35 TB/s. int4 moves about half
// of that, bf16 twice.
//
// Design: K8's phases A and B (v4_decode.cu) for one layer and one shard,
// on the shared input stream (decode_stream.cuh, tp_stream.cuh): a
// persistent cooperative kernel, one block per SM, each block eight
// consumer warps and one producer warp.
//   A  ln1, shift, the three mixes (k, v, r) each quantized as a whole
//      (replicated input; their amax folded into the layer norm's last
//      pass), the shard's 3 C/tp rkv rows (sigmoid on r)
//   B  every block computes the shard's C/tp-wide sigmoid(r) * wkv with the
//      max-trick (wkv4_out, v45_common.cuh) and its amax in the same pass
//      (its quantization needs the amax of all of it), and writes the new
//      aa, bb, pp of its own 4-channel groups (wkv4_state); then the
//      shard's xo quantized with its own scale and the C rows of out
//      [C, C/tp] into the partial
// Every input that does not depend on another block -- phase A's vector
// rows (ln1 w, b, the three mixes, att_in), the weight rows with their row
// scales, phase B's td at the block's channels, tf and the old aa, bb, pp
// -- reaches shared memory through the block's ring of stages, fed by the
// producer warp with bulk asynchronous copies in the order the consumers
// take them (Att4Layout / Att4Plan / att4_copy; ops/megakernel_tp.py::
// tp_v6_stream_plan, kind "att4", mirrors it), so B's inputs and out rows
// are in flight while the consumers wait at the grid barrier. The host
// computes the layout, the producer the block's plan while the consumers
// take x's statistics (K12's start, tp_stream.cuh). Each row is summed
// with the lanes, the chunk order and the shuffle tree that the earlier
// cooperative kernel's grid-wide matvec gave it (lanes_for(C) for
// rkv, lanes_for(C/tp) for out), so the outputs are that kernel's bit for
// bit on any grid.
//
// Numerics follow the JAX kernel as K8 does (explicit round-to-nearest
// float ops, each matvec input quantized as a whole, the out input the
// shard's local slice with its own scale).
#include "tp_stream.cuh"
#include "v45_common.cuh"

namespace {

// a block: kConsumers compute threads (decode_stream.cuh), then one
// producer warp
constexpr int kThreads = stream::kConsumers;
constexpr int kBlockThreads = stream::kBlockThreads;

// rows of a shard's replicated vector block [L, rows, C] and of its own
// [L, rows, C/tp] (ops/megakernel_tp.py TP4_RVECS, TP4_LVECS). Rows 2, 3, 5
// and 6 hold ln2 and the FFN mixes where K13 (tp_v6.cu RVec6) reads them;
// the attention mixes k, v, r sit around them.
enum RVec45 { kRLn1W = 0, kRLn1B, kRLn2W, kRLn2B, kRMixK, kRFmixK, kRFmixR, kRMixV };
enum LVec45 { kLTD = 0, kLTF };

using stream::Rows;
using stream::part;
using stream::round_up;

struct Att4Args {
  const float* x;          // [C]
  const float* att_in;     // [C]
  const float* aa_in;      // [CL] the shard's channels of the state
  const float* bb_in;
  const float* pp_in;
  const int8_t* rkv;       // [3, CL, C] form WF
  const float* rkv_d;      // [3 CL] (int forms)
  const int8_t* out;       // [C, CL] form WF
  const float* out_d;      // [C]
  const float* rvec;       // [kRMixV + 2, C]
  const float* lvec;       // [2, CL] td, tf
  float* part;             // [C] the shard's partial of out
  float* att_out;          // [C] ln1(x)
  float* aa_out;           // [CL]
  float* bb_out;
  float* pp_out;
  float* scratch;          // sigmoid(r) | k | v (3 CL); the timing build's stamps follow
  int C, CL;
  TpLayout lo;
};

constexpr int kVecA = 6;  // phase A's vector rows: ln1 w, ln1 b, the mixes k, v, r, att_in
constexpr int kVecB = 5;  // phase B's: td at the block's channels, tf, aa_in, bb_in, pp_in

// Shared memory of a launch: xs, xl (C floats each), red (256), dxs (8),
// the activations (int8 codes, or f32 in the bf16 form; 3C of them), then
// the block's plan, its mbarriers and the ring.
__host__ __device__ inline size_t att4_act_off(int C) {
  return round_up(4 * (2ull * C + 256 + 8), 16);
}

// the largest piece: two vector rows (C floats apart: B's rows are C/tp
// wide), one rkv or out row with its scale window
__host__ __device__ inline size_t att4_piece(int C, int CL, int wf) {
  const size_t row = stream::max2(form_bytes(wf, C), form_bytes(wf, CL));
  return stream::max2(8ull * C, row + stream::win_bytes(1));
}

struct Att4Layout : stream::Ring {
  size_t act_off;
  int vec_rows;  // vector rows a piece, in either phase
  __host__ __device__ Att4Layout(int C, int CL, int wf)
      : stream::Ring(round_up(att4_act_off(C) + (wf == kBf16 ? 4ull : 1ull) * 3 * C, 16),
                     att4_piece(C, CL, wf)),
        act_off(att4_act_off(C)),
        vec_rows(vec_rows_for(stage, C, kVecA)) {}
};

// The pieces in stream order; a segment is a run of pieces.
enum Att4Seg {
  sVecA,  // ln1 w, ln1 b, the mixes k, v, r, att_in: vec_rows rows a piece
  sAtt,   // the shard's fused r, k, v rows
  sVecB,  // td at the block's channels [s0, s1), tf, aa_in, bb_in, pp_in:
          // vec_rows rows a piece
  sOut,
  kAtt4Segs
};

// Block b's share of every phase.
struct Att4Plan {
  Rows att, out;
  int s0, s1;            // the channels whose aa, bb, pp the block writes (phase B)
  int vec_a, vec_b;      // each phase's vector pieces
  int vec_rows;
  __host__ __device__ Att4Plan(const TpLayout& lo, int C, int CL, int wf, int blocks, int b) {
    const bool w = wf != kBf16;
    const int st = static_cast<int>(lo.stage);
    // the lanes the earlier kernel's grid-wide matvec gave each matrix's rows
    att = part(3 * CL, blocks, b, false, static_cast<int>(form_bytes(wf, C)), w, st,
               lanes_for(C, wf));
    out = part(C, blocks, b, false, static_cast<int>(form_bytes(wf, CL)), w, st,
               lanes_for(CL, wf));
    const Rows ch = part(CL, blocks, b, false, 4, false, st, 1);
    s0 = ch.r0;
    s1 = ch.r1;
    vec_rows = lo.vec_rows;
    vec_a = (kVecA + vec_rows - 1) / vec_rows;
    vec_b = (kVecB + vec_rows - 1) / vec_rows;
  }
  __host__ __device__ int count(int seg) const {
    switch (seg) {
      case sVecA: return vec_a;
      case sAtt: return att.pieces();
      case sVecB: return vec_b;
      case sOut: return out.pieces();
      default: return 0;
    }
  }
  __host__ __device__ int pieces() const {
    int n = 0;
    for (int s = 0; s < kAtt4Segs; ++s) n += count(s);
    return n;
  }
};
static_assert(sizeof(Att4Plan) <= stream::kPlanBytes, "the plan's shared bytes");

// Copy i of piece idx of segment seg: a 16-byte multiple from a 16-byte
// aligned src into the stage at offset dst (vector row slot i at 4 C i).
// Returns false past the piece's last copy, and for the td slice of a
// block that has no channels.
__host__ __device__ inline bool att4_copy(const Att4Args& p, const Att4Plan& pl, int wf, int seg,
                                          int idx, int i, const void** src, uint32_t* dst,
                                          uint32_t* bytes) {
  const int C = p.C, CL = p.CL;
  const bool w = wf != kBf16;
  auto put = [&](const void* s_, uint32_t n_) {
    *src = s_;
    *dst = 4u * C * i;
    *bytes = n_;
    return true;
  };
  switch (seg) {
    case sVecA: {
      const int j = idx * pl.vec_rows + i;
      if (i >= pl.vec_rows || j >= kVecA) return false;
      const int vrows[5] = {kRLn1W, kRLn1B, kRMixK, kRMixV, kRMixV + 1};
      return put(j < 5 ? p.rvec + vrows[j] * C : p.att_in, 4u * C);
    }
    case sAtt: return rows_copy(pl.att, p.rkv, w ? p.rkv_d : nullptr, idx, i, src, dst, bytes);
    case sVecB: {
      const int j = idx * pl.vec_rows + i;
      if (i >= pl.vec_rows || j >= kVecB) return false;
      if (j == 0)
        return pl.s1 > pl.s0 &&
               put(p.lvec + kLTD * CL + pl.s0, 4u * static_cast<uint32_t>(pl.s1 - pl.s0));
      const float* row = j == 1   ? p.lvec + kLTF * CL
                         : j == 2 ? p.aa_in
                         : j == 3 ? p.bb_in
                                  : p.pp_in;
      return put(row, 4u * CL);
    }
    case sOut: return rows_copy(pl.out, p.out, w ? p.out_d : nullptr, idx, i, src, dst, bytes);
    default: return false;
  }
}

// The grid barrier's word (stream::grid_sync), safe while the launches on
// the card run one after another, as every TP launch does (the device's
// current stream, ops/megakernel_tp.py).
__device__ unsigned g_att4_count = 0;

template <int WF>
__global__ void __launch_bounds__(kBlockThreads, 1) tp_v4_att_kernel(Att4Args p) {
  unsigned long long t_entry = 0;
  ENTRY_TIME(t_entry);
  constexpr bool kQuant = WF != kBf16;
  const int C = p.C, CL = p.CL;
  const int tid = threadIdx.x;
  const TpLayout& lo = p.lo;

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [C] x
  float* xl = xs + C;                           // [C] ln1(x); phase B: xo (CL)
  float* red = xl + C;                          // [8][32]
  float* dxs = red + 8 * 32;                    // [8]
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(smem + lo.act_off);  // [3C] activations
  Att4Plan* plan = reinterpret_cast<Att4Plan*>(smem + lo.plan_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lo.bar_off);
  uint64_t* empty = full + stream::kMaxStages;
  unsigned char* ring = smem + lo.ring_off;
  const int stages = static_cast<int>(lo.stages);
  const Att4Plan& pl = *plan;  // read by the consumers after stream_ready_wait

  if (tid >= kThreads) {
    // the producer warp
    if (tid == kThreads) {
      init_mbarriers(full, empty, stages);
      *plan = Att4Plan(lo, C, CL, WF, gridDim.x, blockIdx.x);
    }
    __syncwarp();
    stream_ready_arrive();
    stream::produce<kAtt4Segs, kAtt4Segs>(
        pl, 1, stages, ring, lo.stage, full, empty,
        [&](int, int seg, int idx, int i, const void** src, uint32_t* dst, uint32_t* bytes) {
          return att4_copy(p, pl, WF, seg, idx, i, src, dst, bytes);
        });
    return;
  }
  float* att_g = p.scratch;  // [3][CL] sigmoid(r), k, v

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks = reinterpret_cast<unsigned long long*>(p.scratch + 3 * CL);
  int n_marks = 0;
#endif
  PHASE_ENTRY(t_entry);
  PHASE_MARK();
  stream::Stream cs{ring, lo.stage, stages, full, empty};
  const int vr = lo.vec_rows;

  // ---- A: ln1, shift, the mixes quantized, the shard's r k v rows ---------
  stream::load_vec(xs, p.x, C);
  stream::csync();
  {
    // the vector pieces are the stream's first, in stages 0, 1, ...; the
    // layer norm's statistics need only x, so they run while they land
    auto vrow = [&](int j) {
      return reinterpret_cast<const float*>(ring + (j / vr) * lo.stage + (j % vr) * 4ull * C);
    };
    const float *ln_w = vrow(0), *ln_b = vrow(1), *ai = vrow(5);
    const float* mx[3];  // k, v, r
#pragma unroll
    for (int m = 0; m < 3; ++m) mx[m] = vrow(2 + m);
    stream::layer_norm_act<WF, 3>(
        xs, xl, ln_w, ln_b, C, 1e-5f, red, [](int, float) {},
        [&](int m, int c) { return mix45(xl[c], ai[c], mx[m][c]); }, q8, C, dxs,
        [&]() {
          stream_ready_wait();  // the mbarriers and the plan
          for (int k = 0; k < pl.vec_a; ++k) cs.wait();
        });
    cs.release(pl.vec_a);
  }
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += kThreads) p.att_out[c] = xl[c];
  // the part (r, k, v) of a fused row (comparisons: a division by a runtime
  // CL costs ~20 instructions)
  auto part3 = [CL](int row) { return (row >= CL) + (row >= 2 * CL); };
  cs.rows<WF>(pl.att, C, [&](int row) { return q8 + att_mix(part3(row)) * C; },
              [&](int row, auto acc, const float* d) {
                const int part = part3(row);
                const float y = dequant(acc, dxs[att_mix(part)], d);
                att_g[row] = part == 0 ? sigmoidf(y) : y;
              });
  PHASE_MARK();
  stream::csync();
  if (tid == 0) stream::grid_sync(&g_att4_count, gridDim.x);
  stream::csync();
  PHASE_MARK();

  // ---- B: xo = sigmoid(r) * wkv (every block), the state, out rows --------
  {
    // td at the block's channels, tf, aa_in, bb_in, pp_in: vec_rows rows a
    // piece, from the stage the stream is at
    const float* vb[kVecB];
    const unsigned char* base = nullptr;
    int k = 0;
#pragma unroll
    for (int j = 0; j < kVecB; ++j) {
      if (k == 0) base = cs.wait();
      vb[j] = reinterpret_cast<const float*>(base + k * 4ull * C);
      if (++k == vr) k = 0;
    }
    const int s0 = pl.s0, s1 = pl.s1;
    const float* td = vb[0] - s0;
    const float *tf = vb[1], *aa = vb[2], *bb = vb[3], *pp = vb[4];
    float amax[1] = {0.f};
    for (int c = tid; c < CL; c += kThreads) {
      const float kk = __ldcg(att_g + CL + c), vv = __ldcg(att_g + 2 * CL + c);
      const float y = mul(__ldcg(att_g + c), wkv4_out(tf[c], kk, vv, aa[c], bb[c], pp[c]));
      if (c >= s0 && c < s1)
        wkv4_state(td[c], kk, vv, aa[c], bb[c], pp[c], p.aa_out + c, p.bb_out + c, p.pp_out + c);
      if constexpr (kQuant) {
        xl[c] = y;
        amax[0] = fmaxf(amax[0], fabsf(y));
      } else {
        q8[c] = y;
      }
    }
    cs.release(pl.vec_b);
    if constexpr (kQuant) {
      // act_n's quantization of the vector, its amax taken above
      stream::block_max_n<1>(amax, red);
      const float dx = amax[0] / 127.0f;
      const float inv = act_inv_scale(dx);
      if (tid == 0) dxs[0] = dx;
      for (int c = tid; c < CL; c += kThreads) q8[c] = act_code(xl[c], inv);
    }
    stream::csync();
  }
  cs.rows<WF>(pl.out, CL, [&](int) { return q8; },
              [&](int row, auto acc, const float* d) { p.part[row] = dequant(acc, dxs[0], d); });
  PHASE_MARK();
}

const void* att4_kernel(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(tp_v4_att_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(tp_v4_att_kernel<kInt4>)
                     : reinterpret_cast<const void*>(tp_v4_att_kernel<kInt8>);
}

// Why K14 cannot run these shapes (a CUDA error code), or 0.
int att4_shape_error(int wf, int C, int CL) {
  if (C <= 0 || CL <= 0 || C % 16 != 0 || CL % 16 != 0 || CL > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const Att4Layout lo(C, CL, wf);
  const int stages = static_cast<int>(lo.stages);
  if (stages < stream::kMinStages || lo.vec_rows < 2 ||
      (kVecA + lo.vec_rows - 1) / lo.vec_rows > stages)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int att4_launch(int wf, const void* x, const void* att_in, const void* aa_in, const void* bb_in,
                const void* pp_in, const void* rkv, const void* rkv_d, const void* out,
                const void* out_d, const void* rvec, const void* lvec, void* part, void* att_out,
                void* aa_out, void* bb_out, void* pp_out, void* scratch, int C, int CL,
                int grid_blocks, void* stream) {
  const int bad = att4_shape_error(wf, C, CL);
  if (bad != 0) return bad;
  if (grid_blocks <= 0 || !stream::part_fits(3ll * CL > C ? 3ll * CL : C, grid_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16({x, att_in, aa_in, bb_in, pp_in, rkv, rkv_d, out, out_d, rvec, lvec}))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Att4Args a;
  a.x = static_cast<const float*>(x);
  a.att_in = static_cast<const float*>(att_in);
  a.aa_in = static_cast<const float*>(aa_in);
  a.bb_in = static_cast<const float*>(bb_in);
  a.pp_in = static_cast<const float*>(pp_in);
  a.rkv = static_cast<const int8_t*>(rkv);
  a.rkv_d = static_cast<const float*>(rkv_d);
  a.out = static_cast<const int8_t*>(out);
  a.out_d = static_cast<const float*>(out_d);
  a.rvec = static_cast<const float*>(rvec);
  a.lvec = static_cast<const float*>(lvec);
  a.part = static_cast<float*>(part);
  a.att_out = static_cast<float*>(att_out);
  a.aa_out = static_cast<float*>(aa_out);
  a.bb_out = static_cast<float*>(bb_out);
  a.pp_out = static_cast<float*>(pp_out);
  a.scratch = static_cast<float*>(scratch);
  a.C = C; a.CL = CL;
  a.lo = tp_layout(Att4Layout(C, CL, wf));
  return tp_launch_of(att4_kernel(wf), a, a.lo.smem, grid_blocks, kBlockThreads, stream);
}

}  // namespace

// K14's stream plan in form wf (0 int8, 1 int4, 2 bf16) as the kernel
// computes it, for ops/megakernel_tp.py::tp_v6_stream_plan (kind "att4") to
// be held to: out[0] the launch's dynamic shared bytes, out[1] a stage's
// bytes, out[2] the stages, out[3] block `block`'s pieces of a grid of
// `blocks`, out[4] the kernel's static shared bytes, out[5] the vector rows
// a piece. Returns a CUDA error code (0: none).
extern "C" int rwkv_tp_v4_plan(int wf, int C, int CL, int blocks, int block, long long* out) {
  if (wf < kInt8 || wf > kBf16 || blocks <= 0 || block < 0 || block >= blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bad = att4_shape_error(wf, C, CL);
  if (bad != 0) return bad;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, att4_kernel(wf));
  if (err != cudaSuccess) return static_cast<int>(err);
  const TpLayout lo = tp_layout(Att4Layout(C, CL, wf));
  const Att4Plan pl(lo, C, CL, wf, blocks, block);
  out[0] = static_cast<long long>(lo.smem);
  out[1] = static_cast<long long>(lo.stage);
  out[2] = static_cast<long long>(lo.stages);
  out[3] = pl.pieces();
  out[4] = static_cast<long long>(attr.sharedSizeBytes);
  out[5] = lo.vec_rows;
  return 0;
}

// The C entries, one per weight form (suffix "", _w4, _bf16): the grid a
// launch uses (blocks, or a negative CUDA error code; it takes the widths
// that set the launch's shared memory) and one launch. The bf16 ones read
// no scales (pass null). Every pointer but the outputs' and the scratch's
// must be 16-byte aligned.
#define RWKV_TP_V4_ATT_PARAMS                                                                   \
  const void *x, const void *att_in, const void *aa_in, const void *bb_in, const void *pp_in,   \
      const void *rkv, const void *rkv_d, const void *out, const void *out_d, const void *rvec, \
      const void *lvec, void *part, void *att_out, void *aa_out, void *bb_out, void *pp_out,    \
      void *scratch, int C, int CL, int grid_blocks, void *stream
#define RWKV_TP_V4_ATT_ARGS                                                                     \
  x, att_in, aa_in, bb_in, pp_in, rkv, rkv_d, out, out_d, rvec, lvec, part, att_out, aa_out,    \
      bb_out, pp_out, scratch, C, CL, grid_blocks, stream
#define RWKV_TP_V45_ENTRIES(suffix, wf)                                                         \
  extern "C" int rwkv_tp_v4_att##suffix##_grid(int C, int CL) {                                \
    return tp_grid_blocks_of(att4_kernel(wf), Att4Layout(C, CL, wf).smem, kBlockThreads);      \
  }                                                                                             \
  extern "C" int rwkv_tp_v4_att##suffix(RWKV_TP_V4_ATT_PARAMS) {                               \
    return att4_launch(wf, RWKV_TP_V4_ATT_ARGS);                                                \
  }

RWKV_TP_V45_ENTRIES(, kInt8)
RWKV_TP_V45_ENTRIES(_w4, kInt4)
RWKV_TP_V45_ENTRIES(_bf16, kBf16)
