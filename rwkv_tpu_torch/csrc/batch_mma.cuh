// K4's tensor-core matvec (v7_decode_batched.cu): one matrix of a decode
// phase against the whole batch in one pass over its rows, on the int8
// tensor cores (mma.sync m16n8k32 s8.s8.s32; the int forms) or the bf16
// ones (m16n8k16 bf16.bf16.f32, x in three bf16 parts; the bf16 form, see
// sweep_pass_bf16 below). The launch plan comes from
// rwkv_tpu_torch/ops/megakernel.py::batched_plan; `Layout` below counts the
// same shared bytes, and the C entry refuses a plan whose count differs.
//
// A sweep takes one matrix of a phase (rkv, lora1, out, fk or fv). Its rows
// are the A operand in tiles of 16; the batch is the N operand in n-tiles
// of 8 sequences (the last one zero-filled past B: zero codes add nothing).
// The tiles are dealt over the grid's blocks in contiguous runs whose
// sizes differ by at most one (lora1 from the last block down, so it lands
// on the blocks rkv gave fewer tiles). A block stages its tiles' rows and
// their scales, a K slice at a time, in shared memory by cp.async
// (zero-filled past K); two slices are in flight where the plan's ring
// allows. Where the batch's codes lie in global memory (placement (b)) the
// slice of every sequence's codes is staged with them; in placement (a)
// the block prepared them in shared memory itself, whole. In placement (b)
// the out and fv sweeps, whose C / 16 tiles would leave most blocks idle
// and each busy block staging all of B's codes, cut each tile's K into
// parts on blocks of their own (sweep_split): the parts' int32 sums meet
// in global memory, and the last block of a tile runs its epilogue. Every
// row is read from memory once a step, whatever B.
//
// Fragments. A lane (g = lane / 4, t = lane % 4) reads 16 contiguous bytes
// of weight rows g and g + 8 and of the codes of sequence g of each n-tile
// (LDS.128, no ldmatrix): 32 codes of K a lane, 128 a warp, per K step.
// Word i of those bytes plays the role of mma's k = 4 t + 16 (i % 2) .. + 3
// in the i / 2-th of four m16n8k32 products. That is a permutation of K,
// the same for both operands, so each product is the exact int32 dot of
// its 128 codes, and the sums add up exactly in any order. An int4 chunk
// (16 bytes, codes 32c + j in the low nibbles and 32c + 16 + j in the high
// ones, csrc/common.cuh) unpacks with w4_lo16 / w4_hi16 into its 32 codes
// times 16 in natural order; the sum is shifted right by 4 before the
// epilogue, as the CUDA-core matvec does.
//
// Work in a block: units of (tile, group of up to kGroup n-tiles), one a
// warp, in passes over the block's tiles (more than one pass only where
// its tiles have more units than it has warps, from B > 64); with fewer
// units than warps, the warps of a unit take its K steps in turn. Each
// warp keeps its unit's int32 sums in registers over the stages and adds
// them into a shared [BP][tile rows] array (integer adds: exact, in any
// order); then every thread takes (row, sequence) pairs through the
// sweep's epilogue, which sees the same int32 sum, scale and row as the
// CUDA-core matvec's epilogue did. The staging and the products
// (sweep_pass) are one function a weight form, not inlined into each
// sweep: the kernel's code and registers stay smaller.
//
// The bf16 form (sweep_pass_bf16) shares the tiles, units, passes and
// staging, with its rows as bf16 (64-value K steps, 128 bytes a row) and
// its inputs as f32 (4 bytes a value, split into three bf16 parts in
// registers as each B fragment is loaded), and differs where float sums
// must keep one order: every block takes a tile's K whole (no split), each
// unit's K goes to four fixed leaves, one a warp, summed in f32 and added
// in a fixed order, and in placement (a) the pad columns past B are left
// as they are (a column of mma's B feeds only its own column).
#pragma once

#include "decode_common.cuh"
#include "gemm_common.cuh"

#include <type_traits>

namespace bmma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // n-tiles a warp's unit holds (32 sequences)
constexpr int kMaxBatch = 8 * kGroup * kWarps;  // a tile's units fit the block's warps

enum SweepId { kSwRkv = 0, kSwL1, kSwOut, kSwFk, kSwFv, kNumSweeps };
constexpr int kVectors = 6;  // input vectors of a phase at most: phase A's six mixes
constexpr int kMaxSplit = 4;  // K parts a tile of the out / fv sweeps is cut into, at most

// The plan's ints (ops/megakernel.py::BatchedPlan.ints).
struct Plan {
  int place;  // 0: every block prepares all of B (a); 1: one warp a sequence, global codes (b)
  int ring;   // stages in flight where a sweep takes K in slices (1 or 2)
  int ks[kNumSweeps];  // K slice (codes) of each sweep's stage, a multiple of 128
  int smem;   // dynamic shared bytes
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int n, int m) { return cdiv(n, m) * m; }

// Bytes a staged row of k codes takes: whole 128-code steps, plus 16
// bytes that put rows g and g + 1 of a fragment in different banks.
__host__ __device__ inline int code_stride(int k) { return round_up(k, 128) + 16; }

// Values of K a step of the bf16 form takes (128 bytes of a weight row):
// its sweeps' K slices are multiples of it, those of the int forms of 128.
constexpr int kBf16Step = 64;

// Bytes a staged row of k activations takes: int8 codes (code_stride), or
// the bf16 form's f32 values in whole steps plus 64 bytes (four lanes read
// 64 contiguous bytes of a row, so rows g and g + 1 fall in different
// banks).
__host__ __device__ inline int act_stride(int wf, int k) {
  return wf == kBf16 ? 4 * round_up(k, kBf16Step) + 64 : code_stride(k);
}

// Bytes a staged weight row of k codes takes (int4: k / 2 bytes, padded
// to 64 mod 128 for the same reason; bf16: 2k bytes in whole steps, plus
// 32, as four lanes read 32 contiguous bytes of each of rows g .. g + 3).
__host__ __device__ inline int weight_stride(int wf, int k) {
  if (wf == kBf16) return 2 * round_up(k, kBf16Step) + 32;
  if (wf != kInt4) return code_stride(k);
  const int half = round_up(k, 128) / 2;
  return half % 128 == 64 ? half : half + 64;
}

// One matrix of a phase: rows (a multiple of 16) of K codes in form wf;
// each part of part_rows rows reads one input vector.
struct SweepDims {
  int rows, K, part_rows, parts, wf;
};

__host__ __device__ inline SweepDims sweep_dims(int id, int wf, int C, int D, int F) {
  switch (id) {
    case kSwRkv: return {3 * C, C, C, 3, wf};
    case kSwL1: return {4 * D, C, D, 4, small_form(wf)};  // the LoRAs stay int8 under w4a8
    case kSwOut: return {C, C, C, 1, wf};
    case kSwFk: return {F, C, F, 1, wf};
    default: return {C, F, C, 1, wf};
  }
}

// Most tiles a block takes in a sweep on `blocks` blocks.
__host__ __device__ inline int max_tiles(const SweepDims& s, int blocks) {
  return cdiv(s.rows / 16, blocks);
}

// K parts each tile of sweep `id` is cut into (its blocks add their int32
// partial sums in global memory, the last one runs the epilogue): in
// placement (b) the out and fv sweeps, whose C / 16 tiles would leave most
// blocks idle and each busy block staging all of B's codes, take every
// block they can, at most kMaxSplit and one 128-code step a part; else 1.
__host__ __device__ inline int sweep_split(int id, const SweepDims& s, int blocks, bool place_b) {
  if (!place_b || (id != kSwOut && id != kSwFv)) return 1;
  int sp = blocks / (s.rows / 16);
  const int steps = cdiv(s.K, 128);
  sp = sp > kMaxSplit ? kMaxSplit : sp;
  sp = sp > steps ? steps : sp;
  return sp < 1 ? 1 : sp;
}

// Codes of K a part of a split sweep takes at most (whole 128-code steps).
__host__ __device__ inline int part_k(const SweepDims& s, int split) {
  return 128 * cdiv(cdiv(s.K, 128), split);
}

// Shared bytes of a sweep's stages for a K slice of ks codes.
__host__ __device__ inline size_t stage_bytes(const SweepDims& s, int tiles, int slots, int bp,
                                              int ks, bool place_b) {
  size_t b = static_cast<size_t>(tiles) * 16 * weight_stride(s.wf, ks);
  if (place_b) b += static_cast<size_t>(slots) * bp * act_stride(s.wf, ks);
  return b;
}

// Tiles a pass of a sweep takes at most: its units (tile x n-group of
// kGroup n-tiles) fill the block's warps.
__host__ __device__ inline int pass_tiles(int nt) {
  const int groups = cdiv(nt, kGroup);
  return groups >= kWarps ? 1 : kWarps / groups;
}

// The bf16 form's partial sums of a row: the 16-value blocks b of a row
// go to leaf b % kLeaves (see sweep_pass_bf16).
constexpr int kLeaves = 4;

// The kernel's dynamic shared memory, region by region (byte offsets, all
// multiples of 16): phase C's scratch (hv 12 S floats, red 256, dxs 8, q8
// 4 D codes, or 4 D floats in the bf16 form), the activation scales
// (kVectors x bp) and a sweep's row scales (most tiles x 16 floats; the
// bf16 form has neither), in placement (a) the warps' sequence rows and
// the prepared inputs (kVectors x bp rows of C, or bp of F: codes, or f32
// in the bf16 form), then the work region (a sweep's stages, then its
// sums: int32, or the bf16 form's kLeaves f32 partial sums of a pass).
// The bf16 form sizes its stages by the tiles of a pass, the int forms by
// all of the block's tiles.
struct Layout {
  int nt, bp;       // n-tiles, padded batch (8 nt)
  size_t dxs, srow, xw, acodes, work, total;
  __host__ __device__ Layout(int wf, int C, int S, int D, int F, int B, int blocks,
                             const Plan& pl) {
    nt = cdiv(B, 8);
    bp = 8 * nt;
    const bool place_b = pl.place != 0, bf16 = wf == kBf16;
    const int per_pass = pass_tiles(nt);
    int tiles[kNumSweeps], slots[kNumSweeps], most = 0;
    for (int i = 0; i < kNumSweeps; ++i) {
      const SweepDims s = sweep_dims(i, wf, C, D, F);
      tiles[i] = max_tiles(s, blocks);
      most = tiles[i] > most ? tiles[i] : most;
      if (bf16 && tiles[i] > per_pass) tiles[i] = per_pass;
      slots[i] = tiles[i] < s.parts ? tiles[i] : s.parts;
    }
    dxs = (12ull * S + 264) * sizeof(float) + (bf16 ? 16ull * D : round_up(4 * D, 16));
    srow = dxs + (bf16 ? 0 : static_cast<size_t>(kVectors) * bp * sizeof(float));
    xw = srow + (bf16 ? 0 : static_cast<size_t>(most) * 16 * sizeof(float));
    acodes = xw;
    work = xw;
    if (!place_b) {
      acodes = xw + 8ull * C * sizeof(float);
      const size_t codes = static_cast<size_t>(kVectors) * bp * act_stride(wf, C);
      const size_t f = static_cast<size_t>(bp) * act_stride(wf, F);
      work = acodes + (f > codes ? f : codes);
    }
    size_t w = bf16 ? static_cast<size_t>(kLeaves) * (most < per_pass ? most : per_pass) * 16 *
                          bp * sizeof(float)
                    : static_cast<size_t>(most) * 16 * bp * sizeof(int);
    for (int i = 0; i < kNumSweeps; ++i) {
      const SweepDims s = sweep_dims(i, wf, C, D, F);
      const int k = bf16 ? round_up(s.K, kBf16Step) : part_k(s, sweep_split(i, s, blocks, place_b));
      const size_t st = stage_bytes(s, tiles[i], slots[i], bp, pl.ks[i], place_b) *
                        (pl.ks[i] >= k ? 1 : pl.ring);
      w = st > w ? st : w;
    }
    total = work + w;
  }
};

// The tiles a block takes in a sweep: [t0, t1), and the parts they span,
// p0 .. p0 + nslots - 1 (slot s holds part p0 + s's input vector); the
// codes [k_lo, k_hi) of their rows it takes (one K part of `split`; a
// split sweep gives a block at most one tile).
struct Tiles {
  int t0, t1, p0, nslots, k_lo, k_hi;
};

__device__ __forceinline__ Tiles block_tiles(const SweepDims& s, bool reverse, int split = 1) {
  const int n = s.rows / 16 * split, blocks = gridDim.x;  // (tile, K part) items
  const int i = reverse ? blocks - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x);
  const int i0 = static_cast<int>(static_cast<long long>(n) * i / blocks);
  const int i1 = static_cast<int>(static_cast<long long>(n) * (i + 1) / blocks);
  const int kpart = i0 % split;
  Tiles t;
  t.t0 = i0 / split;
  t.t1 = i1 > i0 ? (split > 1 ? t.t0 + 1 : i1) : t.t0;
  t.p0 = t.t0 * 16 / s.part_rows;
  t.nslots = t.t1 > t.t0 ? (t.t1 * 16 - 1) / s.part_rows - t.p0 + 1 : 0;
  const int steps = cdiv(s.K, 128);
  t.k_lo = 128 * (steps * kpart / split);
  const int hi = 128 * (steps * (kpart + 1) / split);
  t.k_hi = hi < s.K ? hi : s.K;
  return t;
}

// Where a sweep reads its codes and scales; Mixes::m[p] names the input
// vector m of part p. Placement (a): the block's prepared codes, vector m of
// sequence b at codes + (m bp + b) stride + k (the whole K). Placement
// (b): the global code buffer, vector m of sequence b at q_g + (m B + b)
// K + k, scales at dx_g[m B + b], which the block stages. Either way the
// scales end up at dxs[m bp + b].
struct Source {
  bool place_b;
  const int8_t* codes;  // (a): shared; (b): q_g
  int stride;           // (a): bytes a code row
  float* dxs;           // shared scales, [vector][bp]
  const float* dx_g;    // (b)
  int* acc_g;           // split sweeps: partial sums [tile][bp][16], zero between uses
  int* tickets_g;       // split sweeps: blocks done a tile, zero between uses
};

// A sweep's geometry on this block: its tiles, K slices (nks of ks codes,
// nst stages in flight), staged row strides, n-groups of kGroup n-tiles
// and the tiles a pass takes (its units, tile x n-group, one a warp).
struct Geo {
  Tiles tl;
  int K, ks, nks, nst, wst, cst, row_bytes, groups, per_pass, bp;
};

template <int WF>
__device__ __forceinline__ Geo geometry(const SweepDims& s, int ks, int ring, bool reverse,
                                        int nt, int split) {
  Geo g;
  g.tl = block_tiles(s, reverse, split);
  g.K = s.K;
  g.ks = ks;
  g.nks = cdiv(g.tl.k_hi - g.tl.k_lo, ks);
  g.nst = g.nks > 1 ? ring : 1;
  g.wst = weight_stride(WF, ks);
  g.cst = act_stride(WF, ks);
  g.row_bytes = static_cast<int>(form_bytes(WF, s.K));
  g.groups = cdiv(nt, kGroup);
  g.per_pass = g.groups >= kWarps ? 1 : kWarps / g.groups;
  g.bp = 8 * nt;
  return g;
}

// A pass: tiles c0 .. c0 + ntc - 1, the parts p0 .. p0 + nslots - 1 they
// span, its stage's bytes, its units and the warps sharing a unit (kw).
struct Pass {
  int c0, ntc, p0, nslots, units, kw;
  size_t stage;
};

__device__ __forceinline__ Pass pass_at(const Geo& g, const SweepDims& s, int c0, bool place_b) {
  Pass p;
  p.c0 = c0;
  p.ntc = (c0 + g.per_pass < g.tl.t1 ? c0 + g.per_pass : g.tl.t1) - c0;
  p.p0 = c0 * 16 / s.part_rows;
  p.nslots = ((c0 + p.ntc) * 16 - 1) / s.part_rows - p.p0 + 1;
  p.units = p.ntc * g.groups;
  p.kw = p.units >= kWarps ? 1 : kWarps / p.units;
  p.stage = static_cast<size_t>(p.ntc) * 16 * g.wst +
            (place_b ? static_cast<size_t>(p.nslots) * g.bp * g.cst : 0);
  return p;
}

// The (row, chunk) pairs of rows of `chunks` 16-byte chunks, dealt to the
// block's threads in turn: thread i takes pairs i, i + blockDim.x, ...,
// its indices advanced without a division a pair.
struct Walk {
  int row, c, chunks, drow, dc;
  __device__ __forceinline__ explicit Walk(int n) : chunks(n) {
    row = threadIdx.x / n;
    c = threadIdx.x - row * n;
    drow = blockDim.x / n;
    dc = blockDim.x - drow * n;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++row;
    }
  }
};

// Issues (no commit) the copies of K slice st's weight rows of pass p into
// its stage, and with st == 0 the pass's row scales into srow.
template <int WF>
__device__ __forceinline__ void load_rows(const Geo& g, const Pass& p, const int8_t* W,
                                          const float* scales, int st, unsigned char* work,
                                          float* srow) {
  constexpr int kCodesPerChunk = WF == kInt4 ? 32 : WF == kBf16 ? 8 : 16;
  unsigned char* buf = work + static_cast<size_t>(st % g.nst) * p.stage;
  const int k0 = g.tl.k_lo + st * g.ks;
  for (Walk w(g.ks / kCodesPerChunk); w.row < p.ntc * 16; w.next()) {
    const int kc = k0 + w.c * kCodesPerChunk;
    const bool valid = kc < g.tl.k_hi;
    const int8_t* from = W + static_cast<size_t>(p.c0 * 16 + w.row) * g.row_bytes +
                         (valid ? form_bytes(WF, kc) : 0);
    gemm::cp_async16(buf + static_cast<size_t>(w.row) * g.wst + w.c * 16, from, valid);
  }
  if (WF != kBf16 && st == 0)  // the bf16 form has no row scales
    for (int e = threadIdx.x; e < p.ntc * 4; e += blockDim.x)
      gemm::cp_async16(srow + 4 * e, scales + p.c0 * 16 + 4 * e, true);
}

// The input vector each part of a sweep reads (at most four parts).
struct Mixes {
  int m[4];
};

// Issues (no commit) the copies of K slice st of the codes of pass p's
// slots (placement (b)), zero past B and past K.
__device__ __forceinline__ void load_codes(const Geo& g, const Pass& p, const Source& src, int B,
                                           int st, unsigned char* work, const Mixes& mix) {
  unsigned char* cb = work + static_cast<size_t>(st % g.nst) * p.stage +
                      static_cast<size_t>(p.ntc) * 16 * g.wst;
  const int k0 = g.tl.k_lo + st * g.ks;
  for (Walk w(g.ks / 16); w.row < p.nslots * g.bp; w.next()) {  // row = slot * bp + b
    const int sl = w.row / g.bp, b = w.row - sl * g.bp;
    const int kc = k0 + w.c * 16;
    const bool valid = b < B && kc < g.tl.k_hi;
    const int8_t* from =
        src.codes + (valid ? (static_cast<size_t>(mix.m[p.p0 + sl]) * B + b) * g.K + kc : 0);
    gemm::cp_async16(cb + static_cast<size_t>(w.row) * g.cst + w.c * 16, from, valid);
  }
}

// Issues (no commit) the copies of K slice st of the bf16 form's f32
// inputs of pass p's slots (placement (b)), zero past B and past K.
__device__ __forceinline__ void load_x(const Geo& g, const Pass& p, const Source& src, int B,
                                       int st, unsigned char* work, const Mixes& mix) {
  unsigned char* cb = work + static_cast<size_t>(st % g.nst) * p.stage +
                      static_cast<size_t>(p.ntc) * 16 * g.wst;
  const float* x = reinterpret_cast<const float*>(src.codes);
  const int k0 = g.tl.k_lo + st * g.ks;
  for (Walk w(g.ks / 4); w.row < p.nslots * g.bp; w.next()) {  // row = slot * bp + b
    const int sl = w.row / g.bp, b = w.row - sl * g.bp;
    const int kc = k0 + w.c * 4;
    const bool valid = b < B && kc < g.tl.k_hi;
    const float* from =
        x + (valid ? (static_cast<size_t>(mix.m[p.p0 + sl]) * B + b) * g.K + kc : 0);
    gemm::cp_async16(cb + static_cast<size_t>(w.row) * g.cst + w.c * 16, from, valid);
  }
}

// One 16-value block of the bf16 form: d = the product of the A fragment
// `a` (bf16 weights) with four f32 inputs of the lane's column, x.x, x.y
// (b0) and x.z, x.w (b1), each split into three bf16 parts (exact
// products, hi + mid + lo == x): three mmas from zero, parts lo, mid, hi.
// The caller adds d into its sum with one round-to-nearest add an
// element: chaining the mmas through the sum instead (the tensor cores'
// adds truncate) moved K4 four times as far from its plain version.
__device__ __forceinline__ void block_bf16(float (&d)[4], const unsigned (&a)[4], float4 x) {
  unsigned p01[3], p23[3];
  gemm::bf16_parts<3>(x.x, x.y, p01);
  gemm::bf16_parts<3>(x.z, x.w, p23);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = 0.f;
#pragma unroll
  for (int q = 2; q >= 0; --q) {
    const unsigned b[2] = {p01[q], p23[q]};
    gemm::mma_bf16(d, a, b);
  }
}

// One pass of a bf16 sweep (tiles c0 .. c0 + ntc - 1, see `sweep`) up to
// its sums: stages its rows (and in placement (b) the f32 inputs of its
// slots) a K slice at a time, runs the products, and leaves in red
// [kLeaves][bp][ntc x 16] f32 at the start of the work region the
// kLeaves partial sums of each row and sequence. Leaf q holds the 16-value
// blocks 4 s + q of K (q of each 64-value step s), taken in increasing s:
// each block's product (block_bf16) added in turn, two steps' products
// computed at once. Warp w sums leaf w % kLeaves of the pass's units
// w / kLeaves, + 2, + 4, + 6 (a pass has at most kWarps units), and the
// epilogue adds the leaves as (L0 + L2) + (L1 + L3): a row's sum order
// depends on K alone, not on B, the placement, the grid or the K slice,
// so a sequence gets the same bits in any batch and on any grid, and
// every warp works in every step. The bf16 sweeps take K whole on one
// block (no split).
//
// Fragments. Block q of a step is 32 bytes of a weight row; lane (g =
// lane / 4, t = lane % 4) reads 8 bytes of it at 8 t (values 16 q + 4 t ..
// + 3) from rows g and g + 8, and the same four values of sequence g's f32
// inputs (16 bytes). Words 0 and 1 of the 8 bytes are a0 and a2 (a1, a3
// from row g + 8), the inputs, each split into three bf16 parts, b0 and b1:
// mma's k = 2 t + i and 2 t + 8 + i hold values 16 q + 4 t + i and + 2 + i,
// a permutation of the block, the same for both operands.
__device__ __noinline__ void sweep_pass_bf16(SweepDims s, const int8_t* __restrict__ W, int ks,
                                             int ring, bool reverse, int B, int nt, Source src,
                                             unsigned char* work, Mixes mix, int c0) {
  const Geo g = geometry<kBf16>(s, ks, ring, reverse, nt, 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int bp = g.bp;
  const Pass p = pass_at(g, s, c0, src.place_b);
  auto load = [&](int st) {  // K slice st, rows and inputs, one commit group
    load_rows<kBf16>(g, p, W, nullptr, st, work, nullptr);
    if (src.place_b) load_x(g, p, src, B, st, work, mix);
    gemm::cp_async_commit();
  };
  load(0);
  if (g.nst > 1) load(1);

  const int leaf = warp % kLeaves, u0 = warp / kLeaves;  // units u0 + 2 r
  float acc[kWarps / 2][kGroup][4];
#pragma unroll
  for (int r = 0; r < kWarps / 2; ++r)
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;

  for (int st = 0; st < g.nks; ++st) {
    if (g.nst > 1 && st + 1 < g.nks) {
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* buf = work + static_cast<size_t>(st % g.nst) * p.stage;
    const int k0 = g.tl.k_lo + st * g.ks;
    const int steps = cdiv((g.tl.k_hi - k0 < g.ks ? g.tl.k_hi - k0 : g.ks), kBf16Step);
    // this warp's units in the slice: lane's weight bytes of rows gi (+ 8)
    // and input bytes of sequence gi of n-tile 0, at step 0
    // n-tiles of each unit (0 past the pass's units)
    const unsigned char* wp[kWarps / 2];
    const unsigned char* xp[kWarps / 2];
    int xs[kWarps / 2], nn[kWarps / 2];
#pragma unroll
    for (int r = 0; r < kWarps / 2; ++r) {
      const int u = u0 + 2 * r;
      const int j = u / g.groups, n0 = (u - j * g.groups) * kGroup;
      nn[r] = u < p.units ? (nt - n0 < kGroup ? nt - n0 : kGroup) : 0;
      const int sl = (c0 + j) * 16 / s.part_rows - p.p0;
      wp[r] = buf + static_cast<size_t>(j * 16 + gi) * g.wst + leaf * 32 + t * 8;
      if (src.place_b) {
        xs[r] = g.cst;
        xp[r] = buf + static_cast<size_t>(p.ntc) * 16 * g.wst +
                static_cast<size_t>(sl) * bp * g.cst;
      } else {
        xs[r] = src.stride;
        xp[r] = reinterpret_cast<const unsigned char*>(src.codes) +
                static_cast<size_t>(u < p.units ? mix.m[p.p0 + sl] : 0) * bp * src.stride +
                k0 * 4;
      }
      xp[r] += static_cast<size_t>(n0 * 8 + gi) * xs[r] + leaf * 64 + t * 16;
    }
    // steps kk and kk + 1 (`two`) of every unit and n-tile: both blocks'
    // products, then their adds in step order
    auto steps_at = [&](int kk, auto two) {
      constexpr int kN = decltype(two)::value ? 2 : 1;
#pragma unroll
      for (int r = 0; r < kWarps / 2; ++r) {
        if (nn[r] > 0) {  // warp-uniform
          unsigned a[kN][4];
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            const uint2 wa = *reinterpret_cast<const uint2*>(wp[r] + (kk + i) * 128);
            const uint2 wb = *reinterpret_cast<const uint2*>(wp[r] + 8 * g.wst + (kk + i) * 128);
            a[i][0] = wa.x;
            a[i][1] = wb.x;
            a[i][2] = wa.y;
            a[i][3] = wb.y;
          }
#pragma unroll
          for (int n = 0; n < kGroup; ++n) {
            if (n < nn[r]) {  // warp-uniform
              float d[kN][4];
#pragma unroll
              for (int i = 0; i < kN; ++i)
                block_bf16(d[i], a[i], *reinterpret_cast<const float4*>(
                                           xp[r] + static_cast<size_t>(n * 8) * xs[r] +
                                           (kk + i) * 256));
#pragma unroll
              for (int i = 0; i < kN; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[r][n][e] = __fadd_rn(acc[r][n][e], d[i][e]);
            }
          }
        }
      }
    };
    int kk = 0;
    for (; kk + 1 < steps; kk += 2) steps_at(kk, std::true_type{});
    if (kk < steps) steps_at(kk, std::false_type{});
    __syncthreads();  // the stage is free again
    if (st + g.nst < g.nks) load(st + g.nst);
  }

  // the leaves into red [kLeaves][bp][rows] over the work region (its
  // stages are read); every (leaf, unit) has one writer
  const int rows = p.ntc * 16;
  float* red = reinterpret_cast<float*>(work);
#pragma unroll
  for (int r = 0; r < kWarps / 2; ++r) {
    const int u = u0 + 2 * r;
    if (u < p.units) {
      const int j = u / g.groups, n0 = (u - j * g.groups) * kGroup;
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        if (n0 + n < nt) {
          float* r0 = red + (static_cast<size_t>(leaf) * bp + (n0 + n) * 8 + 2 * t) * rows +
                      j * 16 + gi;
          r0[0] = acc[r][n][0];
          r0[rows] = acc[r][n][1];
          r0[8] = acc[r][n][2];
          r0[rows + 8] = acc[r][n][3];
        }
      }
    }
  }
  __syncthreads();
}

// One pass of a sweep (tiles c0 .. c0 + ntc - 1, see `sweep`) up to its
// sums: stages its rows (and in placement (b) its codes, and with the
// block's first pass the scales of the block's input vectors), runs the
// products over the K slices and leaves the exact int32 dots in
// red [bp][ntc x 16] at the start of the work region, with the pass's row
// scales in srow. In a split sweep the block adds its partial dots of its
// tile into src.acc_g and takes a ticket; only the last of the tile's
// blocks gets the whole sums in red (reading and zeroing acc_g) and
// returns true. One copy a weight form, shared by the sweeps: the
// products are most of a sweep's code.
template <int WF>
__device__ __noinline__ bool sweep_pass(SweepDims s, const int8_t* __restrict__ W,
                                        const float* scales, int ks, int ring, bool reverse,
                                        int B, int nt, Source src, unsigned char* work,
                                        float* srow, Mixes mix, int c0, int split) {
  const Geo g = geometry<WF>(s, ks, ring, reverse, nt, split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int bp = g.bp;
  const Pass p = pass_at(g, s, c0, src.place_b);
  auto load = [&](int st) {  // K slice st, rows and codes, one commit group
    load_rows<WF>(g, p, W, scales, st, work, srow);
    if (src.place_b) load_codes(g, p, src, B, st, work, mix);
    gemm::cp_async_commit();
  };
  load(0);
  if (g.nst > 1) load(1);
  if (src.place_b && c0 == g.tl.t0) {  // the scales of the block's input vectors
    for (int e = tid; e < g.tl.nslots * bp; e += blockDim.x) {
      const int m = mix.m[g.tl.p0 + e / bp], b = e % bp;
      src.dxs[m * bp + b] = b < B ? src.dx_g[m * B + b] : 0.f;
    }
  }

  // this warp's unit: unit w (kw == 1), or unit w % units taking K steps
  // w / units, + kw, ... (kw > 1)
  const int kpart = p.kw > 1 ? warp / p.units : 0;
  const int u = p.kw > 1 ? (kpart < p.kw ? warp % p.units : p.units) : warp;
  const int j = u / g.groups, n0 = (u - j * g.groups) * kGroup;
  int acc[kGroup][4];
#pragma unroll
  for (int n = 0; n < kGroup; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0;

  for (int st = 0; st < g.nks; ++st) {
    if (g.nst > 1 && st + 1 < g.nks) {
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* buf = work + static_cast<size_t>(st % g.nst) * p.stage;
    const int k0 = g.tl.k_lo + st * g.ks;
    const int ksteps = cdiv((g.tl.k_hi - k0 < g.ks ? g.tl.k_hi - k0 : g.ks), 128);
    if (u < p.units) {  // warp-uniform
      const int sl = (c0 + j) * 16 / s.part_rows - p.p0;
      const unsigned char* wrow = buf + static_cast<size_t>(j * 16 + gi) * g.wst;
      const unsigned char* crow;
      int cstride, koff;
      if (src.place_b) {
        crow = buf + static_cast<size_t>(p.ntc) * 16 * g.wst + static_cast<size_t>(sl) * bp * g.cst;
        cstride = g.cst;
        koff = 0;
      } else {
        crow = reinterpret_cast<const unsigned char*>(src.codes) +
               static_cast<size_t>(mix.m[p.p0 + sl]) * bp * src.stride;
        cstride = src.stride;
        koff = k0;
      }
      for (int kk = kpart; kk < ksteps; kk += p.kw) {
        unsigned ra[8], rb[8];  // rows gi and gi + 8: 32 codes each
        if constexpr (WF == kInt4) {
          const int4 w0 = *reinterpret_cast<const int4*>(wrow + kk * 64 + t * 16);
          const int4 w1 = *reinterpret_cast<const int4*>(wrow + 8 * g.wst + kk * 64 + t * 16);
          const int x0[4] = {w0.x, w0.y, w0.z, w0.w}, x1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ra[q] = static_cast<unsigned>(w4_lo16(x0[q]));
            ra[4 + q] = static_cast<unsigned>(w4_hi16(x0[q]));
            rb[q] = static_cast<unsigned>(w4_lo16(x1[q]));
            rb[4 + q] = static_cast<unsigned>(w4_hi16(x1[q]));
          }
        } else {
          const uint4* pa = reinterpret_cast<const uint4*>(wrow + kk * 128 + t * 32);
          const uint4* pb = reinterpret_cast<const uint4*>(wrow + 8 * g.wst + kk * 128 + t * 32);
          const uint4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
          ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
          ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
          rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
          rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
        }
#pragma unroll
        for (int n = 0; n < kGroup; ++n) {
          if (n0 + n < nt) {  // warp-uniform
            const uint4* pc = reinterpret_cast<const uint4*>(
                crow + static_cast<size_t>((n0 + n) * 8 + gi) * cstride + koff + kk * 128 +
                t * 32);
            const uint4 x0 = pc[0], x1 = pc[1];
            const unsigned xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const unsigned a[4] = {ra[2 * q], rb[2 * q], ra[2 * q + 1], rb[2 * q + 1]};
              const unsigned b[2] = {xs[2 * q], xs[2 * q + 1]};
              gemm::mma_s8(acc[n], a, b);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free again
    if (st + g.nst < g.nks) load(st + g.nst);
  }

  // the sums: into red [bp][rows] int32 over the work region (its stages
  // are read)
  const int rows = p.ntc * 16;
  int* red = reinterpret_cast<int*>(work);
  for (int e = tid; e < rows * bp; e += blockDim.x) red[e] = 0;
  __syncthreads();
  if (u < p.units) {
#pragma unroll
    for (int n = 0; n < kGroup; ++n) {
      if (n0 + n < nt) {
        int* r0 = red + ((n0 + n) * 8 + 2 * t) * rows + j * 16 + gi;
        atomicAdd(r0, acc[n][0]);
        atomicAdd(r0 + rows, acc[n][1]);
        atomicAdd(r0 + 8, acc[n][2]);
        atomicAdd(r0 + rows + 8, acc[n][3]);
      }
    }
  }
  __syncthreads();
  if (split == 1) return true;
  // split: the tile's blocks add their partial dots (integer adds: the
  // total does not depend on their order); the last to take a ticket
  // reads the total, leaving zeros for the next use
  int* acc_t = src.acc_g + static_cast<size_t>(c0) * bp * 16;
  for (int e = tid; e < rows * bp; e += blockDim.x) atomicAdd(acc_t + e, red[e]);
  __threadfence();
  const bool last =
      __syncthreads_or(tid == 0 && atomicAdd(src.tickets_g + c0, 1) == split - 1) != 0;
  if (!last) return false;
  __threadfence();
  for (int e = tid; e < rows * bp; e += blockDim.x) red[e] = atomicExch(acc_t + e, 0);
  if (tid == 0) atomicExch(src.tickets_g + c0, 0);
  __syncthreads();
  return true;
}

// Runs sweep `s` (weight form WF, rows W with row scales `scales`, K
// slice ks, each tile cut into `split` K parts) on this block: epi(row, b,
// acc, dx, d) for each of its rows (of a split sweep: those whose last
// part it computed) and each sequence b < B, acc the exact int32 dot of
// the row with sequence b's codes of the input vector mix.m[part] of the
// row's part, dx their scale, d the row's scale (in shared memory); in the
// bf16 form acc is the f32 dot with its f32 inputs (no scales: dx 0, d
// null). Block-uniform; ends with a barrier, so every shared region may be
// reused after it.
template <int WF, typename Epi>
__device__ __forceinline__ void sweep(const SweepDims& s, const int8_t* __restrict__ W,
                                      const float* scales, int ks, int ring, bool reverse, int B,
                                      int nt, const Source& src, unsigned char* work, float* srow,
                                      const Mixes& mix, int split, Epi epi) {
  const Geo g = geometry<WF>(s, ks, ring, reverse, nt, split);
  if constexpr (WF == kBf16) {
    for (int c0 = g.tl.t0; c0 < g.tl.t1; c0 += g.per_pass) {  // block-uniform
      sweep_pass_bf16(s, W, ks, ring, reverse, B, nt, src, work, mix, c0);
      const int rows = ((c0 + g.per_pass < g.tl.t1 ? c0 + g.per_pass : g.tl.t1) - c0) * 16;
      const float* red = reinterpret_cast<const float*>(work);
      const size_t leaf = static_cast<size_t>(g.bp) * rows;
      for (int e = threadIdx.x; e < rows * B; e += blockDim.x) {
        const int b = e / rows, r = e - b * rows;
        const float* v = red + b * rows + r;
        epi(c0 * 16 + r, b, add(add(v[0], v[2 * leaf]), add(v[leaf], v[3 * leaf])), 0.f,
            static_cast<const float*>(nullptr));
      }
      __syncthreads();
    }
  } else {
    for (int c0 = g.tl.t0; c0 < g.tl.t1; c0 += g.per_pass) {  // block-uniform
      if (!sweep_pass<WF>(s, W, scales, ks, ring, reverse, B, nt, src, work, srow, mix, c0,
                          split))
        continue;
      const int rows = ((c0 + g.per_pass < g.tl.t1 ? c0 + g.per_pass : g.tl.t1) - c0) * 16;
      const int* red = reinterpret_cast<const int*>(work);
      for (int e = threadIdx.x; e < rows * B; e += blockDim.x) {
        const int b = e / rows, r = e - b * rows;
        const int row = c0 * 16 + r;
        int a = red[b * rows + r];
        if constexpr (WF == kInt4) a >>= 4;  // the int4 codes were taken times 16
        epi(row, b, a, src.dxs[mix.m[row / s.part_rows] * g.bp + b], srow + r);
      }
      __syncthreads();
    }
  }
}

}  // namespace bmma
