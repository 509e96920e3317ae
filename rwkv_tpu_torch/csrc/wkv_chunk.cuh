// The chunked two-pass skeleton of the prefill wkv kernels K2 (wkv7.cu) and
// K5 (wkv6.cu): the launch plan, the ready flags, pass B's ring of operator
// stages, the identity tokens that pad a ragged last chunk, and the token
// recurrence that short sequences (and many heads) take.
//
// A launch computes a whole sequence of T tokens for BH heads (batch folded
// with heads) from the state s0 [BH, S, S] (row i = value index, column j =
// key index). Chunks of P = 16 tokens:
//  - pass A: every (chunk, head) pair -- an item -- is independent: a block's
//    256 compute threads build its operators from the raw operands (the
//    de-decayed or exact pair factors, the P x P products, the state map's
//    factors), write them to a scratch the wrapper allocates, and publish
//    the pair's ready flag (release). Items are dealt chunk-major from the
//    grid's first block, so chunk 0 of every head is ready first.
//  - pass B: a (head, row group) pair carries its state rows through the
//    chunks in order; items are dealt from the grid's last block, so where
//    the grid holds both kinds no block does both. Each row of the state is
//    carried independently of the others: a block owns `rows` rows, a
//    compute warp rows w, w + W, ... (W = 4 or 8 warps), in shared memory,
//    and writes their y.
//    The block's ninth warp is a producer: it waits on the next chunk's
//    flag (acquire) and brings its operators into a ring of stages with
//    bulk copies (cp.async.bulk) that complete on the stage's "full"
//    mbarrier, once every compute warp has released the stage ("empty").
//    The compute warps never wait on each other within pass B.
// Every block finishes its pass-A items before it waits on any flag, and the
// launch is cooperative (every block resident), so no wait can deadlock.
// Below a crossover T (recurrence_below; past 48 heads at every T) the
// same kernel runs the token recurrence instead, each block a (head, row
// group) pair, S / 8 lanes a row with 8 of its entries in registers (two
// rows a lane where the blocks would outnumber the SMs), the tokens'
// operands staged 16 at a time in shared memory.
//
// The flags are a buffer the wrapper keeps zeroed once: [0] the launch
// epoch, [1] the blocks done, then one flag an item. A launch publishes
// epoch + 1; its last block to finish advances the epoch, so flags never
// need clearing between launches.
//
// ops/chunked.py::wkv_chunk_plan mirrors make_plan; the C entry
// rwkv_wkv_chunk_plan returns it for the wrapper to compare.
#pragma once

#include "decode_stream.cuh"  // mbarriers, bulk copies, acquire loads

namespace wkvc {

constexpr int kP = 16;  // tokens a chunk
constexpr int kCompute = 256;  // the compute threads (warps 0-7)
constexpr int kWarps = kCompute / 32;
constexpr int kThreads = kCompute + 32;  // then the producer warp
constexpr int kBarBytes = 64;  // the ring's full and empty mbarriers, at the start of shared memory
constexpr int kMaxStages = 4;
constexpr long long kSmemTwoPerSm = 115712;  // a block's share with two an SM
constexpr long long kSmemOnePerSm = 232448;

// T below which a launch runs the token recurrence instead of the two
// passes, by kind and heads (measured: tools/probe_wkv.py --crossover);
// -DRWKV_WKV_BELOW=n sets it for every shape (the probes' builds)
inline int recurrence_below(int kind, int BH) {
#ifdef RWKV_WKV_BELOW
  (void)kind;
  (void)BH;
  return RWKV_WKV_BELOW;
#else
  if (BH > 48) return 1 << 30;  // two rows a lane: the recurrence wins at every T measured
  if (kind == 7) return BH <= 16 ? 32 : 48;
  return BH <= 16 ? 48 : 64;
#endif
}

// [P, S] operator matrices a pair shares with all its row groups, and [P]
// columns each state row has of its own
__host__ __device__ constexpr int head_mats(int kind) { return kind == 7 ? 4 : 2; }
__host__ __device__ constexpr int row_mats(int kind) { return kind == 7 ? 3 : 2; }
// operands a token (the recurrence's staging)
__host__ __device__ constexpr int token_ops(int kind) { return kind == 7 ? 6 : 4; }

// floats of an item's operators: the shared part (head_mats matrices, then
// e^(lcum_last) [S]), then row_mats * P floats a state row
__host__ __device__ inline long long head_floats(int kind, int S) {
  return static_cast<long long>(head_mats(kind)) * kP * S + S;
}
__host__ __device__ inline long long item_floats(int kind, int S) {
  return head_floats(kind, S) + static_cast<long long>(row_mats(kind)) * kP * S;
}

// pass A's shared floats: [P, S + 4] buffers and [P, P + 1] matrices
inline long long pass_a_floats(int kind, int S) {
  const long long bufs = kind == 7 ? 10 : 8, mats = kind == 7 ? 8 : 2;
  return bufs * kP * (S + 4) + mats * kP * (kP + 1);
}
// pass B's: the state rows, the ring
inline long long pass_b_floats(int kind, int S, int R, int stages) {
  const long long stage = head_floats(kind, S) + static_cast<long long>(R) * row_mats(kind) * kP;
  return static_cast<long long>(R) * S + stages * stage;
}
// the recurrence's: the state rows, two tiles of P tokens' operands, tf (K5)
inline long long recurrence_floats(int kind, int S, int R) {
  return static_cast<long long>(R) * S + 2ll * kP * token_ops(kind) * S + S;
}
// the recurrence's rows a block: S / 8 lanes a row, so 2048 / S rows at
// once; twice that (two rows a lane, interleaved) where a head's row groups
// would need more blocks than the card has SMs
__host__ __device__ constexpr int recurrence_slots(int S) { return S < 2048 / S ? S : 2048 / S; }
inline int recurrence_rows(int S, int BH, int sms) {
  const int rows = recurrence_slots(S);
  return rows < S && static_cast<long long>(BH) * (S / rows) > sms ? 2 * rows : rows;
}

// field for field ops/chunked.py::WkvChunkPlan
struct Plan {
  long long p, recurrent, n_chunks, rows, groups, blocks_per_sm, grid, stages, smem_bytes,
      scratch_floats, crossover;
};
constexpr int kPlanFields = 11;

// 0, or cudaErrorInvalidValue for a shape no plan takes. The recurrence
// (T below the crossover) takes recurrence_rows rows a block, a block a
// (head, row group) pair, in an ordinary launch; the two passes a
// cooperative one.
inline int make_plan(int kind, int T, int BH, int S, int sms, Plan* pl) {
  if ((kind != 6 && kind != 7) || (S != 32 && S != 64 && S != 128) || T < 1 || BH < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int crossover = recurrence_below(kind, BH);
  if (T < crossover) {
    const int rows = recurrence_rows(S, BH, sms), groups = S / rows;
    *pl = Plan{kP, 1, 0, rows, groups, 1, static_cast<long long>(BH) * groups, 0,
               kBarBytes + 4 * recurrence_floats(kind, S, rows), 0, crossover};
    return 0;
  }
  const long long n_chunks = (T + kP - 1) / kP;
  const long long a_floats = pass_a_floats(kind, S);
  for (int bps = 2; bps >= 1; --bps) {
    const long long budget = bps == 2 ? kSmemTwoPerSm : kSmemOnePerSm;
    const int slots = sms * bps;
    int cap = S / 8 < slots / BH ? S / 8 : slots / BH;
    if (cap < 1) cap = 1;
    int groups = 1;
    while (groups * 2 <= cap) groups *= 2;
    const int rows = S / groups;
    for (int stages = kMaxStages; stages >= 2; --stages) {
      long long f = pass_b_floats(kind, S, rows, stages);
      if (f < a_floats) f = a_floats;
      const long long smem = kBarBytes + 4 * f;
      if (smem > budget) continue;
      const long long items = n_chunks * BH + static_cast<long long>(BH) * groups;
      *pl = Plan{kP, 0, n_chunks, rows, groups, bps, items < slots ? items : slots, stages, smem,
                 n_chunks * BH * item_floats(kind, S), crossover};
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A launch's pointers and plan. x: the token operands [T, BH, S] (wkv7: r,
// w, k, v, a, b; wkv6: r, k, v, w, then tf [BH, S] in x[4]).
struct Args {
  const float* x[6];
  const float* s0;
  float* y;
  float* s_out;
  float* scratch;
  unsigned* flags;
  int T, BH, n_chunks, rows, groups, stages, recurrent;
};

// ---- timing builds (-DRWKV_WKV_STAMPS, tools/probe_wkv.py --stamps) ----
//
// %globaltimer (ns) into stamps[]: [0] the kernel's entry (block 0), [1 + q]
// the end of pass-A item q (q < 512), [600 + c] / [700 + c] the last
// block's wait for chunk c done / its step done (c < 64), [800] its end.
#ifdef RWKV_WKV_STAMPS
__device__ unsigned long long stamps[801];
#define WKV_STAMP(i)                                                    \
  do {                                                                  \
    unsigned long long t_;                                              \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));              \
    stamps[i] = t_;                                                     \
  } while (0)
extern "C" int rwkv_wkv_stamps(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, stamps, sizeof(stamps)));
}
#else
#define WKV_STAMP(i) \
  do {               \
  } while (0)
#endif

// ---- the ready flags ---------------------------------------------------

// after the compute threads wrote an item's operators: their barrier, then
// thread 0's fence (cumulative over the writes the barrier ordered before
// it, as cooperative groups' grid barrier relies on; and for the readers'
// bulk copies) and the flag with release semantics. Only warp 0 waits for
// the fence.
__device__ __forceinline__ void publish(unsigned* flag, unsigned value) {
  stream::csync();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("fence.proxy.async.global;" ::: "memory");
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(value) : "memory");
  }
}

// thread 0's wait for a flag (acquire); a wait past ~2^33 cycles traps, so
// a plan the blocks disagree on fails the launch instead of hanging it
__device__ __forceinline__ void wait_flag(const unsigned* flag, unsigned value) {
  const long long t0 = clock64();
  while (stream::ld_acquire(flag) != value) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ---- pass A's helpers ---------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// the chunk's token operands ops[0..N) at [t][j] into dst[q] (stride ld),
// the decay operand `decay` as log max(w, floor); past T the identity
// token (a decay of 1, every other operand 0). Every compute thread loads
// all of its elements before it stores one.
template <int S, int N>
__device__ __forceinline__ void load_chunk(const Args& a, const int (&ops)[N], int decay,
                                           float floor, int c, int bh, float* const (&dst)[N],
                                           int ld) {
  constexpr int kPer = kP * S / kCompute;
  float v[kPer][N];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kCompute, t = idx / S, j = idx % S, tok = c * kP + t;
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[e][q] = tok < a.T ? a.x[ops[q]][(static_cast<size_t>(tok) * a.BH + bh) * S + j]
                          : (ops[q] == decay ? 1.f : 0.f);
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = threadIdx.x + e * kCompute, t = idx / S, j = idx % S;
#pragma unroll
    for (int q = 0; q < N; ++q)
      dst[q][t * ld + j] = ops[q] == decay ? logf(fmaxf(v[e][q], floor)) : v[e][q];
  }
}

// the in-chunk cumulative sum of lw [P, ld] into lc (float, or double where
// the sums' differences must keep their digits), a thread a column
template <int S, class T>
__device__ __forceinline__ void cumsum_cols(const float* lw, T* lc, int ld) {
  for (int j = threadIdx.x; j < S; j += kCompute) {
    T acc = 0;
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      acc += static_cast<T>(lw[t * ld + j]);
      lc[t * ld + j] = acc;
    }
  }
}

// C = A B for A [P, P] (a(m, k)) and B [P, N] in shared memory (row k at
// b + k * ldb), four neighbouring columns a thread and round, m fastest
// (neighbouring threads write neighbouring m of a transposed output);
// epi(m, n, sums of columns n .. n + 3)
template <int N, class AF, class Epi>
__device__ __forceinline__ void mm_strip(AF a, const float* b, int ldb, Epi epi) {
  for (int idx = threadIdx.x; idx < kP * N / 4; idx += kCompute) {
    const int m = idx & (kP - 1), n = (idx >> 4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const float am = a(m, k);
      const float4 bk = ld4(b + k * ldb + n);
      acc.x = fmaf(am, bk.x, acc.x);
      acc.y = fmaf(am, bk.y, acc.y);
      acc.z = fmaf(am, bk.z, acc.z);
      acc.w = fmaf(am, bk.w, acc.w);
    }
    epi(m, n, acc);
  }
}

// C = A B for A, B [P, P] (a(m, k), b(k, n)): one output a thread
template <class AF, class BF, class Epi>
__device__ __forceinline__ void mm_pp(AF a, BF b, Epi epi) {
  const int m = threadIdx.x >> 4, n = threadIdx.x & (kP - 1);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kP; ++k) acc = fmaf(a(m, k), b(k, n), acc);
  epi(m, n, acc);
}

// ---- pass B ------------------------------------------------------------------

// The ring's position: stage st (full barrier bars[st], empty barrier
// bars[kMaxStages + st]) in its use `phase` (parity), `uses` stages taken
// so far; advanced by counting, not dividing.
struct Ring {
  uint64_t* bars;
  int stages, st = 0, uses = 0;
  uint32_t phase = 0;
  __device__ uint64_t* full() const { return bars + st; }
  __device__ uint64_t* empty() const { return bars + kMaxStages + st; }
  __device__ void next() {
    ++uses;
    if (++st == stages) {
      st = 0;
      phase ^= 1u;
    }
  }
};

// The producer (lane 0 of warp 8): for each pass-B item of the block and
// each chunk, waits for the stage to be released and for the chunk's flag,
// then copies the pair's shared operators and the group's rows into it.
template <int kind, int S>
__device__ void produce(const Args& a, Ring ring, float* stages_base, unsigned want) {
  const long long head = head_floats(kind, S), rowf = row_mats(kind) * kP;
  const long long stage_f = head + a.rows * rowf;
  const uint32_t head_bytes = static_cast<uint32_t>(head * 4);
  const uint32_t row_bytes = static_cast<uint32_t>(a.rows * rowf * 4);
  const int G = gridDim.x, b_items = a.BH * a.groups;
  for (int q = G - 1 - static_cast<int>(blockIdx.x); q < b_items; q += G) {
    const int bh = q / a.groups, g = q - bh * a.groups;
    for (int c = 0; c < a.n_chunks; ++c, ring.next()) {
      // the stage's last use released (its phase before this one)
      if (ring.uses >= ring.stages) stream::wait_parity(ring.empty(), ring.phase ^ 1u);
      wait_flag(a.flags + 2 + static_cast<size_t>(c) * a.BH + bh, want);
      float* dst = stages_base + ring.st * stage_f;
      const float* src = a.scratch + (static_cast<size_t>(c) * a.BH + bh) * item_floats(kind, S);
      stream::arrive_expect_tx(ring.full(), head_bytes + row_bytes);
      stream::bulk_copy(dst, src, head_bytes, ring.full());
      stream::bulk_copy(dst + head, src + head + static_cast<long long>(g) * a.rows * rowf,
                        row_bytes, ring.full());
    }
  }
}

// Pass B's compute warps: each reads a chunk's shared operators (16 KB at
// S = 64) from the stage once for all its rows, and shared memory's
// bandwidth, not the FMAs, bounds a chunk step, so a block of 8 or 16 rows
// uses 4 warps (2 or 4 rows each, interleaved), more rows all 8.
__device__ __forceinline__ int pass_b_warps(int R) { return R >= 32 ? kWarps : kWarps / 2; }

// A compute warp's side of pass B: carries its rows (local rows warp + W q,
// W = pass_b_warps) of each of the block's items through the chunks. K
// supplies the chunk step K::template chunk<S, RB>(stage, tst, W, q0, y_c,
// T_left, BH) for the warp's rows q0 .. q0 + RB - 1 (y_c: the chunk's y at
// its first token, this block's first row; T_left: its tokens before T).
template <class K, int S>
__device__ void consume(const Args& a, Ring ring, float* sm) {
  constexpr int kind = K::kKind;
  const long long head = head_floats(kind, S), rowf = row_mats(kind) * kP;
  const int R = a.rows, G = gridDim.x, b_items = a.BH * a.groups;
  const long long stage_f = head + R * rowf;
  float* tst = sm;
  float* stages_base = tst + R * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = pass_b_warps(R), rw = R / W;  // rows a warp: 2, 4, 8 or 16
  if (warp >= W) return;
  for (int q = G - 1 - static_cast<int>(blockIdx.x); q < b_items; q += G) {
    const int bh = q / a.groups, g = q - bh * a.groups, i0 = g * R;
    const size_t srow = (static_cast<size_t>(bh) * S + i0) * S;
    for (int r = 0; r < rw; ++r) {
      const int ii = warp + W * r;
      for (int j = lane; j < S; j += 32) tst[ii * S + j] = a.s0[srow + ii * S + j];
    }
    __syncwarp();
    const bool stamp = q == 0 && threadIdx.x == 0;  // the last block's first item
    for (int c = 0; c < a.n_chunks; ++c, ring.next()) {
      stream::wait_parity(ring.full(), ring.phase);
      if (stamp && c < 64) WKV_STAMP(600 + c);
      const float* stage = stages_base + ring.st * stage_f;
      float* yc = a.y + (static_cast<size_t>(c) * kP * a.BH + bh) * S + i0;
      const int left = a.T - c * kP;
      if (rw == 2) {
        K::template chunk<S, 2>(stage, tst, W, 0, yc, left, a.BH);
      } else {
        for (int q0 = 0; q0 < rw; q0 += 4)
          K::template chunk<S, 4>(stage, tst, W, q0, yc, left, a.BH);
      }
      __syncwarp();
      if (stamp && c < 64) WKV_STAMP(700 + c);
      if (lane == 0) stream::arrive(ring.empty());
    }
    for (int r = 0; r < rw; ++r) {
      const int ii = warp + W * r;
      for (int j = lane; j < S; j += 32) a.s_out[srow + ii * S + j] = tst[ii * S + j];
    }
    __syncwarp();
  }
}

// ---- the token recurrence (T below the crossover) --------------------------

// 16 bytes from global to shared memory, asynchronously (cp.async); wait
// with copy_wait<N>: all but the last N committed groups landed
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(stream::smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [g rows, (g + 1) rows) of head bh, token by token: S / 8 lanes a row,
// each with 8 of its entries in registers, 32 / (S / 8) rows a warp, one or
// two rows a lane. The tokens' operands come into shared memory P tokens at
// a time, the next tile's copies in flight while a tile computes (with the
// state rows and tf in the first); K::template rows<S, NR>(ops, nt, tf,
// row, rs, p, mask, i, y, BH) runs NR rows (rs floats apart) through a tile
// of nt tokens (y: the first row's first token's y).
template <class K, int S>
__device__ void recurrence(const Args& a, int bh, int g, float* sm) {
  constexpr int nops = token_ops(K::kKind), LPR = S / 8, RPW = 32 / LPR;
  constexpr int kTile = kP * nops * S;
  const int R = a.rows, i0 = g * R, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, p = lane % LPR;
  const unsigned mask = (LPR == 32 ? 0xffffffffu : ((1u << LPR) - 1u) << (lane - p));
  float* tst = sm;
  float* tiles = tst + R * S;  // two of [P][nops][S]
  float* tf = tiles + 2 * kTile;
  const size_t srow = (static_cast<size_t>(bh) * S + i0) * S;
  auto issue = [&](int t0, float* buf) {
    const int nt = a.T - t0 < kP ? a.T - t0 : kP;
    for (int idx = tid; idx < nt * nops * S / 4; idx += kCompute) {
      const int e = idx * 4, t = e / (nops * S), rest = e - t * nops * S, q = rest / S;
      copy16(buf + e, a.x[q] + (static_cast<size_t>(t0 + t) * a.BH + bh) * S + rest - q * S);
    }
  };
  for (int idx = tid; idx < R * S / 4; idx += kCompute) copy16(tst + idx * 4, a.s0 + srow + idx * 4);
  if (K::kKind == 6)
    for (int idx = tid; idx < S / 4; idx += kCompute)
      copy16(tf + idx * 4, a.x[4] + static_cast<size_t>(bh) * S + idx * 4);
  issue(0, tiles);
  copy_commit();
  constexpr int kSlots = kWarps * RPW;
  const int ii = warp * RPW + lane / LPR;  // this lane's (first) row
  for (int t0 = 0, k = 0; t0 < a.T; t0 += kP, ++k) {
    const int nt = a.T - t0 < kP ? a.T - t0 : kP;
    if (t0 + kP < a.T) {
      issue(t0 + kP, tiles + ((k + 1) & 1) * kTile);
      copy_commit();
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    stream::csync();
    const float* ops = tiles + (k & 1) * kTile;
    float* y = a.y + (static_cast<size_t>(t0) * a.BH + bh) * S + i0 + ii;
    if (R > kSlots)
      K::template rows<S, 2>(ops, nt, tf, tst + ii * S, kSlots * S, p, mask, i0 + ii, y, a.BH);
    else if (ii < R)
      K::template rows<S, 1>(ops, nt, tf, tst + ii * S, kSlots * S, p, mask, i0 + ii, y, a.BH);
    stream::csync();  // the tile's buffer is free for the copies after the next
  }
  for (int idx = tid; idx < R * S; idx += kCompute) a.s_out[srow + idx] = tst[idx];
}

// the sum of v over the LPR lanes of a row (mask: their lanes)
template <int LPR>
__device__ __forceinline__ float row_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// ---- the kernel --------------------------------------------------------------

template <class K, int S>
__global__ void __launch_bounds__(kThreads, 2) twopass(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* sm = reinterpret_cast<float*>(smem_raw + kBarBytes);
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(a.flags);
  const int G = gridDim.x, b = blockIdx.x;
  const int b_items = a.BH * a.groups;
  const bool compute = threadIdx.x < kCompute;
  if (b == 0 && threadIdx.x == 0) WKV_STAMP(0);
  if (a.recurrent) {  // an ordinary launch: a block an item, no flags
    if (compute) recurrence<K, S>(a, b / a.groups, b % a.groups, sm);
    return;
  } else {
    const int a_items = a.n_chunks * a.BH;
    if (compute) {
      for (int q = b; q < a_items; q += G) {
        const int c = q / a.BH, bh = q - c * a.BH;
        K::template pass_a<S>(a, c, bh, sm,
                              a.scratch + static_cast<size_t>(q) * item_floats(K::kKind, S));
        publish(a.flags + 2 + q, epoch + 1);
        if (threadIdx.x == 0 && q < 512) WKV_STAMP(1 + q);
      }
    } else if (threadIdx.x == kCompute) {
      for (int s = 0; s < a.stages; ++s) {
        stream::mbar_init(bars + s, 1);
        stream::mbar_init(bars + kMaxStages + s, pass_b_warps(a.rows));
      }
      stream::fence_mbar_init();
    }
    __syncthreads();  // pass A's shared memory is free; the barriers are set
    const Ring ring{bars, a.stages};
    if (compute) {
      consume<K, S>(a, ring, sm);
    } else if (threadIdx.x == kCompute) {
      produce<K::kKind, S>(a, ring, sm + a.rows * S, epoch + 1);
    }
  }
  __syncthreads();
  if (b == G - 1 && threadIdx.x == 0) WKV_STAMP(800);
  if (threadIdx.x == 0 && atomicAdd(a.flags + 1, 1u) == static_cast<unsigned>(G) - 1) {
    a.flags[1] = 0;
    __threadfence();
    a.flags[0] = epoch + 1;
  }
}

// Plans the launch and runs it on `stream`: the recurrence an ordinary
// launch, the two passes a cooperative one (every block resident), refused
// where the card cannot hold blocks_per_sm blocks an SM at the plan's
// shared memory.
template <class K>
int launch(Args& a, int T, int BH, int S, int sms, void* stream) {
  Plan pl;
  int err = make_plan(K::kKind, T, BH, S, sms, &pl);
  if (err) return err;
  a.T = T;
  a.BH = BH;
  a.n_chunks = static_cast<int>(pl.n_chunks);
  a.rows = static_cast<int>(pl.rows);
  a.groups = static_cast<int>(pl.groups);
  a.stages = static_cast<int>(pl.stages);
  a.recurrent = static_cast<int>(pl.recurrent);
  const void* fn = S == 32   ? reinterpret_cast<const void*>(twopass<K, 32>)
                   : S == 64 ? reinterpret_cast<const void*>(twopass<K, 64>)
                             : reinterpret_cast<const void*>(twopass<K, 128>);
  const int smem = static_cast<int>(pl.smem_bytes);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  void* kargs[] = {&a};
  const dim3 grid(static_cast<unsigned>(pl.grid)), block(kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.recurrent) {
    if (e == cudaSuccess) e = cudaLaunchKernel(fn, grid, block, kargs, static_cast<size_t>(smem), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < pl.blocks_per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchCooperativeKernel(fn, grid, block, kargs, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wkvc

// The plan of a launch (kind 7: K2, 6: K5), ops/chunked.py::WkvChunkPlan's
// fields in order into out[11].
extern "C" int rwkv_wkv_chunk_plan(int kind, int T, int BH, int S, int sms, long long* out) {
  wkvc::Plan pl;
  const int err = wkvc::make_plan(kind, T, BH, S, sms, &pl);
  if (err) return err;
  const long long* f = &pl.p;
  for (int i = 0; i < wkvc::kPlanFields; ++i) out[i] = f[i];
  return 0;
}
