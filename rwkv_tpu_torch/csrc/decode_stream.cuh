// A block's input stream for the B=1 whole-model decode kernels K3
// (v7_decode.cu), K6 (v6_decode.cu), K7 (v5_decode.cu) and K8
// (v4_decode.cu) and the v6 tensor-parallel shard kernels K12 / K13
// (tp_v6.cu): a ring of shared-memory stages fed
// by 1-D bulk asynchronous copies (TMA, cp.async.bulk) that complete on a
// "full" mbarrier a stage, the generic parts of a kernel's stream plan (the
// ring's size, a block's share of a matrix's rows, the producer's walk over
// the plan), the consumers' side of the stream (waits, releases, the matvec
// of weight rows that lie in a stage), the quantization of a phase's input
// vector from an amax that the producing phase published, and the LM head
// phase the kernels end with.
//
// The block is warp-specialized: kConsumerWarps warps (kConsumers threads)
// compute, and one producer warp walks the block's stream of pieces in the
// order the consumers take them, issuing each piece as soon as its stage's
// "empty" mbarrier says every consumer warp is done with the piece that
// was there before. The producer never waits for the consumers' phases, so
// the copies run ahead of them by the ring's size, across the grid barriers
// between phases. The consumers synchronize among themselves on named
// barrier 1 (csync) and cross the grid on a barrier of their own
// (grid_sync): neither involves the producer, which may have finished and
// exited. The consumer-side block reductions, layer norm and quantization
// here repeat decode_common.cuh's arithmetic, in the same order, over the
// consumer threads.
//
// These steps sit on the kernels' critical path once a phase, every phase,
// and a kernel's code is larger than an SM's instruction cache: the index
// arithmetic of the stream's hot paths uses shifts, masks and running
// counters (the lane and group counts are powers of two), not integer
// division, which the card expands into ~20 instructions a use.
#pragma once

#include "decode_common.cuh"

namespace stream {

constexpr int kConsumers = 256;  // the compute threads of a block (its first warps)
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBlockThreads = kConsumers + 32;  // then one producer warp

// a barrier among the consumer threads only (named barrier 1)
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialized mbarriers visible to the async proxy
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this block's shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one arrival on bar (a consumer warp's release of a stage)
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of bar with this parity has completed. A wait that
// outlasts ~2^32 cycles (a stream whose consumers and producer disagree)
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  long long t0 = 0;
  for (int spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 0) {
      const long long t = clock64();
      if (t0 == 0) {
        t0 = t;
      } else if (t - t0 > (1ll << 32)) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier across the grid for one thread a block (the caller brackets it
// with csync, so the block's writes before it are ordered before the
// arrival's release, and its reads after it after the acquire): count is
// the barrier's word in global memory. Each block adds to it once with
// release semantics -- block 0 2^31 - (blocks - 1), every other block 1 --
// so the last arrival flips its top bit, which every block waits for with
// acquire loads. A barrier adds 2^31 in all, so the word needs no reset
// between barriers or launches (a grid of any size). A wait that outlasts
// ~2^33 cycles traps.
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned blocks) {
  const unsigned add = blockIdx.x == 0 ? 0x80000000u - (blocks - 1) : 1u;
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(count), "r"(add)
               : "memory");
  const long long t0 = clock64();
  while (((old ^ ld_acquire(count)) & 0x80000000u) == 0) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// ---- the stream plan's generic parts (a kernel's Layout / Plan / copies) ---
//
// A kernel's plan gives each block contiguous ranges of each phase's rows,
// in 4-row groups, cut into pieces of as many whole rows as fit a stage,
// each followed by the 16-byte window of its row scales, and its other
// inputs (vector rows, state) in pieces of their own; the pieces of a layer
// come in the order the consumers take them, as segments (runs of pieces),
// then those of the head. ops/megakernel.py mirrors every rule here.

constexpr size_t kSmemLimit = 232448;  // shared memory a block of the H100 may opt into
constexpr int kMaxStages = 16;         // mbarriers reserved
constexpr int kTargetStages = 4;       // the ring's stages where the largest piece allows
constexpr size_t kPlanBytes = 512;     // the block's plan, in shared memory
constexpr int kMinStages = 3;          // a block holds at most three pieces at once

__host__ __device__ inline size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }
__host__ __device__ inline size_t max2(size_t a, size_t b) { return a > b ? a : b; }

// Bytes at most of the scale window of n consecutive rows: whole 16-byte
// groups of four floats around them.
__host__ __device__ inline size_t win_bytes(int n) { return 16ull * ((n + 6) / 4); }

// Lanes sharing a row of row_bytes: max_lpr (lanes_for's cap in the big
// matvecs), down to the largest power of two that divides the row's 16-byte
// chunks -- the lanes matvec_rows gives the row.
__host__ __device__ inline int row_lanes(int row_bytes, int max_lpr) {
  int lpr = max_lpr;
  while (lpr > 1 && (row_bytes / 16) % lpr != 0) lpr >>= 1;
  return lpr;
}

// The block's lane groups of lpr lanes: rows it computes at once.
__host__ __device__ inline int group_rows(int lpr) { return kConsumerWarps * (32 / lpr); }

// The block's shared bytes from its plan on: the plan at plan_off
// (kPlanBytes), kMaxStages "full" and as many "empty" mbarriers, then the
// ring: `stages` stages of `stage` bytes, as many as fit below kSmemLimit,
// about kTargetStages of them, each at least the largest piece (`piece`
// bytes, rounded up to 16). A kernel refuses a ring of fewer than
// kMinStages stages.
struct Ring {
  size_t plan_off, bar_off, ring_off, stage, stages, smem;
  __host__ __device__ Ring(size_t plan_at, size_t piece) {
    plan_off = plan_at;
    bar_off = plan_off + kPlanBytes;  // full, then empty
    ring_off = round_up(bar_off + 16ull * kMaxStages, 128);
    const size_t ring = kSmemLimit > ring_off ? kSmemLimit - ring_off : 0;
    stage = max2(round_up(piece, 16), ring / kTargetStages / 16 * 16);
    stages = ring / stage;
    if (stages > kMaxStages) stages = kMaxStages;
    smem = ring_off + stages * stage;
  }
};

// Rows [r0, r1) of a matrix that one block takes (rb bytes, lpr lanes a
// row), n whole rows a piece. The block's lane groups take its rows in turn,
// from piece to piece: row r0 + j goes to lane group j % group_rows(lpr)
// (consumer warp (j % group_rows) / (32 / lpr)), so the warps work on
// different pieces at once and each sums its rows with the lanes, the
// chunk order and the shuffle tree of matvec_rows.
struct Rows {
  int r0, r1, n, rb, lpr;
  __host__ __device__ int pieces() const { return r1 > r0 ? (r1 - r0 + n - 1) / n : 0; }
  __host__ __device__ int c0(int k) const { return r0 + k * n; }
  __host__ __device__ int c1(int k) const { return r0 + (k + 1) * n < r1 ? r0 + (k + 1) * n : r1; }
};

// Block b's share of N rows of row_bytes (N a multiple of 4): whole 4-row
// groups, split as evenly as the grid allows (reverse: counted from the
// last block, so a phase's second matrix lands first on the blocks its
// first one left with fewer rows), lanes max_lpr at most a row; a piece
// holds as many rows as fit in a stage with their scale window (win). The
// arithmetic is 32-bit (a layer's kernels compute their plan at the start
// of a launch): N / 4 * blocks stays below 2^31 (part_fits), at the
// widest ~2.2M, the v7 head's 65536 rows over 132 blocks.
__host__ __device__ inline Rows part(int N, int blocks, int b, bool reverse, int row_bytes,
                                     bool win, int stage, int max_lpr) {
  const int q = N / 4, i = reverse ? blocks - 1 - b : b;
  Rows r;
  r.r0 = 4 * (q * i / blocks);
  r.r1 = 4 * (q * (i + 1) / blocks);
  r.rb = row_bytes;
  r.lpr = row_lanes(row_bytes, max_lpr);
  int n = stage / row_bytes;
  if (win)
    while (n > 1 && n * row_bytes + static_cast<int>(win_bytes(n)) > stage) --n;
  r.n = n;
  return r;
}

// Whether part's 32-bit arithmetic holds for `rows` rows over `blocks`.
inline bool part_fits(long long rows, int blocks) { return rows / 4 * blocks < (1ll << 31); }

// ---- the consumers' block-wide steps (decode_common.cuh's, on csync) ----

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  csync();
  float t = lane < kConsumerWarps ? red[lane] : 0.f;
  t = warp_sum(t);
  csync();
  return t;
}

template <int N>
__device__ __forceinline__ void block_max_n(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = warp_max(v[m]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < N; ++m) red[m * 32 + warp] = v[m];
  }
  csync();
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = warp_max(lane < kConsumerWarps ? red[m * 32 + lane] : 0.f);
  csync();
}

// Layer norm of src[0..n) into dst (both shared) over the consumers, as
// (x - mu) * rsqrt(var + eps) * w + b with population variance.
__device__ void layer_norm(const float* src, float* dst, const float* w, const float* b, int n,
                           float eps, float* red) {
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += kConsumers) s += src[c];
  const float mu = block_sum(s, red) / static_cast<float>(n);
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += kConsumers) {
    const float d = sub(src[c], mu);
    v += mul(d, d);
  }
  const float var = block_sum(v, red) / static_cast<float>(n);
  const float rs = rsqrtf(add(var, eps));
  for (int c = threadIdx.x; c < n; c += kConsumers)
    dst[c] = add(mul(mul(sub(src[c], mu), rs), w[c]), b[c]);
  csync();
}

struct NoWait {
  __device__ void operator()() const {}
};

// layer_norm of src[0..n) into dst, then act_n of the N vectors f(m, c)
// that the normalized values feed, with the normalizing pass also taking
// their amax: after dst[c] is written, g(c, dst[c]) runs in the same
// thread (it may store what f reads) and f(m, c) may read dst[c]. The
// values, the amax and the codes are layer_norm's and act_n's. ready()
// runs between the statistics and the normalizing pass, before w, b, g or
// f are read (a kernel waits there for the pieces that hold them).
template <int WF, int N, typename G, typename Fn, typename R = NoWait>
__device__ void layer_norm_act(const float* src, float* dst, const float* w, const float* b,
                               int n, float eps, float* red, G g, Fn f, act_t<WF>* xq,
                               int stride, float* dxs, R ready = R()) {
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += kConsumers) s += src[c];
  const float mu = block_sum(s, red) / static_cast<float>(n);
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += kConsumers) {
    const float d = sub(src[c], mu);
    v += mul(d, d);
  }
  const float var = block_sum(v, red) / static_cast<float>(n);
  const float rs = rsqrtf(add(var, eps));
  ready();
  float amax[N];
#pragma unroll
  for (int m = 0; m < N; ++m) amax[m] = 0.f;
  for (int c = threadIdx.x; c < n; c += kConsumers) {
    const float y = add(mul(mul(sub(src[c], mu), rs), w[c]), b[c]);
    dst[c] = y;
    g(c, y);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      if constexpr (WF == kBf16) {
        xq[m * stride + c] = f(m, c);
      } else {
        amax[m] = fmaxf(amax[m], fabsf(f(m, c)));
      }
    }
  }
  if constexpr (WF != kBf16) {
    block_max_n<N>(amax, red);
    float inv[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float dx = amax[m] / 127.0f;
      inv[m] = act_inv_scale(dx);
      if (threadIdx.x == 0) dxs[m] = dx;
    }
    for (int c = threadIdx.x; c < n; c += kConsumers) {
      // the codes first, then the stores: a byte store may alias what f reads
      int8_t q[N];
#pragma unroll
      for (int m = 0; m < N; ++m) q[m] = act_code(f(m, c), inv[m]);
#pragma unroll
      for (int m = 0; m < N; ++m) xq[m * stride + c] = q[m];
    }
  }
  csync();
}

// act_n (decode_common.cuh) over the consumers: the N vectors f(m, c) of n
// values each, quantized each as a whole (codes into xq[m * stride + c],
// scales into dxs[m]), or in the bf16 form staged in f32.
template <int WF, int N, typename Fn>
__device__ void act_n(Fn f, int n, act_t<WF>* xq, int stride, float* dxs, float* red) {
  if constexpr (WF == kBf16) {
    for (int c = threadIdx.x; c < n; c += kConsumers) {
#pragma unroll
      for (int m = 0; m < N; ++m) xq[m * stride + c] = f(m, c);
    }
  } else {
    float amax[N];
#pragma unroll
    for (int m = 0; m < N; ++m) amax[m] = 0.f;
    for (int c = threadIdx.x; c < n; c += kConsumers) {
#pragma unroll
      for (int m = 0; m < N; ++m) amax[m] = fmaxf(amax[m], fabsf(f(m, c)));
    }
    block_max_n<N>(amax, red);
    float inv[N];
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const float dx = amax[m] / 127.0f;
      inv[m] = act_inv_scale(dx);
      if (threadIdx.x == 0) dxs[m] = dx;
    }
    for (int c = threadIdx.x; c < n; c += kConsumers) {
      // the codes first, then the stores: a byte store may alias what f reads
      int8_t q[N];
#pragma unroll
      for (int m = 0; m < N; ++m) q[m] = act_code(f(m, c), inv[m]);
#pragma unroll
      for (int m = 0; m < N; ++m) xq[m * stride + c] = q[m];
    }
  }
  csync();
}

// n floats (a multiple of 4, 16-byte aligned) that other blocks wrote
// before a grid barrier, from global into shared memory: every load of a
// thread in flight at once (L2 reads, past L1)
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n) {
  constexpr int kBatch = 8;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  const int n4 = n >> 2;
  for (int base = threadIdx.x; base < n4; base += kBatch * kConsumers) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + k * kConsumers < n4) v[k] = __ldcg(s4 + base + k * kConsumers);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + k * kConsumers < n4) d4[base + k * kConsumers] = v[k];
  }
}

// One 16-byte chunk of a weight row against the activations x (int8 codes
// or f32), accumulated in the order matvec_rows (common.cuh) uses.
template <int WF>
__device__ __forceinline__ typename FormTraits<WF>::Acc dot_chunk(
    int4 w, const act_t<WF>* x, int chunk, typename FormTraits<WF>::Acc a) {
  if constexpr (WF == kBf16) {
    const float4* xb = reinterpret_cast<const float4*>(x);
    const float4 x0 = xb[2 * chunk], x1 = xb[2 * chunk + 1];
    a = fmaf(bf16_lo(w.x), x0.x, a);
    a = fmaf(bf16_hi(w.x), x0.y, a);
    a = fmaf(bf16_lo(w.y), x0.z, a);
    a = fmaf(bf16_hi(w.y), x0.w, a);
    a = fmaf(bf16_lo(w.z), x1.x, a);
    a = fmaf(bf16_hi(w.z), x1.y, a);
    a = fmaf(bf16_lo(w.w), x1.z, a);
    a = fmaf(bf16_hi(w.w), x1.w, a);
  } else if constexpr (WF == kInt4) {
    const int4* xb = reinterpret_cast<const int4*>(x);
    const int4 xl = xb[2 * chunk], xh = xb[2 * chunk + 1];
    a = __dp4a(w4_lo16(w.x), xl.x, a);
    a = __dp4a(w4_lo16(w.y), xl.y, a);
    a = __dp4a(w4_lo16(w.z), xl.z, a);
    a = __dp4a(w4_lo16(w.w), xl.w, a);
    a = __dp4a(w4_hi16(w.x), xh.x, a);
    a = __dp4a(w4_hi16(w.y), xh.y, a);
    a = __dp4a(w4_hi16(w.z), xh.z, a);
    a = __dp4a(w4_hi16(w.w), xh.w, a);
  } else {
    const int4 xv = reinterpret_cast<const int4*>(x)[chunk];
    a = __dp4a(w.x, xv.x, a);
    a = __dp4a(w.y, xv.y, a);
    a = __dp4a(w.z, xv.z, a);
    a = __dp4a(w.w, xv.w, a);
  }
  return a;
}

// The dot of one row (wr, 16-byte chunks) with x in lane sub_lane of the
// row's lpr lanes: chunks sub_lane, sub_lane + lpr, ... in order (the int
// forms' exact sum in two chains). One copy of this code serves every
// matvec of a form, so it stays in the instruction cache from phase to
// phase.
template <int WF>
__device__ __noinline__ typename FormTraits<WF>::Acc row_dot(const int4* wr, const act_t<WF>* x,
                                                            int per_lane, int lpr, int sub_lane) {
  using Acc = typename FormTraits<WF>::Acc;
  Acc a = 0, b = 0;
#pragma unroll 4
  for (int k = 0; k < per_lane; ++k) {
    const int chunk = k * lpr + sub_lane;
    if (WF == kBf16 || (k & 1) == 0) {
      a = dot_chunk<WF>(wr[chunk], x, chunk, a);
    } else {
      b = dot_chunk<WF>(wr[chunk], x, chunk, b);
    }
  }
  if constexpr (WF != kBf16) a += b;
  return a;
}

// Rows [0, n) of width K in form WF, stored one after another in shared
// memory at `rows`. The block's lane groups of lpr lanes (the largest power
// of two up to max_lpr dividing the row's 16-byte chunks, as in
// matvec_rows) take the rows in turn, lane group t (warp t / (32 / lpr))
// the rows j with (j + skip) % groups == t; lane i of a group sums chunks
// i, i + lpr, ... in order (row_dot) and the lanes meet in a shuffle tree
// -- the same sum, in the same order, as matvec_rows gives the row.
// xsel(j) gives row j's activations; epi(j, acc) its exact int32 dot (int
// forms) or f32 dot (bf16).
template <int WF, typename XSel, typename Epi>
__device__ __forceinline__ void smem_rows(const unsigned char* rows, int n, int K, int max_lpr,
                                          int skip, XSel xsel, Epi epi) {
  using Acc = typename FormTraits<WF>::Acc;
  const int row_bytes = static_cast<int>(form_bytes(WF, K));
  const int nchunks = row_bytes >> 4;
  int lpr = max_lpr;  // a power of two, as every count below
  while (lpr > 1 && (nchunks & (lpr - 1)) != 0) lpr >>= 1;
  const int lg = __ffs(lpr) - 1;
  const int per_lane = nchunks >> lg;
  const int lane = threadIdx.x & 31;
  const int sub_lane = lane & (lpr - 1), gpw = 32 >> lg, groups = kConsumerWarps * gpw;
  const int t = (threadIdx.x >> 5) * gpw + (lane >> lg);  // this lane group
  const int first = (t - (skip & (groups - 1)) + groups) & (groups - 1);
  for (int base = 0; base < n; base += groups) {  // warp-uniform
    const int row = base + first;
    Acc a = 0;
    if (row < n)
      a = row_dot<WF>(reinterpret_cast<const int4*>(rows + static_cast<size_t>(row) * row_bytes),
                      xsel(row), per_lane, lpr, sub_lane);
    for (int off = lpr >> 1; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (sub_lane == 0 && row < n) {
      if constexpr (WF == kInt4) {
        epi(row, a >> 4);
      } else {
        epi(row, a);
      }
    }
  }
}

// |v| into a block-local amax slot (shared), as the bits of a non-negative
// float: their integer order is the floats' order, so the max is exact in
// any order.
__device__ __forceinline__ void note_amax(unsigned* slot, float v) {
  atomicMax(slot, __float_as_uint(fabsf(v)));
}

// The N vectors of n values each (n a multiple of 4), one after another in
// global memory at src, that other blocks wrote before a grid barrier --
// the input of a phase whose amax (amax[m], global) the producing phase
// published -- into xq (element m * n + c): the int forms write each code
// in one pass, with dx = amax / 127 and the code exactly as quantize_n
// gives them and no block reduction; the bf16 form stages the f32 values.
// Every load of a thread is in flight at once.
template <int WF, int N>
__device__ void act_published(const float* src, int n, act_t<WF>* xq, float* dxs,
                              const unsigned* amax) {
  constexpr int kBatch = 8;
  unsigned bits[N];
#pragma unroll
  for (int m = 0; m < N; ++m) bits[m] = WF == kBf16 ? 0u : __ldcg(amax + m);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const int n4 = N * n >> 2;
  float inv[N];
  for (int base = threadIdx.x; base < n4; base += kBatch * kConsumers) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (base + k * kConsumers < n4) v[k] = __ldcg(s4 + base + k * kConsumers);
    if (base == static_cast<int>(threadIdx.x)) {
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float dx = __uint_as_float(bits[m]) / 127.0f;
        inv[m] = act_inv_scale(dx);
        if (WF != kBf16 && threadIdx.x == 0) dxs[m] = dx;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e4 = base + k * kConsumers;
      if (e4 < n4) {
        if constexpr (WF == kBf16) {
          reinterpret_cast<float4*>(xq)[e4] = v[k];
        } else {
          float iv = inv[0];
#pragma unroll
          for (int m = 1; m < N; ++m)
            if (4 * e4 >= m * n) iv = inv[m];
          char4 q;
          q.x = act_code(v[k].x, iv);
          q.y = act_code(v[k].y, iv);
          q.z = act_code(v[k].z, iv);
          q.w = act_code(v[k].w, iv);
          reinterpret_cast<char4*>(xq)[e4] = q;
        }
      }
    }
  }
  csync();
}

// ---- the producer and the consumers' side of the stream --------------------

// The producer warp: walks block b's stream piece by piece, in the order
// the consumers take it -- segments 0 .. LayerSegs - 1 of each of n_layer
// layers, then segments LayerSegs .. AllSegs - 1 (the head), pl.count(seg)
// pieces each --, waits until the piece's stage is empty (every consumer
// warp released the piece before it there), then posts the piece's bytes
// on the stage's full barrier and issues its copies, a lane a copy: copy
// (layer, seg, idx, i, &src, &dst, &bytes) gives copy i of a piece (false
// past its last; a piece has at most 32).
template <int LayerSegs, int AllSegs, typename Plan, typename Copy>
__device__ void produce(const Plan& pl, int n_layer, int stages, unsigned char* ring, size_t stage,
                        uint64_t* full, uint64_t* empty, Copy copy) {
  const int lane = threadIdx.x & 31;
  int layer = 0, seg = 0, idx = 0;
  int s = 0;           // piece j's stage: j = round * stages + s
  uint32_t round = 0;
  for (int j = 0; seg != AllSegs; ++j) {
    if (j >= stages) wait_parity(&empty[s], (round - 1) & 1u);
    const void* src = nullptr;
    uint32_t at = 0, bytes = 0;
    const bool mine = copy(layer, seg, idx, lane, &src, &at, &bytes);
    const uint32_t total = __reduce_add_sync(0xffffffffu, mine ? bytes : 0u);
    if (lane == 0) arrive_expect_tx(&full[s], total);
    __syncwarp();
    if (mine) bulk_copy(ring + static_cast<size_t>(s) * stage + at, src, bytes, &full[s]);
    if (++s == stages) {
      s = 0;
      ++round;
    }
    ++idx;
    while (seg < AllSegs && idx >= pl.count(seg)) {
      idx = 0;
      ++seg;
      if (seg == LayerSegs && layer + 1 < n_layer) {
        ++layer;
        seg = 0;
      }
    }
  }
}

// The consumers' side of the ring, in piece order: wait() for the next
// piece (its stage), release(k) of a warp's k oldest held pieces, and
// rows<FF>(r, K, xsel, epi) for a matrix's rows r in form FF (width K),
// piece by piece: epi(row, acc, d) with d the row's scale in its window.
struct Stream {
  unsigned char* ring;
  size_t stage;
  int stages;
  uint64_t* full;
  uint64_t* empty;
  int next = 0;          // the stage of the piece the block waits for next
  uint32_t parity = 0;   // and its full barrier's phase parity
  int released = 0;      // the stage of the oldest piece not yet released

  __device__ const unsigned char* wait() {
    const int s = next;
    wait_parity(&full[s], parity);
    if (++next == stages) {
      next = 0;
      parity ^= 1u;
    }
    return ring + static_cast<size_t>(s) * stage;
  }

  __device__ void release(int k) {
    __syncwarp();
    for (int i = 0; i < k; ++i) {
      if ((threadIdx.x & 31) == 0) arrive(&empty[released]);
      if (++released == stages) released = 0;
    }
  }

  template <int FF, typename XSel, typename Epi>
  __device__ void rows(const Rows& r, int K, XSel xsel, Epi epi) {
    const int g = group_rows(r.lpr);
    for (int k = 0; k < r.pieces(); ++k) {
      const int c0 = r.c0(k), n = r.c1(k) - c0, w0 = c0 & ~3;
      const unsigned char* st = wait();
      const float* win = reinterpret_cast<const float*>(st + static_cast<size_t>(n) * r.rb);
      smem_rows<FF>(st, n, K, r.lpr, (c0 - r.r0) & (g - 1), [&](int j) { return xsel(c0 + j); },
                    [&](int j, auto acc) { epi(c0 + j, acc, win + (c0 + j - w0)); });
      release(1);
    }
  }
};

// The block-local amax slots (shared) into the layer's global ones, N of
// them, clearing the local ones (int forms; after a phase's epilogues).
template <int N>
__device__ __forceinline__ void publish_amax(unsigned* local, unsigned* global) {
  csync();
  if (threadIdx.x < N) {
    const unsigned v = local[threadIdx.x];
    if (v != 0u) atomicMax(global + threadIdx.x, v);
    local[threadIdx.x] = 0u;
  }
}

// The LM head after the last layer's barrier: ln_out of the residual x_g
// (C floats) with its piece (ln_out w | b) from the stream, the normalized
// vector quantized as a whole (int forms: int8 rows with row scales; bf16:
// staged in f32), then the block's head rows from the stream into logits.
// Shared: xs and xl C floats each, red 256 floats, dxs one, q8 C
// activations.
template <int LF>
__device__ void head_phase(Stream& cs, const Rows& head, const float* x_g, int C, float* xs,
                           float* xl, float* red, float* dxs, act_t<LF>* q8, float* logits) {
  load_vec(xs, x_g, C);
  csync();
  {
    const float* ln = reinterpret_cast<const float*>(cs.wait());  // ln_out w | b
    layer_norm_act<LF, 1>(xs, xl, ln, ln + C, C, 1e-5f, red, [](int, float) {},
                          [&](int, int c) { return xl[c]; }, q8, 0, dxs);
    cs.release(1);
  }
  cs.rows<LF>(head, C, [&](int) { return q8; },
              [&](int row, auto acc, const float* d) { logits[row] = dequant(acc, dxs[0], d); });
}

}  // namespace stream
