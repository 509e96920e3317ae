// What the tensor-parallel shard kernels (K10, tp_v7.cu; K11, K12, K13
// and K15, tp_v6.cu; K14, tp_v45.cu) have in common beside
// decode_stream.cuh: the launch's layout as the host computes it, the start
// of a launch (the producer warp's lane 0 initializes the mbarriers and
// computes the block's plan while the consumers take x's layer-norm
// statistics), the copies of a piece of matrix rows, the timing build's
// first stamps, the grid size and the cooperative launch. A launch is one
// layer, so its start is on the critical path.
#pragma once

#include "decode_stream.cuh"

#include <initializer_list>

// The launch's shared-memory layout, computed on the host and passed in the
// kernel's arguments, so that no thread redoes its 64-bit divisions:
// activations at act_off, the block's plan at plan_off, the mbarriers at
// bar_off, `stages` stages of `stage` bytes from ring_off, smem in all;
// vector rows a piece, and (K10) runs of a head's lora2 rows a piece.
struct TpLayout {
  uint32_t act_off, plan_off, bar_off, ring_off, stage, stages, smem;
  int vec_rows, l2_runs;
};

template <typename L>
TpLayout tp_layout(const L& lo) {
  TpLayout t;
  t.act_off = static_cast<uint32_t>(lo.act_off);
  t.plan_off = static_cast<uint32_t>(lo.plan_off);
  t.bar_off = static_cast<uint32_t>(lo.bar_off);
  t.ring_off = static_cast<uint32_t>(lo.ring_off);
  t.stage = static_cast<uint32_t>(lo.stage);
  t.stages = static_cast<uint32_t>(lo.stages);
  t.smem = static_cast<uint32_t>(lo.smem);
  t.vec_rows = lo.vec_rows;
  t.l2_runs = 0;
  return t;
}

// The start of a launch: the producer warp's lane 0 initializes the
// mbarriers and computes the block's plan, the warp arrives on named
// barrier 2 without waiting and starts the stream; the consumers begin
// their first phase on what needs neither (x and its layer norm's
// statistics) and wait there before their first piece.
__device__ __forceinline__ void stream_ready_arrive() {
  asm volatile("bar.arrive 2, 288;" ::: "memory");
}
__device__ __forceinline__ void stream_ready_wait() {
  asm volatile("bar.sync 2, 288;" ::: "memory");
}

__device__ __forceinline__ void init_mbarriers(uint64_t* full, uint64_t* empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    stream::mbar_init(&full[s], 1);
    stream::mbar_init(&empty[s], stream::kConsumerWarps);
  }
  stream::fence_mbar_init();
}

// Vector rows a piece: as many as fit a stage, at most a phase's `n`.
__host__ __device__ inline int vec_rows_for(size_t stage, int C, int n) {
  const int r = static_cast<int>(stage / (4ull * C));
  return r < n ? r : n;
}

// Piece idx of r's rows from base (bytes), then the 16-byte window of
// their floats in win (scales, or maa5) where win is not null: copy i of
// it (a 16-byte multiple from a 16-byte aligned src to byte dst of the
// stage), false past its last.
__host__ __device__ inline bool rows_copy(const stream::Rows& r, const void* base_v,
                                          const float* win, int idx, int i, const void** src,
                                          uint32_t* dst, uint32_t* bytes) {
  const unsigned char* base = static_cast<const unsigned char*>(base_v);
  const int c0 = r.c0(idx), c1 = r.c1(idx);
  const uint32_t n = static_cast<uint32_t>((c1 - c0) * r.rb);
  if (i == 0) {
    *src = base + static_cast<size_t>(c0) * r.rb;
    *dst = 0u;
    *bytes = n;
    return true;
  }
  if (i == 1 && win != nullptr) {
    const int w0 = c0 & ~3, w1 = (c1 + 3) & ~3;
    *src = win + w0;
    *dst = n;
    *bytes = static_cast<uint32_t>(4 * (w1 - w0));
    return true;
  }
  return false;
}

// every pointer the stream copies from or the consumers read in float4s is
// 16-byte aligned
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  return true;
}

#ifdef RWKV_PHASE_TIMES
// The timing build's first stamps: the kernel's entry (t, read first
// thing), then the end of its prologue twice -- a phase "P" (the plan, the
// mbarriers) with no barrier after it.
#define PHASE_ENTRY(t)                                   \
  do {                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) marks[0] = (t); \
    n_marks = 1;                                         \
    PHASE_MARK();                                        \
  } while (0)
#define ENTRY_TIME(t) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t))
#else
#define PHASE_ENTRY(t) \
  do {                 \
  } while (0)
#define ENTRY_TIME(t) \
  do {                \
  } while (0)
#endif

// Blocks a cooperative launch of `kernel` with `smem` bytes of shared
// memory and `threads` threads a block uses (one per SM), or a negative
// CUDA error code (0: it does not fit on an SM).
inline int tp_grid_blocks_of(const void* kernel, size_t smem, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return (per_sm > 1 ? 1 : per_sm) * sms;
}

// One cooperative launch of `kernel` on its argument struct, `threads`
// threads a block; returns the CUDA error.
template <typename A>
int tp_launch_of(const void* kernel, A& args, size_t smem, int grid_blocks, int threads,
                 void* stream) {
  if (grid_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  void* kargs[] = {&args};
  cudaError_t err = set_smem(kernel, smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel, dim3(grid_blocks), dim3(threads), kargs, smem,
                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
