// Pieces shared by the tensor-parallel decode kernels K11 (tp_v7.cu) and
// K14 (tp_v45.cu): the two split contractions of a shard (the attention
// output's and the FFN value's, each a full-C partial that the caller's
// all-reduce sums over the shards), the grid size and the cooperative
// launch; the grid size and launch of the stream kernels K10 (tp_v7.cu),
// K12, K13 and K15 (tp_v6.cu), whose blocks are wider (their producer
// warp, decode_stream.cuh).
#pragma once

#include "decode_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

constexpr int kTpThreads = 256;

// The attention output on one shard: xo (the shard's CL channels, global)
// quantized as a whole by every block (JAX quantizes the shard's local
// slice with its own scale), then the C rows of out [C, CL] into part.
template <int WF>
__device__ void tp_out_rows(const float* xo, const int8_t* out, const float* out_d, float* part,
                            int C, int CL, float* red, float* dxs, act_t<WF>* q8) {
  act_n<WF, 1>([&](int, int c) { return xo[c]; }, CL, q8, 0, dxs, red);
  matvec_grid<WF, 1>(out, C, CL, 1, [&](int, int) { return q8; },
      [&](int row, int, auto acc) { part[row] = dequant(acc, dxs[0], out_d + row); },
      lanes_for(CL, WF));
}

// The FFN value on one shard: per tile t of nf, the tile's FT = FL / nf
// relu^2 keys h[t * FT, (t + 1) * FT) (global) quantized as a whole (JAX's
// mv_big per tile), and the C rows of the tile's fv [C, FT] summed into
// part in tile order. A row of every tile lands on the same warp (same
// rows, width and lanes each time), so the sums need no grid barrier.
template <int WF>
__device__ void tp_fv_tiles(const float* h, const int8_t* fv, const float* fv_d, float* part,
                            int C, int FL, int nf, float* red, float* dxs, act_t<WF>* q8) {
  const int FT = FL / nf;
  for (int t = 0; t < nf; ++t) {
    act_n<WF, 1>([&](int, int c) { return h[t * FT + c]; }, FT, q8, 0, dxs, red);
    matvec_grid<WF, 1>(fv + form_bytes(WF, static_cast<size_t>(t) * C * FT), C, FT, 1,
        [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          const float y = dequant(acc, dxs[0], fv_d + row);
          part[row] = t == 0 ? y : add(part[row], y);
        },
        lanes_for(FT, WF));
    __syncthreads();  // the next tile's activations overwrite q8 and dxs
  }
}

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

inline int tp_grid_blocks(const void* kernel, size_t smem) {
  return tp_grid_blocks_of(kernel, smem, kTpThreads);
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

template <typename A>
int tp_launch(const void* kernel, A& args, size_t smem, int grid_blocks, void* stream) {
  return tp_launch_of(kernel, args, smem, grid_blocks, kTpThreads, stream);
}

// Shared memory a TP launch reserves: `floats` floats, then n activations
// (int8 codes, or f32 in the bf16 form), rounded up to 16 bytes.
inline size_t tp_smem(size_t floats, size_t n, int wf) {
  const size_t act = (wf == kBf16 ? sizeof(float) : 1) * n;
  return floats * sizeof(float) + ((act + 15) / 16) * 16;
}
