// K9: block-format quantized matmul, y[M, N] = x[M, K] @ W^T with the
// weight kept in its quantized form in device memory.
//
// Replaces rwkv_tpu/ops/kernels.py::_pallas_quant_matmul (call :365), the
// bodies _kernel_plain (:251), _kernel_min (:278), _make_kernel4 (:282)
// and _kernel_rowwise (:266), reached through quant_matmul. One template
// instance per form (the `form` argument of the C entry):
//   0 plain      W[n, k] = f32(q * d[n, k/32])             (Q5_0, Q8_0, q8)
//   1 min        W[n, k] = f32(f32(q * d) + m[n, k/32])    (Q5_1, Q4_K, Q5_K)
//   2 pack4      plain on nibbles, two's complement codes   (Q4_0)
//   3 pack4_min  min on nibbles, unsigned codes 0..15        (Q4_1)
//   4 rowwise    x rounded to bf16 (RNE), W = q exactly, y = (sum) * d[n]  (q8r)
// Codes are int8 [N, K] with K contiguous (the port's layout); pack4 holds
// [N, K/2] bytes where byte j of a 32-block's 16 bytes has code j in its
// low nibble and code j + 16 in its high nibble (ggml's own order).
//
// Bound on this card: the bytes (x, codes, scales, y) over HBM bandwidth,
// or 2*M*K*N operations over the tensor cores' peak for the product's
// precision: 495 TFLOP/s of TF32 for the f32 forms (no f32-accurate
// product on this card can run faster), 989 TFLOP/s of bf16 for rowwise,
// whose products are exact in bf16. For the decode shape (M <= 8) the
// bytes; at M = 256 launch latency and the time to fill a pipeline.
// Design (route, tile and split from ops/kernels.py::matmul_plan):
//  - M > 8 (block_gemm), on the bf16 tensor cores (mma.sync m16n8k16,
//    f32 accumulation, fragments by ldmatrix). A BM x BN tile a block of
//    2 x 4 warps (64x64, 32x32; 32x16 on 2 x 2), 64-column K stages (two
//    quant blocks) through a 3-stage cp.async ring: x as f32, the raw
//    codes and the stage's scales and mins, zero-filled past K (K % 64 ==
//    32) and past the ragged M and N edges. Each stage is converted once
//    in shared memory into the tensor cores' operands: the codes as bf16
//    (exact: |q| <= 127), x as bf16 -- rounded (RNE) for rowwise, which is
//    that form's input, and for the f32 forms split into three parts, hi =
//    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry x's
//    24-bit significand (the differences are exact in f32).
//    rowwise: one pass, y = sum * d[n] at the end.
//    f32 forms: per quant block, the three passes (lo, mid, hi) sum
//    x . q exactly-rounded in f32, then acc = fma(d, part, acc), and for
//    the min forms acc = fma(m, sum of x over the block, acc). This is
//    design (b) of the redesign: W is never formed, so its rounding
//    f32(q*d) + m is not the JAX package's; the result still stays within
//    1e-5 of sum |x||W| (the band chip_smoke.py, the card tests and the CPU
//    emulation in tests/test_torch_matmul_routes.py hold; measured ~3e-7).
//    It was taken over design (a), 3xTF32 on the dequantized W (the
//    rounding of W kept), because (a) needs six tf32 m16n8k8 products for
//    every bf16 m16n8k16 that (b) needs three of, and a dequantize and
//    split of every W element a stage; on the H100 it ran slower than (b)
//    at every M = 256 shape of the main path (PERF.md, Findings).
//    Split-K over a cluster of up to 8 blocks, f32 partials summed in rank
//    order (gemm_common.cuh): two launches give the same bits.
//  - M <= 8 (block_gemv): W dequantized in registers with the plain
//    version's roundings (__fmul_rn / __fadd_rn: nvcc would contract
//    q*d + m into one FMA), f32 FMAs; `lanes` lanes an output row (a power
//    of two), each lane loading whole chunks of 16 codes (16 int8 bytes,
//    or 8 nibble bytes: half a quant block), up to 4 in flight, with their
//    scales; x read through the L1 (bf16-rounded for rowwise); a shuffle
//    reduction ends the row. Four warps a block, one row a lane group.
#include "common.cuh"
#include "gemm_common.cuh"

#include <cuda_bf16.h>

#include <type_traits>

namespace {

enum Form { kPlain = 0, kMin = 1, kPack4 = 2, kPack4Min = 3, kRowwise = 4 };

template <int F> struct Traits {
  static constexpr bool kHasMin = F == kMin || F == kPack4Min;
  static constexpr bool kNibbles = F == kPack4 || F == kPack4Min;
  static constexpr bool kSigned = F == kPack4;
  static constexpr bool kRow = F == kRowwise;
};

template <int F>
__device__ __forceinline__ float dequant(int code, float d, float m) {
  if (Traits<F>::kRow) return static_cast<float>(code);
  const float w = __fmul_rn(static_cast<float>(code), d);
  return Traits<F>::kHasMin ? __fadd_rn(w, m) : w;
}

// nibble -> code: two's complement (Q4_0) or unsigned (Q4_1)
template <int F>
__device__ __forceinline__ int nibble(unsigned v) {
  return Traits<F>::kSigned ? static_cast<int>(v ^ 8u) - 8 : static_cast<int>(v);
}

__device__ __forceinline__ float stage_x(float v, bool row) {
  return row ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ---- M <= 8 ---------------------------------------------------------------

constexpr int kGemvThreads = 128;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvRows = 8;   // largest M this route takes
constexpr int kMaxChunks = 4;  // code chunks a lane has in flight

template <int F>
__global__ void __launch_bounds__(kGemvThreads)
block_gemv(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ d, const float* __restrict__ m,
           float* __restrict__ y, int M, int K, int N, int lanes) {
  // a chunk: 16 codes -- 16 int8 bytes, or 8 nibble bytes (half a 32-code
  // block: bytes 8h .. 8h + 7 hold codes 8h + j low and 8h + 16 + j high)
  using Chunk = std::conditional_t<Traits<F>::kNibbles, int2, int4>;
  const int lane = threadIdx.x & 31;
  const int sub = lane % lanes, grp = lane / lanes, gpw = 32 / lanes;
  const int n = (blockIdx.x * kGemvWarps + (threadIdx.x >> 5)) * gpw + grp;
  const int nb = K / 32;
  const int nchunks = K / 16;
  const int per_lane = (nchunks + lanes - 1) / lanes;
  float acc[kGemvRows];
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) acc[r] = 0.f;

  if (n < N) {
    const Chunk* wr = reinterpret_cast<const Chunk*>(q + static_cast<size_t>(n) * K /
                                                       (Traits<F>::kNibbles ? 2 : 1));
    for (int j0 = 0; j0 < per_lane; j0 += kMaxChunks) {
      Chunk wv[kMaxChunks];
      float dv[kMaxChunks], mv[kMaxChunks];
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = (j0 + j) * lanes + sub;
        if (j0 + j < per_lane && c < nchunks) {
          wv[j] = __ldg(wr + c);
          dv[j] = Traits<F>::kRow ? 0.f : __ldg(d + static_cast<size_t>(n) * nb + c / 2);
          mv[j] = Traits<F>::kHasMin ? __ldg(m + static_cast<size_t>(n) * nb + c / 2) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = (j0 + j) * lanes + sub;
        if (j0 + j < per_lane && c < nchunks) {
          // w[i] is the weight at x column xcol(i)
          float w[16];
          int k_lo, k_hi;  // x columns of w[0..7] and w[8..15]
          if constexpr (Traits<F>::kNibbles) {
            const unsigned words[2] = {static_cast<unsigned>(wv[j].x),
                                       static_cast<unsigned>(wv[j].y)};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const unsigned byte = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
              w[i] = dequant<F>(nibble<F>(byte & 0xFu), dv[j], mv[j]);
              w[i + 8] = dequant<F>(nibble<F>(byte >> 4), dv[j], mv[j]);
            }
            k_lo = 32 * (c / 2) + 8 * (c & 1);
            k_hi = k_lo + 16;
          } else {
            const unsigned words[4] = {
                static_cast<unsigned>(wv[j].x), static_cast<unsigned>(wv[j].y),
                static_cast<unsigned>(wv[j].z), static_cast<unsigned>(wv[j].w)};
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const unsigned byte = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
              w[i] = dequant<F>(static_cast<int>(static_cast<int8_t>(byte)), dv[j], mv[j]);
            }
            k_lo = 16 * c;
            k_hi = k_lo + 8;
          }
#pragma unroll
          for (int r = 0; r < kGemvRows; ++r) {
            if (r < M) {
              const float* xr = x + static_cast<size_t>(r) * K;
              const float4 v[4] = {__ldg(reinterpret_cast<const float4*>(xr + k_lo)),
                                   __ldg(reinterpret_cast<const float4*>(xr + k_lo + 4)),
                                   __ldg(reinterpret_cast<const float4*>(xr + k_hi)),
                                   __ldg(reinterpret_cast<const float4*>(xr + k_hi + 4))};
              float a = acc[r];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                a = fmaf(stage_x(v[i].x, Traits<F>::kRow), w[4 * i + 0], a);
                a = fmaf(stage_x(v[i].y, Traits<F>::kRow), w[4 * i + 1], a);
                a = fmaf(stage_x(v[i].z, Traits<F>::kRow), w[4 * i + 2], a);
                a = fmaf(stage_x(v[i].w, Traits<F>::kRow), w[4 * i + 3], a);
              }
              acc[r] = a;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGemvRows; ++r) {
    if (r < M) {
      float s = acc[r];
      for (int off = lanes >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (sub == 0 && n < N)
        y[static_cast<size_t>(r) * N + n] = Traits<F>::kRow ? __fmul_rn(s, d[n]) : s;
    }
  }
}

// ---- M > 8 -----------------------------------------------------------------

constexpr int kBK = 64;               // K columns a stage: two quant blocks
constexpr int kBlk = kBK / 32;        // quant blocks a stage
constexpr int kXPitch = kBK + 4;      // floats a row of the raw x tile
constexpr int kHPitch = kBK + 8;      // bf16 values a row of the operand tiles
constexpr int kStages = 3;

// bf16 parts x is split into: one for rowwise (x rounded to bf16 is that
// form's input), three for the f32 forms (hi + mid + lo carry x's 24-bit
// significand)
template <int F> constexpr int kParts = Traits<F>::kRow ? 1 : 3;

// Shared memory of block_gemm<F, BM, BN>: a ring of kStages raw stages
// (x as f32, the code rows, the quant blocks' scales and mins of each
// weight row), then the step's operands as the tensor cores take them: the
// parts of x [part][BM][kHPitch] and the codes [BN][kHPitch] as bf16, and
// (min forms) x's sums over each quant block [BM][kBlk]. Row pitches of 16
// bytes past a multiple of 128 put the 8 rows of an ldmatrix on distinct
// banks.
template <int F, int BM, int BN> struct Layout {
  static constexpr int kCodeBytes = Traits<F>::kNibbles ? kBK / 2 : kBK;  // a row a stage
  static constexpr int kCPitch = kCodeBytes + 16;
  static constexpr int kX = BM * kXPitch * 4;
  static constexpr int kC = BN * kCPitch;
  static constexpr int kS = BN * kBlk * 4;  // scales; as many mins
  static constexpr int kStage = kX + kC + 2 * kS;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kXh = BM * kHPitch * 2;  // one part of x
  static constexpr int kOps = (kParts<F> * BM + BN) * kHPitch * 2 + BM * kBlk * 4;
  static constexpr size_t kRed = static_cast<size_t>(BM) * (BN + 1) * sizeof(float);
  static constexpr size_t kSmem = kRing + kOps > kRed ? kRing + kOps : kRed;
};

// codes k .. k + 3 (k % 4 == 0, within the stage's kBK) of a shared code row
template <int F>
__device__ __forceinline__ void codes4(const unsigned char* row, int k, int (&c)[4]) {
  if constexpr (Traits<F>::kNibbles) {
    const int kb = k & 31;
    const unsigned w = *reinterpret_cast<const unsigned*>(row + (k >> 5) * 16 + (kb & 15));
    const unsigned v = kb < 16 ? w : w >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = nibble<F>((v >> (8 * i)) & 0xFu);
  } else {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = static_cast<int>(static_cast<int8_t>((w >> (8 * i)) & 0xFFu));
  }
}

// Grid (split, ceil(N / BN), ceil(M / BM)), clusters of `split` along x;
// WM x WN warps, each a (BM / WM) x (BN / WN) sub-tile.
template <int F, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
block_gemm(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ d, const float* __restrict__ m,
           float* __restrict__ y, int M, int K, int N) {
  using L = Layout<F, BM, BN>;
  constexpr int P = kParts<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kThreads = WM * WN * 32;
  constexpr int MF = BM / WM / 16;  // m16 fragments of a warp
  constexpr int NF = BN / WN / 8;   // n8 fragments of a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr0 = (warp / WN) * (BM / WM), wc0 = (warp % WN) * (BN / WN);
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int nb = K / 32;
  const int row_bytes = Traits<F>::kNibbles ? K / 2 : K;
  int first, last;
  gemm::split_range((K + kBK - 1) / kBK, gridDim.x, blockIdx.x, first, last);
  const int n_steps = last - first;
  const float* xa = x + static_cast<size_t>(m0) * K;
  const unsigned char* qb =
      reinterpret_cast<const unsigned char*>(q) + static_cast<size_t>(n0) * row_bytes;
  unsigned char* xh = smem + L::kRing;                 // [P][BM][kHPitch] bf16
  unsigned char* wh = xh + P * L::kXh;                 // [BN][kHPitch] bf16
  float* xsum = reinterpret_cast<float*>(wh + BN * kHPitch * 2);  // [BM][kBlk]

  // one raw stage; zero past the edges (rows at or past M / N, columns at
  // or past K)
  auto load = [&](int step) {
    unsigned char* st = smem + (step % kStages) * L::kStage;
    const int k0 = (first + step) * kBK;
    float* xd = reinterpret_cast<float*>(st);
    for (int i = tid; i < BM * (kBK / 4); i += kThreads) {
      const int r = i / (kBK / 4), c = i % (kBK / 4), k = k0 + 4 * c;
      const bool ok = r < M - m0 && k < K;
      gemm::cp_async16(xd + r * kXPitch + 4 * c, ok ? xa + static_cast<size_t>(r) * K + k : xa, ok);
    }
    unsigned char* cd = st + L::kX;
    constexpr int kCh = L::kCodeBytes / 16;
    const int b0 = Traits<F>::kNibbles ? k0 / 2 : k0;
    for (int i = tid; i < BN * kCh; i += kThreads) {
      const int r = i / kCh, c = i % kCh, b = b0 + 16 * c;
      const bool ok = r < N - n0 && b < row_bytes;
      gemm::cp_async16(cd + r * L::kCPitch + 16 * c,
                       ok ? qb + static_cast<size_t>(r) * row_bytes + b : qb, ok);
    }
    if constexpr (!Traits<F>::kRow) {
      float* dd = reinterpret_cast<float*>(st + L::kX + L::kC);
      const int blk0 = k0 / 32;
      for (int i = tid; i < BN * kBlk; i += kThreads) {
        const int r = i / kBlk, blk = blk0 + i % kBlk;
        const bool ok = r < N - n0 && blk < nb;
        const size_t at = static_cast<size_t>(n0 + r) * nb + blk;
        gemm::cp_async4(dd + i, ok ? d + at : d, ok);
        if (Traits<F>::kHasMin) gemm::cp_async4(dd + kBlk * BN + i, ok ? m + at : m, ok);
      }
    }
  };

  // a raw stage into the tensor cores' operands, four values a thread at a
  // time: x into its bf16 parts (hi = bf16(x), mid = bf16(x - hi), lo =
  // bf16(x - hi - mid); each difference exact in f32), the codes as bf16
  // (exact), and x's sum over each quant block (min forms)
  auto convert = [&](int step) {
    const unsigned char* st = smem + (step % kStages) * L::kStage;
    const float* xs = reinterpret_cast<const float*>(st);
    const unsigned char* cs = st + L::kX;
    for (int i = tid; i < (BM + BN) * (kBK / 4); i += kThreads) {  // warp-uniform: x or W rows
      const int r = i / (kBK / 4), k = 4 * (i % (kBK / 4));
      if (r < BM) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * kXPitch + k);
        unsigned h01[P], h23[P];
        gemm::bf16_parts<P>(xv.x, xv.y, h01);
        gemm::bf16_parts<P>(xv.z, xv.w, h23);
#pragma unroll
        for (int p = 0; p < P; ++p)
          *reinterpret_cast<uint2*>(xh + p * L::kXh + (r * kHPitch + k) * 2) =
              make_uint2(h01[p], h23[p]);
        if constexpr (Traits<F>::kHasMin) {
          // eight lanes hold a row's quant block
          float s = __fadd_rn(__fadd_rn(xv.x, xv.y), __fadd_rn(xv.z, xv.w));
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
          if ((k & 31) == 0) xsum[r * kBlk + (k >> 5)] = s;
        }
      } else {
        const int n = r - BM;
        int c[4];
        codes4<F>(cs + n * L::kCPitch, k, c);
        uint2 h;
        h.x = gemm::bf16x2(static_cast<float>(c[0]), static_cast<float>(c[1]));
        h.y = gemm::bf16x2(static_cast<float>(c[2]), static_cast<float>(c[3]));
        *reinterpret_cast<uint2*>(wh + (n * kHPitch + k) * 2) = h;
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s);
    gemm::cp_async_commit();
  }

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed; the operands and stage it - 1 are free
    if (it + kStages - 1 < n_steps) load(it + kStages - 1);
    gemm::cp_async_commit();
    convert(it);
    __syncthreads();
    const float* ds = reinterpret_cast<const float*>(smem + (it % kStages) * L::kStage + L::kX + L::kC);
#pragma unroll
    for (int blk = 0; blk < kBlk; ++blk) {
      // rowwise: the block's products straight into acc; the f32 forms: the
      // block's integer-weighted sum, then scaled (and its min added)
      float part[MF][NF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
      auto& sum = Traits<F>::kRow ? acc : part;
#pragma unroll
      for (int kk = blk * 32; kk < blk * 32 + 32; kk += 16) {
        unsigned b[NF][2];
#pragma unroll
        for (int j = 0; j < NF; ++j)
          gemm::ldmatrix_x2(b[j], wh + ((wc0 + j * 8 + (lane & 7)) * kHPitch + kk +
                                        ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int p = P - 1; p >= 0; --p) {  // lo, mid, then hi
          unsigned a[MF][4];
#pragma unroll
          for (int i = 0; i < MF; ++i)
            gemm::ldmatrix_x4(a[i], xh + p * L::kXh +
                                        ((wr0 + i * 16 + (lane & 15)) * kHPitch + kk +
                                         (lane >> 4) * 8) * 2);
#pragma unroll
          for (int i = 0; i < MF; ++i)
#pragma unroll
            for (int j = 0; j < NF; ++j) gemm::mma_bf16(sum[i][j], a[i], b[j]);
        }
      }
      if constexpr (!Traits<F>::kRow) {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = wc0 + j * 8 + 2 * t + h;
            const float db = ds[kBlk * n + blk];
            const float mb = Traits<F>::kHasMin ? ds[kBlk * (BN + n) + blk] : 0.f;
#pragma unroll
            for (int i = 0; i < MF; ++i) {
#pragma unroll
              for (int v = 0; v < 2; ++v) {  // rows g and g + 8
                float a = fmaf(db, part[i][j][2 * v + h], acc[i][j][2 * v + h]);
                if constexpr (Traits<F>::kHasMin)
                  a = fmaf(mb, xsum[(wr0 + i * 16 + g + 8 * v) * kBlk + blk], a);
                acc[i][j][2 * v + h] = a;
              }
            }
          }
        }
      }
    }
  }

  auto store = [&](int r, int c, float sum) {
    const int mm = m0 + r, nn = n0 + c;
    if (mm < M && nn < N)
      y[static_cast<size_t>(mm) * N + nn] = Traits<F>::kRow ? __fmul_rn(sum, d[nn]) : sum;
  };
  if (gridDim.x == 1) {
    gemm::for_fragments(acc, wr0, wc0, store);
    return;
  }
  gemm::cp_async_wait<0>();
  __syncthreads();  // the ring becomes the partial tile
  float* red = reinterpret_cast<float*>(smem);
  gemm::for_fragments(acc, wr0, wc0, [&](int r, int c, float v) { red[r * (BN + 1) + c] = v; });
  gemm::cluster_reduce<BM, BN>(red, store);
}

template <int F, int BM, int BN, int WM, int WN>
cudaError_t launch_gemm(const float* x, const int8_t* q, const float* d, const float* m, float* y,
                        int M, int K, int N, int split, cudaStream_t st) {
  const dim3 grid(split, (N + BN - 1) / BN, (M + BM - 1) / BM);
  return gemm::launch(block_gemm<F, BM, BN, WM, WN>, grid, WM * WN * 32,
                      Layout<F, BM, BN>::kSmem, split, st, x, q, d, m, y, M, K, N);
}

template <int F>
cudaError_t launch(const float* x, const int8_t* q, const float* d, const float* m, float* y,
                   int M, int K, int N, int bm, int bn, int split, int lanes, int blocks,
                   cudaStream_t st) {
  if (bm == 0) {
    if (M > kGemvRows || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || blocks < 1)
      return cudaErrorInvalidValue;
    block_gemv<F><<<blocks, kGemvThreads, 0, st>>>(x, q, d, m, y, M, K, N, lanes);
    return cudaGetLastError();
  }
  if (split < 1 || split > gemm::kMaxSplit || split > (K + kBK - 1) / kBK)
    return cudaErrorInvalidValue;
  if (bm == 64 && bn == 64) return launch_gemm<F, 64, 64, 2, 4>(x, q, d, m, y, M, K, N, split, st);
  if (bm == 32 && bn == 32) return launch_gemm<F, 32, 32, 2, 4>(x, q, d, m, y, M, K, N, split, st);
  if (bm == 32 && bn == 16) return launch_gemm<F, 32, 16, 2, 2>(x, q, d, m, y, M, K, N, split, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] f32, q int8 [N, K] ([N, K/2] for the nibble forms), d f32
// [N, K/32] ([N] for rowwise), m f32 [N, K/32] or null -> y [M, N] f32.
// The plan comes from ops/kernels.py::matmul_plan: bm = 0 takes the GEMV
// route (M <= 8; `lanes` lanes a row, `blocks` blocks of four warps), else
// the tensor-core route with a bm x bn tile (64x64, 32x32, 32x16) and
// `split` K ranges (1-8, at most the number of 64-column K steps). K must
// be a multiple of 32 and every pointer 16-byte aligned (checked by the
// Python wrapper, which also picks `form`).
extern "C" int rwkv_block_matmul(const void* x, const void* q, const void* d, const void* m,
                                 void* y, int M, int K, int N, int form, int bm, int bn,
                                 int split, int lanes, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* dp = static_cast<const float*>(d);
  const float* mp = static_cast<const float*>(m);
  float* yp = static_cast<float*>(y);
  if (M < 1 || N < 1 || K < 32 || K % 32) return static_cast<int>(cudaErrorInvalidValue);
#define RWKV_K9_FORM(F) \
  launch<F>(xp, qp, dp, mp, yp, M, K, N, bm, bn, split, lanes, blocks, st)
  switch (form) {
    case kPlain: return static_cast<int>(RWKV_K9_FORM(kPlain));
    case kMin: return static_cast<int>(RWKV_K9_FORM(kMin));
    case kPack4: return static_cast<int>(RWKV_K9_FORM(kPack4));
    case kPack4Min: return static_cast<int>(RWKV_K9_FORM(kPack4Min));
    case kRowwise: return static_cast<int>(RWKV_K9_FORM(kRowwise));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RWKV_K9_FORM
}
