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
// Design: K3's persistent cooperative kernel (cudaLaunchCooperativeKernel,
// one 256-thread block per SM, phases separated by grid-wide barriers),
// seven phases a layer:
//   A  ln1, token shift, xxx = xl + sx * maa_x quantized, the maa1 rows
//      (5 d_maa) with tanh
//   M  the five maa2 up-projections in float32 (f32 FMAs: int8, bf16 or
//      TF32 there drift far from the per-op path), rows spread over every
//      warp of the grid, each row's epilogue writing its mix
//      xl + sx * (maa5 + m) (w, k, v, r, g)
//   B  the five mixes quantized as whole vectors (every block redundantly),
//      the rkvg rows (r, k, v, silu(g)) and the d_dec dw1 rows with tanh
//   C  per head (one block each): the head's dw2 rows, exp(-exp(.)) decay,
//      the wkv6 step (the output reads the OLD state plus the time_faaaa
//      bonus, then the state decays and takes k v^T), group norm (eps
//      64e-5), ln_x, times the gate
//   D  out rows + residual
//   E  ln2 + shift, the fk rows with relu^2 and the fr rows with sigmoid
//   F  fv rows: x += sigmoid(fr) * fv
// then ln_out and the head rows (lm_head, decode_common.cuh, shared with
// K3). Weight rows of any width are spread over every warp of the grid with
// 16-byte loads and __dp4a (matvec_rows, common.cuh, as K4 uses it; int4
// rows unpack with two masks), lanes_for(K) lanes a row (decode_common.cuh).
// The step is bound by latency, not bytes: each phase is a chain of block
// reductions and dependent loads, and the layer's seven grid barriers
// dominate at B=1.
//
// Numerics follow the JAX kernel: each matvec input vector is quantized as
// a whole (amax over all of it, codes rint(x * inv) clipped to +-127), the
// int32 sum is scaled as (float(acc) * dx) * d, and the elementwise formulas
// use explicit round-to-nearest multiplies and adds, so that no fused
// multiply-add shifts an activation across a code boundary. The bf16 form
// (WF = kBf16, common.cuh) stages each input vector in f32 instead of
// quantizing it, and each row's f32 dot is the output as it is (no scales).
#include "decode_common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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
  float* scratch;           // scratch_floats(C, DM, DD, F); x ends at scratch[0..C)
  int C, H, S, DM, DD, F, L, V;
  int emb_f32;
};

// Floats of the kernel's global scratch: x, mixdn (5 DM), the five mixes
// (5C), r|k|v|silu(g) (4C), the dw1 downs (DD), xo, sigmoid(fr) and the
// relu^2 keys (F); the Python wrapper allocates the same.
__host__ __device__ inline size_t scratch_floats(int C, int DM, int DD, int F) {
  return 12ull * C + 5ull * DM + DD + F;
}

// Floats of the per-head / maa2 staging area in shared memory.
__host__ __device__ inline int hv_floats(int S, int DM) {
  return 8 * S > 5 * DM ? 8 * S : 5 * DM;
}

template <int WF>
__global__ void __launch_bounds__(kThreads)
v6_decode_kernel(Args p) {
  constexpr int LF = small_form(WF);  // the LoRAs' form
  cg::grid_group grid = cg::this_grid();
  const int C = p.C, H = p.H, S = p.S, DM = p.DM, DD = p.DD, F = p.F;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [C] residual / ln input
  float* xl = xs + C;                            // [C] normalized (kept from A to M)
  float* hv = xl + C;                            // [hv_floats] per-head vectors / mixdn
  float* red = hv + hv_floats(S, DM);            // [8][32] reduction scratch
  float* dxs = red + 8 * 32;                     // [8] activation scales
  act_t<WF>* q8 = reinterpret_cast<act_t<WF>*>(dxs + 8);  // [max(5C, F)] activations

  float* x_g = p.scratch;           // residual stream
  float* mixdn_g = x_g + C;         // [5 DM] tanh(maa1 rows)
  float* mix_g = mixdn_g + 5 * DM;  // [5][C] mixes w, k, v, r, g
  float* rkvg_g = mix_g + 5 * C;    // [4][C] r, k, v, silu(g)
  float* dn_g = rkvg_g + 4 * C;     // [DD] tanh(dw1 rows)
  float* xo_g = dn_g + DD;          // attention output before `out`
  float* rg_g = xo_g + C;           // sigmoid(fr rows)
  float* fk_g = rg_g + C;           // [F] relu^2 keys

#ifdef RWKV_PHASE_TIMES
  unsigned long long* marks =
      reinterpret_cast<unsigned long long*>(p.scratch + scratch_floats(C, DM, DD, F));
  int n_marks = 0;
#endif
  // a grid-wide barrier, with a timestamp on each side in the timing build
  auto barrier = [&]() {
    PHASE_MARK();
    grid.sync();
    PHASE_MARK();
  };
  PHASE_MARK();

  const MatOffsets6 mo(C, DM, DD, F, WF);
  const ScaleOffsets6 so(C, DM, DD, F);
  const int lane = tid & 31;
  const int n_units = gridDim.x * (blockDim.x >> 5);
  const int unit = blockIdx.x * (blockDim.x >> 5) + (tid >> 5);

  for (int l = 0; l < p.L; ++l) {
    const int8_t* m_layer = p.mats + l * mo.layer;
    const float* s_layer = p.scales + l * so.layer;
    const float* vec = p.vecs + static_cast<size_t>(l) * kNumVec6 * C;
    const float* att_in = p.att_in + static_cast<size_t>(l) * C;
    const float* ffn_in = p.ffn_in + static_cast<size_t>(l) * C;

    // ---- phase A: ln1, shift, xxx, maa1 rows with tanh ---------------------
    if (l == 0) {
      const size_t e = static_cast<size_t>(*p.token) * C;
      for (int c = tid; c < C; c += blockDim.x) xl[c] = emb_at(p.emb, p.emb_f32, e + c);
      __syncthreads();
      layer_norm_block(xl, xs, p.ln0, p.ln0 + C, C, 1e-5f, red);
      if (blockIdx.x == 0)
        for (int c = tid; c < C; c += blockDim.x) x_g[c] = xs[c];
    } else {
      for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
      __syncthreads();
    }
    layer_norm_block(xs, xl, vec + kLn1W * C, vec + kLn1B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.att_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      const float* mx = vec + kMaaX * C;
      act_n<WF, 1>([&](int, int c) { return add(xl[c], mul(sub(att_in[c], xl[c]), mx[c])); },
                   C, q8, 0, dxs, red);
      matvec_grid<LF, 1>(m_layer + mo.maa1, 5 * DM, C, 1, [&](int, int) { return q8; },
          [&](int row, int, auto acc) {
            mixdn_g[row] = tanhf(dequant(acc, dxs[0], s_layer + so.maa1 + row));
          });
    }
    barrier();

    // ---- phase M: maa2 up-projections (f32) into the five mixes ------------
    {
      float* mdn = hv;  // [5 DM]
      for (int i = tid; i < 5 * DM; i += blockDim.x) mdn[i] = mixdn_g[i];
      __syncthreads();
      // lpr lanes share a maa2 row of DM floats, one float4 at a time
      const int pieces = DM >> 2;
      int lpr = 32;
      while (lpr > 1 && pieces % lpr) lpr >>= 1;
      const int gpw = 32 / lpr, sub_lane = lane % lpr, grp = lane / lpr;
      const float4* m2 =
          reinterpret_cast<const float4*>(p.maa2 + static_cast<size_t>(l) * 5 * C * DM);
      const float* cf = vec + kMaa5 * C;  // row s * C + c: split s's coefficient
      for (int base = unit * gpw; base < 5 * C; base += n_units * gpw) {  // warp-uniform
        const int row = base + grp;
        float acc = 0.f;
        if (row < 5 * C) {
          const float* md = mdn + (row / C) * DM;
          for (int q = sub_lane; q < pieces; q += lpr) {
            const float4 w = m2[static_cast<size_t>(row) * pieces + q];
            acc = fmaf(w.x, md[4 * q], acc);
            acc = fmaf(w.y, md[4 * q + 1], acc);
            acc = fmaf(w.z, md[4 * q + 2], acc);
            acc = fmaf(w.w, md[4 * q + 3], acc);
          }
        }
        for (int off = lpr >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (sub_lane == 0 && row < 5 * C) {
          const int c = row % C;
          mix_g[row] = add(xl[c], mul(sub(att_in[c], xl[c]), add(cf[row], acc)));
        }
      }
    }
    barrier();

    // ---- phase B: five mixes quantized, rkvg rows, dw1 rows with tanh ------
    act_n<WF, 5>([&](int m, int c) { return mix_g[m * C + c]; }, C, q8, C, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.rkvg, 4 * C, C, 1,
        [&](int row, int) { return q8 + rkvg_mix(row / C) * C; },
        [&](int row, int, auto acc) {
          const int part = row / C;
          float y = dequant(acc, dxs[rkvg_mix(part)], s_layer + so.rkvg + row);
          if (part == 3) y = mul(y, sigmoidf(y));  // silu gate
          rkvg_g[row] = y;
        },
        lanes_for(C, WF));
    matvec_grid<LF, 1>(m_layer + mo.dw1, DD, C, 1, [&](int, int) { return q8; },  // mix w
        [&](int row, int, auto acc) {
          dn_g[row] = tanhf(dequant(acc, dxs[0], s_layer + so.dw1 + row));
        },
        32, true);
    barrier();

    // ---- phase C: per head: dw2 rows, decay, wkv6, group norm, ln_x, gate --
    for (int h = blockIdx.x; h < H; h += gridDim.x) {  // block-uniform
      float* h_r = hv;
      float* h_k = hv + S;
      float* h_v = hv + 2 * S;
      float* h_w = hv + 3 * S;
      float* h_y = hv + 4 * S;
      act_n<LF, 1>([&](int, int c) { return dn_g[c]; }, DD, q8, 0, dxs, red);
      const float* tdecay = vec + kTDecay * C;
      matvec_rows<LF, 1>(m_layer + mo.dw2, S, DD, tid >> 5, blockDim.x >> 5, 32, 1,
          [&](int r) { return h * S + r; }, [&](int, int) { return q8; },
          [&](int r, int, auto acc) {
            const int c = h * S + r;
            const float wl = add(dequant(acc, dxs[0], s_layer + so.dw2 + c), tdecay[c]);
            h_w[r] = expf(-expf(wl));
          });
      const int c = h * S + tid;
      float dot_part = 0.f;
      if (tid < S) {
        const float rr = rkvg_g[c], kk = rkvg_g[C + c];
        h_r[tid] = rr;
        h_k[tid] = kk;
        h_v[tid] = rkvg_g[2 * C + c];
        dot_part = mul(mul(rr, vec[kTF * C + c]), kk);
      }
      const float dot = block_sum(dot_part, red);  // also orders the h_* stores

      // state rows: tpr threads per row i, entries j = jj * tpr + part
      const int tpr = blockDim.x / S;
      const int jn = S / tpr;
      const int i = tid / tpr, part = tid % tpr;
      const size_t hoff = (static_cast<size_t>(l) * H * S + static_cast<size_t>(h) * S + i) * S;
      const float* st_in = p.heads_in + hoff;
      float* st_out = p.heads_out + hoff;
      const float vi = h_v[i];
      float yi = 0.f;
#pragma unroll
      for (int jj = 0; jj < kMaxJ; ++jj) {
        if (jj < jn) {
          const int j = jj * tpr + part;
          const float st = st_in[j];
          yi += st * h_r[j];
          st_out[j] = add(mul(st, h_w[j]), mul(h_k[j], vi));
        }
      }
      for (int off = tpr >> 1; off > 0; off >>= 1) yi += __shfl_xor_sync(0xffffffffu, yi, off);
      if (part == 0) h_y[i] = add(yi, mul(vi, dot));
      __syncthreads();

      const float yv = tid < S ? h_y[tid] : 0.f;
      const float mu = block_sum(yv, red) / static_cast<float>(S);
      const float yc = tid < S ? sub(yv, mu) : 0.f;
      const float var = block_sum(mul(yc, yc), red) / static_cast<float>(S);
      if (tid < S) {
        const float yn = mul(yc, rsqrtf(add(var, 64e-5f)));
        const float xo = add(mul(yn, vec[kLnxW * C + c]), vec[kLnxB * C + c]);
        xo_g[c] = mul(xo, rkvg_g[3 * C + c]);
      }
      __syncthreads();
    }
    barrier();

    // ---- phase D: out rows + residual -------------------------------------
    act_n<WF, 1>([&](int, int c) { return xo_g[c]; }, C, q8, 0, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.out, C, C, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          x_g[row] = add(x_g[row], dequant(acc, dxs[0], s_layer + so.out + row));
        },
        lanes_for(C, WF));
    barrier();

    // ---- phase E: ln2 + shift, fk rows with relu^2, fr rows with sigmoid ----
    for (int c = tid; c < C; c += blockDim.x) xs[c] = x_g[c];
    __syncthreads();
    layer_norm_block(xs, xl, vec + kLn2W * C, vec + kLn2B * C, C, 1e-5f, red);
    if (blockIdx.x == 0)
      for (int c = tid; c < C; c += blockDim.x) p.ffn_out[static_cast<size_t>(l) * C + c] = xl[c];
    {
      const float* fx = vec + kFXK * C;  // rows k, r
      act_n<WF, 2>(
          [&](int m, int c) { return add(xl[c], mul(sub(ffn_in[c], xl[c]), fx[m * C + c])); },
          C, q8, C, dxs, red);
      matvec_grid<WF, 1>(m_layer + mo.fk, F, C, 1, [&](int, int) { return q8; },
          [&](int row, int, auto acc) {
            const float y = fmaxf(dequant(acc, dxs[0], s_layer + so.fk + row), 0.f);
            fk_g[row] = mul(y, y);
          },
          lanes_for(C, WF));
      matvec_grid<WF, 1>(m_layer + mo.fr, C, C, 1, [&](int, int) { return q8 + C; },
          [&](int row, int, auto acc) {
            rg_g[row] = sigmoidf(dequant(acc, dxs[1], s_layer + so.fr + row));
          },
          lanes_for(C, WF), true);
    }
    barrier();

    // ---- phase F: fv rows, x += sigmoid(fr) * fv ----------------------------
    act_n<WF, 1>([&](int, int c) { return fk_g[c]; }, F, q8, 0, dxs, red);
    matvec_grid<WF, 1>(m_layer + mo.fv, C, F, 1, [&](int, int) { return q8; },
        [&](int row, int, auto acc) {
          x_g[row] = add(x_g[row], mul(rg_g[row], dequant(acc, dxs[0], s_layer + so.fv + row)));
        },
        lanes_for(F, WF));
    barrier();
  }

  // ---- head: ln_out, quantize, V rows (decode_common.cuh) -----------------
  lm_head<WF>(x_g, p.head, p.head_d, p.ln_out, p.logits, C, p.V, xs, xl, red, dxs, q8);
  PHASE_MARK();
}

// Shared memory of a launch in form wf: the floats, then the activations
// (int8 codes, or f32 in the bf16 form).
size_t smem_bytes(int C, int S, int DM, int F, int wf) {
  int q = 5 * C;
  if (F > q) q = F;
  const size_t floats = 2ull * C + hv_floats(S, DM) + 8 * 32 + 8;
  const size_t act = (wf == kBf16 ? sizeof(float) : 1) * static_cast<size_t>(q);
  return floats * sizeof(float) + ((act + 15) / 16) * 16;
}

const void* kernel_for(int wf) {
  if (wf == kBf16) return reinterpret_cast<const void*>(v6_decode_kernel<kBf16>);
  return wf == kInt4 ? reinterpret_cast<const void*>(v6_decode_kernel<kInt4>)
                     : reinterpret_cast<const void*>(v6_decode_kernel<kInt8>);
}

// Grid size a launch in form wf uses (blocks), or a negative CUDA error
// code (0: the kernel does not fit on an SM at these sizes).
int grid_blocks_for(int wf, int C, int S, int DM, int F) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = smem_bytes(C, S, DM, F, wf);
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(wf), kThreads, smem);
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
  if (grid_blocks <= 0 || kThreads % S != 0 || S * S / kThreads > kMaxJ || DM % 4 != 0 ||
      H * S != C)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t smem = smem_bytes(C, S, DM, F, wf);
  cudaError_t err = set_smem(kernel_for(wf), smem);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel(kernel_for(wf), dim3(grid_blocks), dim3(kThreads), kargs,
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
  (void)DD;
  return grid_blocks_for(kInt8, C, S, DM, F);
}

extern "C" int rwkv_v6_decode_w4_grid(int C, int S, int DM, int DD, int F) {
  (void)DD;
  return grid_blocks_for(kInt4, C, S, DM, F);
}

extern "C" int rwkv_v6_decode_bf16_grid(int C, int S, int DM, int DD, int F) {
  (void)DD;
  return grid_blocks_for(kBf16, C, S, DM, F);
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
