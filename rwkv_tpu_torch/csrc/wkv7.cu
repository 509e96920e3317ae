// K2: the wkv7 recurrence over a whole sequence (prefill), in the chunked
// two-pass form of the TPU kernel.
//
// Replaces rwkv_tpu/ops/chunked.py::wkv7_chunked_pallas (kernel body
// _wkv7_chunk_kernel_grouped, its pass A _passa; the algebra in
// wkv7_chunked_twopass), reached through wkv7_auto. Same function: for every
// (batch*head) bh, from state s0[bh] (S x S, row i = value dim, column j =
// key dim), per token t
//   sa_i   = sum_j a_j S_ij
//   S_ij  <- S_ij w_j + k_j v_i + sa_i b_j
//   y_i    = sum_j S_ij r_j
// giving y [T, BH, S] and the final state. Operands are [T, BH, S] f32
// (heads folded with batch, as wkv7_auto folds them).
//
// Bound on this card: (7 T BH S + 2 BH S^2) * 4 bytes over HBM bandwidth
// (about 1.8 us at T=256, BH=12, S=64). The parent's token recurrence, one
// block a head, took ~0.55 us a token. Design (wkv_chunk.cuh): chunks of
// P = 16 tokens, whose state map is affine,
//   out_c   = E_c T_c^T + Y_c
//   T_{c+1} = (T_c + (T_c F_c^T + S_loc^T) btil + v^T ktil) diag(e^lcum_last)
// on the de-decayed state T = S o 1/W (W the in-chunk decay product).
// Pass A builds every (chunk, head) pair's lcum, atil = a e^(lcum - lw),
// btil = b e^-lcum, ktil = k e^-lcum, rhat = r e^lcum, the strictly lower
// bmat = atil btil^T and kmat = atil ktil^T and the inclusive br = rhat
// btil^T, kr = rhat ktil^T, inv = (I - bmat)^-1 as the Neumann product
// (I + B)(I + B^2)(I + B^4)(I + B^8) (wkv7_chunked_twopass's sequence),
// F = inv atil, S_loc = inv kmat v, E = rhat + br F and Y = br S_loc + kr v,
// in parallel over the grid. Pass B carries each group of state rows
// through the chunks, 4PS f32 FMAs a row a chunk, applying the state map in
// its rank-2P factors (F, E; btil, ktil) instead of dense S x S operators:
// the sequential chain is one chunk step (~0.8 us), not 16 tokens. f32
// FMAs throughout: TF32 keeps ~3 digits, and TF32 in three terms for the
// [P, S] x [S, P] products, 2x faster alone (tools/probe_wkv.py --tf32),
// gained nothing in the kernel. Below recurrence_below's T the launch runs
// the token recurrence instead, S / 8 lanes a row, each token's y and the
// next token's sa = a . S in one reduction. The de-decayed factors rely on
// v7's decay bound w >= e^-0.606531 (1/W <= e^(0.607 P)), the premise of
// wkv7_chunked_pallas.
#include "common.cuh"
#include "wkv_chunk.cuh"

namespace {

using wkvc::kCompute;
using wkvc::kP;

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float comp(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

struct K7 {
  static constexpr int kKind = 7;

  // Pass A of item (c, bh): the operators into `out` (F, E as [S][2P]; btil,
  // ktil as [2P][S]; e^lcum_last [S]; then a row i's S_loc, v, Y as
  // [S][3P]).
  template <int S>
  static __device__ void pass_a(const wkvc::Args& a, int c, int bh, float* sm, float* out) {
    constexpr int SP = S + 4, PP = kP + 1;
    float* LW = sm;
    float* LC = LW + kP * SP;
    float* AT = LC + kP * SP;
    float* BT = AT + kP * SP;
    float* KT = BT + kP * SP;
    float* RH = KT + kP * SP;
    float* VV = RH + kP * SP;
    float* T1 = VV + kP * SP;
    float* FF = T1 + kP * SP;
    float* SL = FF + kP * SP;
    float* BM = SL + kP * SP;
    float* KM = BM + kP * PP;
    float* BR = KM + kP * PP;
    float* KR = BR + kP * PP;
    float* N0 = KR + kP * PP;  // the Neumann product's four buffers
    float* N1 = N0 + kP * PP;
    float* N2 = N1 + kP * PP;
    float* N3 = N2 + kP * PP;
    float* EF = out;
    float* BK = out + 2 * kP * S;
    float* EL = out + 4 * kP * S;
    float* RS = EL + S;
    const int tid = threadIdx.x;

    {  // the chunk's operands r 0, w 1 (as log max(w, 1e-30)), k 2, v 3, a 4, b 5
      const int ops[6] = {0, 1, 2, 3, 4, 5};
      float* const dst[6] = {RH, LW, KT, VV, AT, BT};
      wkvc::load_chunk<S, 6>(a, ops, 1, 1e-30f, c, bh, dst, SP);
    }
    stream::csync();
    wkvc::cumsum_cols<S, float>(LW, LC, SP);
    stream::csync();
    for (int idx = tid; idx < kP * S; idx += kCompute) {
      const int t = idx / S, j = idx - t * S, o = t * SP + j;
      const float lc = LC[o];
      const float en = expf(-lc);
      AT[o] *= expf(lc - LW[o]);
      BT[o] *= en;
      KT[o] *= en;
      RH[o] *= expf(lc);
      BK[t * S + j] = BT[o];
      BK[(kP + t) * S + j] = KT[o];
      if (t == kP - 1) EL[j] = expf(lc);
    }
    stream::csync();
    {  // bmat, kmat (strictly lower), br, kr (inclusive): one (t, u) a thread
      const int m = tid >> 4, n = tid & (kP - 1);
      float bm = 0.f, km = 0.f, br = 0.f, kr = 0.f;
#pragma unroll
      for (int j = 0; j < S; j += 4) {
        const float4 at = wkvc::ld4(AT + m * SP + j), rh = wkvc::ld4(RH + m * SP + j);
        const float4 bt = wkvc::ld4(BT + n * SP + j), kt = wkvc::ld4(KT + n * SP + j);
        bm = wkvc::dot4(at, bt, bm);
        km = wkvc::dot4(at, kt, km);
        br = wkvc::dot4(rh, bt, br);
        kr = wkvc::dot4(rh, kt, kr);
      }
      const int o = m * PP + n;
      BM[o] = n < m ? bm : 0.f;
      KM[o] = n < m ? km : 0.f;
      BR[o] = n <= m ? br : 0.f;
      KR[o] = n <= m ? kr : 0.f;
      N0[o] = (m == n ? 1.f : 0.f) + (n < m ? bm : 0.f);
    }
    stream::csync();
    // inv = (I + B)(I + B^2)(I + B^4)(I + B^8), wkv7_chunked_twopass's
    // sequence of products, each level's two products at once; T1 = kmat v
    // beside the first
    wkvc::mm_pp([&](int m, int k) { return BM[m * PP + k]; },
                [&](int k, int n) { return BM[k * PP + n]; },
                [&](int m, int n, float v) { N1[m * PP + n] = v; });
    wkvc::mm_strip<S>([&](int m, int k) { return KM[m * PP + k]; }, VV, SP,
                      [&](int m, int n, float4 v) { *reinterpret_cast<float4*>(T1 + m * SP + n) = v; });
    stream::csync();
    float *inv = N0, *bp = N1, *ni = N2, *nb = N3;
    for (int lv = 0; lv < 3; ++lv) {
      const float* i0 = inv;
      const float* b0 = bp;
      float* i1 = ni;
      float* b1 = nb;
      wkvc::mm_pp([&](int m, int k) { return i0[m * PP + k]; },
                  [&](int k, int n) { return (k == n ? 1.f : 0.f) + b0[k * PP + n]; },
                  [&](int m, int n, float v) { i1[m * PP + n] = v; });
      if (lv < 2)
        wkvc::mm_pp([&](int m, int k) { return b0[m * PP + k]; },
                    [&](int k, int n) { return b0[k * PP + n]; },
                    [&](int m, int n, float v) { b1[m * PP + n] = v; });
      stream::csync();
      ni = inv;
      nb = bp;
      inv = i1;
      bp = b1;
    }
    // F = inv atil, S_loc = inv T1 (the state map's factors)
    for (int idx = tid; idx < kP * S / 4; idx += kCompute) {
      const int m = idx & (kP - 1), n = (idx >> 4) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f), sl = f;
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float im = inv[m * PP + k];
        fma4(f, im, wkvc::ld4(AT + k * SP + n));
        fma4(sl, im, wkvc::ld4(T1 + k * SP + n));
      }
      *reinterpret_cast<float4*>(FF + m * SP + n) = f;
      *reinterpret_cast<float4*>(SL + m * SP + n) = sl;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        EF[(n + q) * 2 * kP + m] = comp(f, q);
        RS[(n + q) * 3 * kP + m] = comp(sl, q);
      }
    }
    stream::csync();
    // E = rhat + br F, Y = br S_loc + kr v; v into the rows' part
    for (int idx = tid; idx < kP * S / 4; idx += kCompute) {
      const int m = idx & (kP - 1), n = (idx >> 4) * 4;
      float4 e = make_float4(0.f, 0.f, 0.f, 0.f), y1 = e, y2 = e;
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const float b = BR[m * PP + k], kr = KR[m * PP + k];
        fma4(e, b, wkvc::ld4(FF + k * SP + n));
        fma4(y1, b, wkvc::ld4(SL + k * SP + n));
        fma4(y2, kr, wkvc::ld4(VV + k * SP + n));
      }
      const float4 rh = wkvc::ld4(RH + m * SP + n), vm = wkvc::ld4(VV + m * SP + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        EF[(n + q) * 2 * kP + kP + m] = comp(rh, q) + comp(e, q);
        RS[(n + q) * 3 * kP + kP + m] = comp(vm, q);
        RS[(n + q) * 3 * kP + 2 * kP + m] = comp(y1, q) + comp(y2, q);
      }
    }
  }

  // Pass B's chunk step for the warp's rows q0 .. q0 + RB - 1: lanes
  // 0..P-1 take u_t = S_loc_t + T_i . F_t, lanes P..2P-1 out_t = Y_t + T_i .
  // E_t (written to y for the tokens before T: `left`); then
  // T_i <- (T_i + sum_t u_t btil_t + v_t ktil_t) e^lcum_last.
  template <int S, int RB>
  static __device__ __forceinline__ void chunk(const float* st, float* tst, int W, int q0,
                                               float* yc, int left, int BH) {
    constexpr int JL = S / 32;
    const float* EF = st;
    const float* BK = st + 2 * kP * S;
    const float* EL = st + 4 * kP * S;
    const float* RS = EL + S;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int ii[RB];
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ii[r] = warp + W * (q0 + r);
      acc[r][0] = lane < kP ? RS[ii[r] * 3 * kP + lane] : RS[ii[r] * 3 * kP + kP + lane];
      acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }
    // groups of 8 columns, each group's loads before its FMAs (and the
    // whole loop unrolled, so the next group's loads overlap these FMAs)
#pragma unroll
    for (int j0 = 0; j0 < S; j0 += 8) {
      float e[8];
      float4 tv[RB][2];
#pragma unroll
      for (int q = 0; q < 8; ++q) e[q] = EF[(j0 + q) * 2 * kP + lane];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        tv[r][0] = wkvc::ld4(tst + ii[r] * S + j0);
        tv[r][1] = wkvc::ld4(tst + ii[r] * S + j0 + 4);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[r][0] = fmaf(tv[r][h].x, e[4 * h], acc[r][0]);
          acc[r][1] = fmaf(tv[r][h].y, e[4 * h + 1], acc[r][1]);
          acc[r][2] = fmaf(tv[r][h].z, e[4 * h + 2], acc[r][2]);
          acc[r][3] = fmaf(tv[r][h].w, e[4 * h + 3], acc[r][3]);
        }
    }
    float u[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      u[r] = (acc[r][0] + acc[r][1]) + (acc[r][2] + acc[r][3]);
      if (lane >= kP && lane - kP < left) yc[static_cast<size_t>(lane - kP) * BH * S + ii[r]] = u[r];
    }
    float x[RB][JL], xv[RB][JL];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int m = 0; m < JL; ++m) {
        x[r][m] = tst[ii[r] * S + lane + 32 * m];
        xv[r][m] = 0.f;
      }
    // groups of 4 tokens, each group's shuffles and loads before its FMAs
#pragma unroll
    for (int t0 = 0; t0 < kP; t0 += 4) {
      float ut[RB][4], vt[RB][4], bt[4][JL], kt[4][JL];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          ut[r][q] = __shfl_sync(0xffffffffu, u[r], t0 + q);
          vt[r][q] = RS[ii[r] * 3 * kP + kP + t0 + q];
        }
#pragma unroll
        for (int m = 0; m < JL; ++m) {
          bt[q][m] = BK[(t0 + q) * S + lane + 32 * m];
          kt[q][m] = BK[(kP + t0 + q) * S + lane + 32 * m];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 0; m < JL; ++m)
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            x[r][m] = fmaf(ut[r][q], bt[q][m], x[r][m]);
            xv[r][m] = fmaf(vt[r][q], kt[q][m], xv[r][m]);
          }
    }
#pragma unroll
    for (int m = 0; m < JL; ++m) {
      const float el = EL[lane + 32 * m];
#pragma unroll
      for (int r = 0; r < RB; ++r) tst[ii[r] * S + lane + 32 * m] = (x[r][m] + xv[r][m]) * el;
    }
  }

  // The recurrence for NR state rows (local rows ii + q 2048 / S, q < NR,
  // at `row` + q `rs` floats) over a tile of nt tokens (ops: the tokens' r,
  // w, k, v, a, b, [nt][6][S]): lane p of a row's S / 8 holds entries
  // j = 4 p + S / 2 h + c (h < 2, c < 4), read as float4s. Each token's y
  // and the next token's sa = a . S reduce together, so a token waits on
  // one reduction (the NR rows' interleaved).
  template <int S, int NR>
  static __device__ __forceinline__ void rows(const float* ops, int nt, const float*, float* row,
                                              int rs, int p, unsigned mask, int i, float* y,
                                              int BH) {
    constexpr int LPR = S / 8, NO = 6 * S, H = S / 2;
    float4 x[NR][2];
    float sa[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      sa[q] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[q][h] = wkvc::ld4(row + q * rs + 4 * p + H * h);
        sa[q] = wkvc::dot4(wkvc::ld4(ops + 4 * S + 4 * p + H * h), x[q][h], sa[q]);
      }
      sa[q] = wkvc::row_sum<LPR>(sa[q], mask);
    }
    for (int t = 0; t < nt; ++t) {
      const float* o = ops + t * NO + 4 * p;
      const bool next = t + 1 < nt;
      float py[NR], pa[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float vi = ops[t * NO + 3 * S + i + q * rs / S];
        py[q] = pa[q] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 w = wkvc::ld4(o + S + H * h), k = wkvc::ld4(o + 2 * S + H * h);
          const float4 b = wkvc::ld4(o + 5 * S + H * h);
          float4& xs = x[q][h];
          xs.x = fmaf(sa[q], b.x, fmaf(k.x, vi, xs.x * w.x));
          xs.y = fmaf(sa[q], b.y, fmaf(k.y, vi, xs.y * w.y));
          xs.z = fmaf(sa[q], b.z, fmaf(k.z, vi, xs.z * w.z));
          xs.w = fmaf(sa[q], b.w, fmaf(k.w, vi, xs.w * w.w));
          py[q] = wkvc::dot4(wkvc::ld4(o + H * h), xs, py[q]);
          if (next) pa[q] = wkvc::dot4(wkvc::ld4(o + NO + 4 * S + H * h), xs, pa[q]);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          py[q] += __shfl_xor_sync(mask, py[q], off);
          pa[q] += __shfl_xor_sync(mask, pa[q], off);
        }
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        if (p == 0) y[static_cast<size_t>(t) * BH * S + q * rs / S] = py[q];
        sa[q] = pa[q];
      }
    }
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) *reinterpret_cast<float4*>(row + q * rs + 4 * p + H * h) = x[q][h];
  }
};

}  // namespace

// r, w, k, v, a, b: [T, BH, S] f32; s0, s_out: [BH, S, S]; y: [T, BH, S];
// scratch: wkv_chunk_plan's scratch_floats; flags: the wrapper's zeroed
// int32 buffer of at least 2 + n_chunks * BH. S must be 32, 64 or 128;
// sms the card's SM count.
extern "C" int rwkv_wkv7_twopass(const void* r, const void* w, const void* k, const void* v,
                                 const void* a, const void* b, const void* s0, void* y,
                                 void* s_out, void* scratch, void* flags, int T, int BH, int S,
                                 int sms, void* stream) {
  wkvc::Args args{};
  const void* xs[6] = {r, w, k, v, a, b};
  for (int q = 0; q < 6; ++q) args.x[q] = static_cast<const float*>(xs[q]);
  args.s0 = static_cast<const float*>(s0);
  args.y = static_cast<float*>(y);
  args.s_out = static_cast<float*>(s_out);
  args.scratch = static_cast<float*>(scratch);
  args.flags = static_cast<unsigned*>(flags);
  return wkvc::launch<K7>(args, T, BH, S, sms, stream);
}
