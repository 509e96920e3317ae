// K5: the wkv6 recurrence over a whole sequence (v5/v6 prefill), in the
// chunked two-pass form of the TPU kernel.
//
// Replaces rwkv_tpu/ops/chunked.py::wkv6_chunked_pallas (kernel body
// _wkv6_chunk_kernel), reached through wkv6_auto. Same function: for every
// (batch*head) bh, from state s0[bh] (S x S, row i = value dim, column j =
// key dim), per token t
//   y_i   = sum_j S_ij r_j + v_i * sum_j r_j tf_j k_j   (the OLD state)
//   S_ij <- S_ij w_j + k_j v_i
// giving y [T, BH, S] and the final state. Operands are [T, BH, S] f32
// (heads folded with batch, as wkv6_auto folds them; v5's static decay
// broadcast over T by the caller), tf [BH, S].
//
// Bound on this card: (5 T BH S + BH S + 2 BH S^2) * 4 bytes over HBM
// bandwidth (about 3.4 us at T=256, BH=32, S=64). The parent's token
// recurrence, one block a head, took ~0.69 us a token. Design: K2's
// two-pass skeleton (wkv_chunk.cuh) with the TPU kernel's chunk body,
// P = 16: pass A builds, for every (chunk, head) pair in parallel, lcum
// (the in-chunk cumulative sum of log max(w, 1e-38)), lcex = lcum - lw,
// rq = r e^lcex, kap = k e^(last - lcum), the EXACT pair weights
// e^min(lcex_t - lcum_u, 0) of att_tu = sum_j r_tj k_uj e^(...) for u < t,
// diag_t = sum_j r_tj tf_j k_tj and Y = att v + diag v. v6's decay is
// unbounded (w = exp(-exp(.)) may underflow to 0), so no de-decayed factor
// e^-lcum appears: every exponent is <= 0, finite for any decay; lcum and
// lcex are summed in float64, since the exponents are their differences.
// Pass B carries each group of state rows through the chunks,
//   out_c = rq_c T_c^T + Y_c,   T_{c+1} = T_c diag(e^last) + v^T kap,
// 2PS f32 FMAs a row a chunk. Below recurrence_below's T the launch runs
// the token recurrence, S / 8 lanes a row. No fast math: the 1e-38 floor
// is subnormal.
#include "common.cuh"
#include "wkv_chunk.cuh"

namespace {

using wkvc::kCompute;
using wkvc::kP;

struct K6 {
  static constexpr int kKind = 6;

  // Pass A of item (c, bh): the operators into `out` (rq as [S][P]; kap as
  // [P][S]; e^last [S]; then a row i's v, Y as [S][2P]). lcum and lcex are
  // summed in float64: with decays that underflow (lw = log 1e-38 a token)
  // |lcum| reaches ~1400, where a float's rounding would put ~1e-4 into
  // the exponents of the pair weights, which are differences of two sums.
  template <int S>
  static __device__ void pass_a(const wkvc::Args& a, int c, int bh, float* sm, float* out) {
    constexpr int SP = S + 4, PP = kP + 1;
    float* LW = sm;
    float* RR = LW + kP * SP;
    float* KK = RR + kP * SP;
    float* VV = KK + kP * SP;
    double* LC = reinterpret_cast<double*>(VV + kP * SP);  // lcum
    double* LX = LC + kP * SP;                             // lcex = lcum - lw
    float* AT = reinterpret_cast<float*>(LX + kP * SP);    // att [P][P + 1]
    float* DG = AT + kP * PP;                              // diag [P]
    float* ET = out;
    float* KA = out + kP * S;
    float* EL = out + 2 * kP * S;
    float* RS = EL + S;
    const float* tf = a.x[4] + static_cast<size_t>(bh) * S;
    const int tid = threadIdx.x;

    {  // the chunk's operands r 0, k 1, v 2, w 3 (as log max(w, 1e-38))
      const int ops[4] = {0, 1, 2, 3};
      float* const dst[4] = {RR, KK, VV, LW};
      wkvc::load_chunk<S, 4>(a, ops, 3, 1e-38f, c, bh, dst, SP);
    }
    stream::csync();
    wkvc::cumsum_cols<S, double>(LW, LC, SP);
    stream::csync();
    for (int idx = tid; idx < kP * S; idx += kCompute) {
      const int t = idx / S, j = idx - t * S, o = t * SP + j;
      const double lc = LC[o];
      LX[o] = lc - static_cast<double>(LW[o]);
      KA[t * S + j] = KK[o] * expf(static_cast<float>(LC[(kP - 1) * SP + j] - lc));
      if (t == kP - 1) EL[j] = expf(static_cast<float>(lc));
    }
    // rq and v into their [S][P] layouts, t fastest (neighbouring threads
    // write neighbouring floats)
    for (int idx = tid; idx < kP * S; idx += kCompute) {
      const int t = idx & (kP - 1), j = idx >> 4, o = t * SP + j;
      ET[j * kP + t] = RR[o] * expf(static_cast<float>(LC[o] - static_cast<double>(LW[o])));
      RS[j * 2 * kP + t] = VV[o];
    }
    stream::csync();
    {  // att (strictly lower, exact pair ratios) and diag: one (t, u) a thread
      const int m = tid >> 4, n = tid & (kP - 1);
      float acc = 0.f;
      if (n < m) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int j = 0; j < S; j += 4) {
          const float4 r = wkvc::ld4(RR + m * SP + j), k = wkvc::ld4(KK + n * SP + j);
          const double2 x0 = *reinterpret_cast<const double2*>(LX + m * SP + j);
          const double2 x1 = *reinterpret_cast<const double2*>(LX + m * SP + j + 2);
          const double2 l0 = *reinterpret_cast<const double2*>(LC + n * SP + j);
          const double2 l1 = *reinterpret_cast<const double2*>(LC + n * SP + j + 2);
          part[0] += r.x * k.x * expf(fminf(static_cast<float>(x0.x - l0.x), 0.f));
          part[1] += r.y * k.y * expf(fminf(static_cast<float>(x0.y - l0.y), 0.f));
          part[2] += r.z * k.z * expf(fminf(static_cast<float>(x1.x - l1.x), 0.f));
          part[3] += r.w * k.w * expf(fminf(static_cast<float>(x1.y - l1.y), 0.f));
        }
        acc = (part[0] + part[1]) + (part[2] + part[3]);
      } else if (n == m) {
        for (int j = 0; j < S; ++j) acc += RR[m * SP + j] * tf[j] * KK[m * SP + j];
        DG[m] = acc;
        acc = 0.f;
      }
      AT[m * PP + n] = acc;
    }
    stream::csync();
    // Y = att v + diag v
    wkvc::mm_strip<S>([&](int m, int k) { return AT[m * PP + k]; }, VV, SP,
                      [&](int m, int n, float4 v) {
                        const float4 vm = wkvc::ld4(VV + m * SP + n);
                        RS[n * 2 * kP + kP + m] = v.x + DG[m] * vm.x;
                        RS[(n + 1) * 2 * kP + kP + m] = v.y + DG[m] * vm.y;
                        RS[(n + 2) * 2 * kP + kP + m] = v.z + DG[m] * vm.z;
                        RS[(n + 3) * 2 * kP + kP + m] = v.w + DG[m] * vm.w;
                      });
  }

  // Pass B's chunk step for the warp's rows q0 .. q0 + RB - 1: lane l sums
  // rq_t . T_i over the columns j = 2 jj + l / 16 (t = l % 16), the halves
  // meet by a shuffle, and lanes 0..P-1 write out_t = that + Y_t (the
  // tokens before T: `left`); then T_i <- T_i e^last + sum_t v_t kap_t.
  template <int S, int RB>
  static __device__ __forceinline__ void chunk(const float* st, float* tst, int W, int q0,
                                               float* yc, int left, int BH) {
    constexpr int JL = S / 32;
    const float* ET = st;
    const float* KA = st + kP * S;
    const float* EL = st + 2 * kP * S;
    const float* RS = EL + S;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = lane & (kP - 1), h = lane >> 4;
    int ii[RB];
    float acc[RB][2];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ii[r] = warp + W * (q0 + r);
      acc[r][0] = acc[r][1] = 0.f;
    }
    // groups of 8 of the lane's columns, each group's loads before its
    // FMAs (the whole loop unrolled)
#pragma unroll
    for (int jj = 0; jj < S / 2; jj += 8) {
      float e[8], tv[RB][8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = 2 * (jj + q) + h;
        e[q] = ET[j * kP + t];
#pragma unroll
        for (int r = 0; r < RB; ++r) tv[r][q] = tst[ii[r] * S + j];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r][q & 1] = fmaf(tv[r][q], e[q], acc[r][q & 1]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float o = acc[r][0] + acc[r][1];
      o += __shfl_xor_sync(0xffffffffu, o, 16);
      if (lane < kP && t < left)
        yc[static_cast<size_t>(t) * BH * S + ii[r]] = o + RS[ii[r] * 2 * kP + kP + t];
    }
    float x[RB][JL], xv[RB][JL];
#pragma unroll
    for (int m = 0; m < JL; ++m) {
      const float el = EL[lane + 32 * m];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        x[r][m] = tst[ii[r] * S + lane + 32 * m] * el;
        xv[r][m] = 0.f;
      }
    }
    // groups of 4 tokens, each group's loads before its FMAs
#pragma unroll
    for (int u0 = 0; u0 < kP; u0 += 4) {
      float vt[RB][4], ka[4][JL];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < RB; ++r) vt[r][q] = RS[ii[r] * 2 * kP + u0 + q];
#pragma unroll
        for (int m = 0; m < JL; ++m) ka[q][m] = KA[(u0 + q) * S + lane + 32 * m];
      }
#pragma unroll
      for (int q = 0; q < 4; q += 2)
#pragma unroll
        for (int m = 0; m < JL; ++m)
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            x[r][m] = fmaf(vt[r][q], ka[q][m], x[r][m]);
            xv[r][m] = fmaf(vt[r][q + 1], ka[q + 1][m], xv[r][m]);
          }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int m = 0; m < JL; ++m) tst[ii[r] * S + lane + 32 * m] = x[r][m] + xv[r][m];
  }

  // The recurrence for NR state rows (local rows ii + q 2048 / S, q < NR,
  // at `row` + q `rs` floats) over a tile of nt tokens (ops: the tokens' r,
  // k, v, w, [nt][4][S]; tf [S]): lane p of a row's S / 8 holds entries
  // j = 4 p + S / 2 h + c (h < 2, c < 4), read as float4s.
  template <int S, int NR>
  static __device__ __forceinline__ void rows(const float* ops, int nt, const float* tf,
                                              float* row, int rs, int p, unsigned mask, int i,
                                              float* y, int BH) {
    constexpr int LPR = S / 8, H = S / 2;
    float4 x[NR][2], tfj[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tfj[h] = wkvc::ld4(tf + 4 * p + H * h);
#pragma unroll
      for (int q = 0; q < NR; ++q) x[q][h] = wkvc::ld4(row + q * rs + 4 * p + H * h);
    }
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float* o = ops + t * 4 * S + 4 * p;
      float py[NR], pd[NR], vi[NR];
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        vi[q] = ops[t * 4 * S + 2 * S + i + q * rs / S];
        py[q] = pd[q] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 r = wkvc::ld4(o + H * h), k = wkvc::ld4(o + S + H * h);
        const float4 w = wkvc::ld4(o + 3 * S + H * h);
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          float4& xs = x[q][h];
          py[q] = wkvc::dot4(xs, r, py[q]);
          pd[q] = fmaf(r.x * tfj[h].x, k.x, pd[q]);
          pd[q] = fmaf(r.y * tfj[h].y, k.y, pd[q]);
          pd[q] = fmaf(r.z * tfj[h].z, k.z, pd[q]);
          pd[q] = fmaf(r.w * tfj[h].w, k.w, pd[q]);
          xs.x = fmaf(k.x, vi[q], xs.x * w.x);
          xs.y = fmaf(k.y, vi[q], xs.y * w.y);
          xs.z = fmaf(k.z, vi[q], xs.z * w.z);
          xs.w = fmaf(k.w, vi[q], xs.w * w.w);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < NR; ++q) {
          py[q] += __shfl_xor_sync(mask, py[q], off);
          pd[q] += __shfl_xor_sync(mask, pd[q], off);
        }
#pragma unroll
      for (int q = 0; q < NR; ++q)
        if (p == 0) y[static_cast<size_t>(t) * BH * S + q * rs / S] = py[q] + vi[q] * pd[q];
    }
#pragma unroll
    for (int q = 0; q < NR; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) *reinterpret_cast<float4*>(row + q * rs + 4 * p + H * h) = x[q][h];
  }
};

}  // namespace

// r, k, v, w: [T, BH, S] f32; tf: [BH, S]; s0, s_out: [BH, S, S];
// y: [T, BH, S]; scratch: wkv_chunk_plan's scratch_floats; flags: the
// wrapper's zeroed int32 buffer of at least 2 + n_chunks * BH. S must be
// 32, 64 or 128; sms the card's SM count.
extern "C" int rwkv_wkv6_twopass(const void* r, const void* k, const void* v, const void* w,
                                 const void* tf, const void* s0, void* y, void* s_out,
                                 void* scratch, void* flags, int T, int BH, int S, int sms,
                                 void* stream) {
  wkvc::Args args{};
  const void* xs[5] = {r, k, v, w, tf};
  for (int q = 0; q < 5; ++q) args.x[q] = static_cast<const float*>(xs[q]);
  args.s0 = static_cast<const float*>(s0);
  args.y = static_cast<float*>(y);
  args.s_out = static_cast<float*>(s_out);
  args.scratch = static_cast<float*>(scratch);
  args.flags = static_cast<unsigned*>(flags);
  return wkvc::launch<K6>(args, T, BH, S, sms, stream);
}
