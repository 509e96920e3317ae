// Native host-side data plane of rwkv_tpu_torch. See rwkv_native.h.
//
// Numerics contract: the block codecs are bit-exact with ggml's reference
// quantizers (and with rwkv_tpu_torch/io/quant.py, byte-identical to the
// JAX package's rwkv_tpu/io/quant.py). FP16 conversion is IEEE
// round-to-nearest-even.

#include "rwkv_native.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Error handling
// ---------------------------------------------------------------------------

static thread_local std::string g_last_error;

static int set_error(const char *msg) {
    g_last_error = msg ? msg : "";
    return -1;
}

extern "C" RWKV_NATIVE_API const char *rwkv_native_last_error(void) {
    return g_last_error.c_str();
}

// ---------------------------------------------------------------------------
// FP16 <-> FP32 (IEEE, round-to-nearest-even)
// ---------------------------------------------------------------------------

static inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    const uint32_t sign = (x >> 16) & 0x8000u;
    uint32_t mant = x & 0x007FFFFFu;
    int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
    if (((x >> 23) & 0xFF) == 0xFF) {  // inf/nan
        return (uint16_t)(sign | 0x7C00u | (mant ? 0x0200u | (mant >> 13) : 0));
    }
    if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;  // underflow -> 0
        // subnormal: shift with round-to-nearest-even
        mant |= 0x00800000u;
        uint32_t shift = (uint32_t)(14 - exp);
        uint32_t half = mant >> shift;
        uint32_t rem = mant & ((1u << shift) - 1);
        uint32_t halfway = 1u << (shift - 1);
        if (rem > halfway || (rem == halfway && (half & 1))) half++;
        return (uint16_t)(sign | half);
    }
    uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFFu;
    if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
    return (uint16_t)(sign | half);
}

static inline float f16_to_f32(uint16_t h) {
    const uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    const uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FFu;
    uint32_t x;
    if (exp == 0) {
        if (mant == 0) {
            x = sign;
        } else {  // subnormal
            int e = -1;
            do {
                e++;
                mant <<= 1;
            } while (!(mant & 0x400u));
            mant &= 0x3FFu;
            x = sign | (uint32_t)(127 - 15 - e) << 23 | (mant << 13);
        }
    } else if (exp == 0x1F) {
        x = sign | 0x7F800000u | (mant << 13);
    } else {
        x = sign | (exp - 15 + 127) << 23 | (mant << 13);
    }
    float f;
    std::memcpy(&f, &x, 4);
    return f;
}

// ---------------------------------------------------------------------------
// Block quantization codecs (QK = 32)
// ---------------------------------------------------------------------------

enum {
    DT_F32 = 0, DT_F16 = 1, DT_Q4_0 = 2, DT_Q4_1 = 3,
    DT_Q5_0 = 7, DT_Q5_1 = 8, DT_Q8_0 = 9,
    DT_Q4_K = 13, DT_Q5_K = 14,
};

static const int QK = 32;
static const int QK_K = 256;      // K-quant superblock elements
static const int K_SCALE_SIZE = 12;

static int64_t block_bytes(uint32_t dtype) {
    switch (dtype) {
        case DT_F32:  return 4 * QK;
        case DT_F16:  return 2 * QK;
        case DT_Q4_0: return 2 + 16;
        case DT_Q4_1: return 2 + 2 + 16;
        case DT_Q5_0: return 2 + 4 + 16;
        case DT_Q5_1: return 2 + 2 + 4 + 16;
        case DT_Q8_0: return 2 + 32;
        case DT_Q4_K: return 2 + 2 + K_SCALE_SIZE + QK_K / 2;
        case DT_Q5_K: return 2 + 2 + K_SCALE_SIZE + QK_K / 8 + QK_K / 2;
        default:      return -1;
    }
}

static int block_elems(uint32_t dtype) {
    return (dtype == DT_Q4_K || dtype == DT_Q5_K) ? QK_K : QK;
}

extern "C" RWKV_NATIVE_API int64_t rwkv_quant_row_size(uint32_t dtype, int64_t n) {
    int64_t bb = block_bytes(dtype);
    if (bb < 0) return -1;
    if (dtype == DT_F32) return n * 4;
    if (dtype == DT_F16) return n * 2;
    int be = block_elems(dtype);
    if (n % be) return -1;
    return (n / be) * bb;
}

// Signed absmax, first occurrence winning on strict '>' (ggml semantics).
static inline float signed_absmax(const float *x) {
    float amax = 0.0f, smax = 0.0f;
    for (int i = 0; i < QK; i++) {
        float a = std::fabs(x[i]);
        if (a > amax) { amax = a; smax = x[i]; }
    }
    return smax;
}

static void enc_q4_0(const float *x, uint8_t *dst) {
    const float smax = signed_absmax(x);
    const float d = smax / -8.0f;
    const float id = d ? 1.0f / d : 0.0f;
    uint16_t dh = f32_to_f16(d);
    std::memcpy(dst, &dh, 2);
    for (int j = 0; j < 16; j++) {
        int xi0 = (int)(x[j] * id + 8.5f);
        int xi1 = (int)(x[j + 16] * id + 8.5f);
        if (xi0 > 15) xi0 = 15;
        if (xi1 > 15) xi1 = 15;
        dst[2 + j] = (uint8_t)(xi0 | (xi1 << 4));
    }
}

static void enc_q4_1(const float *x, uint8_t *dst) {
    float mn = x[0], mx = x[0];
    for (int i = 1; i < QK; i++) {
        if (x[i] < mn) mn = x[i];
        if (x[i] > mx) mx = x[i];
    }
    const float d = (mx - mn) / 15.0f;
    const float id = d ? 1.0f / d : 0.0f;
    uint16_t dh = f32_to_f16(d), mh = f32_to_f16(mn);
    std::memcpy(dst, &dh, 2);
    std::memcpy(dst + 2, &mh, 2);
    for (int j = 0; j < 16; j++) {
        int xi0 = (int)((x[j] - mn) * id + 0.5f);
        int xi1 = (int)((x[j + 16] - mn) * id + 0.5f);
        if (xi0 > 15) xi0 = 15;
        if (xi1 > 15) xi1 = 15;
        dst[4 + j] = (uint8_t)(xi0 | (xi1 << 4));
    }
}

static void enc_q5_0(const float *x, uint8_t *dst) {
    const float smax = signed_absmax(x);
    const float d = smax / -16.0f;
    const float id = d ? 1.0f / d : 0.0f;
    uint16_t dh = f32_to_f16(d);
    std::memcpy(dst, &dh, 2);
    uint32_t qh = 0;
    for (int j = 0; j < 16; j++) {
        int xi0 = (int)(x[j] * id + 16.5f);
        int xi1 = (int)(x[j + 16] * id + 16.5f);
        if (xi0 > 31) xi0 = 31;
        if (xi1 > 31) xi1 = 31;
        dst[6 + j] = (uint8_t)((xi0 & 0xF) | ((xi1 & 0xF) << 4));
        qh |= (uint32_t)((xi0 >> 4) & 1) << j;
        qh |= (uint32_t)((xi1 >> 4) & 1) << (j + 16);
    }
    std::memcpy(dst + 2, &qh, 4);
}

static void enc_q5_1(const float *x, uint8_t *dst) {
    float mn = x[0], mx = x[0];
    for (int i = 1; i < QK; i++) {
        if (x[i] < mn) mn = x[i];
        if (x[i] > mx) mx = x[i];
    }
    const float d = (mx - mn) / 31.0f;
    const float id = d ? 1.0f / d : 0.0f;
    uint16_t dh = f32_to_f16(d), mh = f32_to_f16(mn);
    std::memcpy(dst, &dh, 2);
    std::memcpy(dst + 2, &mh, 2);
    uint32_t qh = 0;
    for (int j = 0; j < 16; j++) {
        int xi0 = (int)((x[j] - mn) * id + 0.5f);
        int xi1 = (int)((x[j + 16] - mn) * id + 0.5f);
        if (xi0 > 31) xi0 = 31;
        if (xi1 > 31) xi1 = 31;
        dst[8 + j] = (uint8_t)((xi0 & 0xF) | ((xi1 & 0xF) << 4));
        qh |= (uint32_t)((xi0 >> 4) & 1) << j;
        qh |= (uint32_t)((xi1 >> 4) & 1) << (j + 16);
    }
    std::memcpy(dst + 4, &qh, 4);
}

static void enc_q8_0(const float *x, uint8_t *dst) {
    float amax = 0.0f;
    for (int i = 0; i < QK; i++) {
        float a = std::fabs(x[i]);
        if (a > amax) amax = a;
    }
    const float d = amax / 127.0f;
    const float id = d ? 1.0f / d : 0.0f;
    uint16_t dh = f32_to_f16(d);
    std::memcpy(dst, &dh, 2);
    for (int i = 0; i < QK; i++) {
        ((int8_t *)(dst + 2))[i] = (int8_t)std::roundf(x[i] * id);
    }
}

// ---------------------------------------------------------------------------
// K-quant superblock codecs (Q4_K / Q5_K), mirroring ggml's reference
// quantizers (quantize_row_q4_K_ref / q5_K_ref + make_qkx2_quants) with
// identical f32 arithmetic and accumulation order — byte-compatible with
// io/quant.py's numpy codecs (gated by tests/test_native.py).
// ---------------------------------------------------------------------------

static inline int nearest_int(float v) {
    // round-half-to-even via the 2^22*1.5 magic constant (ggml's trick)
    float val = v + 12582912.0f;
    int i;
    std::memcpy(&i, &val, sizeof(int));
    return (i & 0x007fffff) - 0x00400000;
}

static float make_qkx2_quants(int n, int nmax, const float *x,
                              const float *weights, uint8_t *L,
                              float *the_min, uint8_t *Laux, float rmin,
                              float rdelta, int nstep) {
    float mn = x[0], mx = x[0];
    float sum_w = weights[0];
    float sum_x = sum_w * x[0];
    for (int i = 1; i < n; ++i) {
        if (x[i] < mn) mn = x[i];
        if (x[i] > mx) mx = x[i];
        float w = weights[i];
        sum_w += w;
        sum_x += w * x[i];
    }
    if (mn > 0) mn = 0;
    if (mx == mn) {
        for (int i = 0; i < n; ++i) L[i] = 0;
        *the_min = -mn;
        return 0.f;
    }
    float iscale = nmax / (mx - mn);
    float scale = 1 / iscale;
    float best_mad = 0;
    for (int i = 0; i < n; ++i) {
        int l = nearest_int(iscale * (x[i] - mn));
        L[i] = (uint8_t)std::max(0, std::min(nmax, l));
        float diff = scale * L[i] + mn - x[i];
        best_mad += weights[i] * diff * diff;
    }
    for (int is = 0; is <= nstep; ++is) {
        iscale = (rmin + rdelta * is + nmax) / (mx - mn);
        float sum_l = 0, sum_l2 = 0, sum_xl = 0;
        for (int i = 0; i < n; ++i) {
            int l = nearest_int(iscale * (x[i] - mn));
            l = std::max(0, std::min(nmax, l));
            Laux[i] = (uint8_t)l;
            float w = weights[i];
            sum_l += w * l;
            sum_l2 += w * l * l;
            sum_xl += w * l * x[i];
        }
        float D = sum_w * sum_l2 - sum_l * sum_l;
        if (D > 0) {
            float this_scale = (sum_w * sum_xl - sum_x * sum_l) / D;
            float this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D;
            if (this_min > 0) {
                this_min = 0;
                this_scale = sum_xl / sum_l2;
            }
            float mad = 0;
            for (int i = 0; i < n; ++i) {
                float diff = this_scale * Laux[i] + this_min - x[i];
                mad += weights[i] * diff * diff;
            }
            if (mad < best_mad) {
                for (int i = 0; i < n; ++i) L[i] = Laux[i];
                best_mad = mad;
                scale = this_scale;
                mn = this_min;
            }
        }
    }
    *the_min = -mn;
    return scale;
}

static void get_scale_min_k4(int j, const uint8_t *q, uint8_t *d, uint8_t *m) {
    if (j < 4) {
        *d = q[j] & 63;
        *m = q[j + 4] & 63;
    } else {
        *d = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
        *m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
    }
}

// Shared Q4_K/Q5_K superblock scale fit: fills L[QK_K] codes, the packed
// 6-bit scales, and the fp16 super-scales at dst[0:4]+dst[4:16].
static void enc_k_common(const float *x, uint8_t *dst, int nmax, float rmin,
                         float rdelta, int nstep, uint8_t *L) {
    float scales[8], mins[8], weights[32];
    uint8_t Laux[32];
    float max_scale = 0, max_min = 0;
    for (int j = 0; j < 8; ++j) {
        float sum_x2 = 0;
        for (int l = 0; l < 32; ++l) sum_x2 += x[32 * j + l] * x[32 * j + l];
        float av_x = std::sqrt(sum_x2 / 32);
        for (int l = 0; l < 32; ++l) weights[l] = av_x + std::fabs(x[32 * j + l]);
        scales[j] = make_qkx2_quants(32, nmax, x + 32 * j, weights, L + 32 * j,
                                     &mins[j], Laux, rmin, rdelta, nstep);
        if (scales[j] > max_scale) max_scale = scales[j];
        if (mins[j] > max_min) max_min = mins[j];
    }
    float inv_scale = max_scale > 0 ? 63.f / max_scale : 0.f;
    float inv_min = max_min > 0 ? 63.f / max_min : 0.f;
    uint8_t *sc = dst + 4;
    std::memset(sc, 0, K_SCALE_SIZE);
    for (int j = 0; j < 8; ++j) {
        uint8_t ls = (uint8_t)std::min(63, nearest_int(inv_scale * scales[j]));
        uint8_t lm = (uint8_t)std::min(63, nearest_int(inv_min * mins[j]));
        if (j < 4) {
            sc[j] = ls;
            sc[j + 4] = lm;
        } else {
            sc[j + 4] = (uint8_t)((ls & 0xF) | ((lm & 0xF) << 4));
            sc[j - 4] |= (uint8_t)((ls >> 4) << 6);
            sc[j] |= (uint8_t)((lm >> 4) << 6);
        }
    }
    uint16_t d16 = f32_to_f16(max_scale / 63.f);
    uint16_t dmin16 = f32_to_f16(max_min / 63.f);
    std::memcpy(dst, &d16, 2);
    std::memcpy(dst + 2, &dmin16, 2);
    // recompute codes against the fp16-rounded super-scales
    float df = f16_to_f32(d16), dmf = f16_to_f32(dmin16);
    for (int j = 0; j < 8; ++j) {
        uint8_t s8v, m8v;
        get_scale_min_k4(j, sc, &s8v, &m8v);
        float d = df * s8v;
        if (!d) continue;
        float dm = dmf * m8v;
        for (int ii = 0; ii < 32; ++ii) {
            int l = nearest_int((x[32 * j + ii] + dm) / d);
            L[32 * j + ii] = (uint8_t)std::max(0, std::min(nmax, l));
        }
    }
}

static void enc_q4_k(const float *x, uint8_t *dst) {
    uint8_t L[QK_K];
    enc_k_common(x, dst, 15, -1.f, 0.1f, 20, L);
    uint8_t *q = dst + 16;
    for (int j = 0; j < QK_K; j += 64) {
        for (int l = 0; l < 32; ++l)
            q[l] = (uint8_t)(L[j + l] | (L[j + l + 32] << 4));
        q += 32;
    }
}

static void enc_q5_k(const float *x, uint8_t *dst) {
    uint8_t L[QK_K];
    enc_k_common(x, dst, 31, -0.5f, 0.1f, 15, L);
    uint8_t *qh = dst + 16;
    uint8_t *ql = dst + 48;
    std::memset(qh, 0, QK_K / 8);
    uint8_t m1 = 1, m2 = 2;
    for (int n = 0; n < QK_K; n += 64) {
        for (int j = 0; j < 32; ++j) {
            int l1 = L[n + j];
            if (l1 > 15) { l1 -= 16; qh[j] |= m1; }
            int l2 = L[n + j + 32];
            if (l2 > 15) { l2 -= 16; qh[j] |= m2; }
            ql[j] = (uint8_t)(l1 | (l2 << 4));
        }
        ql += 32;
        m1 <<= 2;
        m2 <<= 2;
    }
}

static void dec_k_block(uint32_t dtype, const uint8_t *src, float *out) {
    uint16_t dh, mh;
    std::memcpy(&dh, src, 2);
    std::memcpy(&mh, src + 2, 2);
    const float d = f16_to_f32(dh), dmin = f16_to_f32(mh);
    const uint8_t *sc = src + 4;
    if (dtype == DT_Q4_K) {
        const uint8_t *q = src + 16;
        int is = 0;
        for (int j = 0; j < QK_K; j += 64) {
            uint8_t s1, m1v, s2, m2v;
            get_scale_min_k4(is + 0, sc, &s1, &m1v);
            get_scale_min_k4(is + 1, sc, &s2, &m2v);
            const float d1 = d * s1, mm1 = dmin * m1v;
            const float d2 = d * s2, mm2 = dmin * m2v;
            for (int l = 0; l < 32; ++l) *out++ = d1 * (q[l] & 0xF) - mm1;
            for (int l = 0; l < 32; ++l) *out++ = d2 * (q[l] >> 4) - mm2;
            q += 32;
            is += 2;
        }
    } else {
        const uint8_t *qh = src + 16;
        const uint8_t *ql = src + 48;
        int is = 0;
        uint8_t u1 = 1, u2 = 2;
        for (int j = 0; j < QK_K; j += 64) {
            uint8_t s1, m1v, s2, m2v;
            get_scale_min_k4(is + 0, sc, &s1, &m1v);
            get_scale_min_k4(is + 1, sc, &s2, &m2v);
            const float d1 = d * s1, mm1 = dmin * m1v;
            const float d2 = d * s2, mm2 = dmin * m2v;
            for (int l = 0; l < 32; ++l)
                *out++ = d1 * ((ql[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - mm1;
            for (int l = 0; l < 32; ++l)
                *out++ = d2 * ((ql[l] >> 4) + ((qh[l] & u2) ? 16 : 0)) - mm2;
            ql += 32;
            is += 2;
            u1 <<= 2;
            u2 <<= 2;
        }
    }
}

static void dec_block(uint32_t dtype, const uint8_t *src, float *out) {
    switch (dtype) {
        case DT_Q4_0: {
            uint16_t dh; std::memcpy(&dh, src, 2);
            float d = f16_to_f32(dh);
            for (int j = 0; j < 16; j++) {
                out[j] = ((src[2 + j] & 0xF) - 8) * d;
                out[j + 16] = ((src[2 + j] >> 4) - 8) * d;
            }
            break;
        }
        case DT_Q4_1: {
            uint16_t dh, mh;
            std::memcpy(&dh, src, 2); std::memcpy(&mh, src + 2, 2);
            float d = f16_to_f32(dh), m = f16_to_f32(mh);
            for (int j = 0; j < 16; j++) {
                out[j] = (src[4 + j] & 0xF) * d + m;
                out[j + 16] = (src[4 + j] >> 4) * d + m;
            }
            break;
        }
        case DT_Q5_0: {
            uint16_t dh; std::memcpy(&dh, src, 2);
            uint32_t qh; std::memcpy(&qh, src + 2, 4);
            float d = f16_to_f32(dh);
            for (int j = 0; j < 16; j++) {
                int q0 = (src[6 + j] & 0xF) | (int)(((qh >> j) & 1) << 4);
                int q1 = (src[6 + j] >> 4) | (int)(((qh >> (j + 16)) & 1) << 4);
                out[j] = (q0 - 16) * d;
                out[j + 16] = (q1 - 16) * d;
            }
            break;
        }
        case DT_Q5_1: {
            uint16_t dh, mh;
            std::memcpy(&dh, src, 2); std::memcpy(&mh, src + 2, 2);
            uint32_t qh; std::memcpy(&qh, src + 4, 4);
            float d = f16_to_f32(dh), m = f16_to_f32(mh);
            for (int j = 0; j < 16; j++) {
                int q0 = (src[8 + j] & 0xF) | (int)(((qh >> j) & 1) << 4);
                int q1 = (src[8 + j] >> 4) | (int)(((qh >> (j + 16)) & 1) << 4);
                out[j] = q0 * d + m;
                out[j + 16] = q1 * d + m;
            }
            break;
        }
        case DT_Q8_0: {
            uint16_t dh; std::memcpy(&dh, src, 2);
            float d = f16_to_f32(dh);
            const int8_t *q = (const int8_t *)(src + 2);
            for (int i = 0; i < QK; i++) out[i] = q[i] * d;
            break;
        }
        case DT_Q4_K:
        case DT_Q5_K:
            dec_k_block(dtype, src, out);
            break;
        default: break;
    }
}

typedef void (*enc_fn)(const float *, uint8_t *);

static enc_fn encoder_for(uint32_t dtype) {
    switch (dtype) {
        case DT_Q4_0: return enc_q4_0;
        case DT_Q4_1: return enc_q4_1;
        case DT_Q5_0: return enc_q5_0;
        case DT_Q5_1: return enc_q5_1;
        case DT_Q8_0: return enc_q8_0;
        case DT_Q4_K: return enc_q4_k;
        case DT_Q5_K: return enc_q5_k;
        default:      return nullptr;
    }
}

static void parallel_blocks(int64_t n_blocks, int n_threads,
                            const std::function<void(int64_t, int64_t)> &fn) {
    if (n_threads <= 1 || n_blocks < 1024) {
        fn(0, n_blocks);
        return;
    }
    std::vector<std::thread> threads;
    int64_t per = (n_blocks + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n_blocks, lo + per);
        if (lo >= hi) break;
        threads.emplace_back([=, &fn] { fn(lo, hi); });
    }
    for (auto &th : threads) th.join();
}

extern "C" RWKV_NATIVE_API int rwkv_quantize_block_data(
    uint32_t dtype, const float *src, uint8_t *dst, int64_t n, int n_threads) {
    enc_fn enc = encoder_for(dtype);
    if (!enc) return set_error("unsupported quant dtype");
    const int be = block_elems(dtype);
    if (n % be) return set_error("element count not a multiple of the block size");
    const int64_t bb = block_bytes(dtype);
    parallel_blocks(n / be, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; b++) enc(src + b * be, dst + b * bb);
    });
    return 0;
}

extern "C" RWKV_NATIVE_API int rwkv_dequantize_block_data(
    uint32_t dtype, const uint8_t *src, float *dst, int64_t n, int n_threads) {
    if (!encoder_for(dtype)) return set_error("unsupported quant dtype");
    const int be = block_elems(dtype);
    if (n % be) return set_error("element count not a multiple of the block size");
    const int64_t bb = block_bytes(dtype);
    parallel_blocks(n / be, n_threads, [&](int64_t lo, int64_t hi) {
        for (int64_t b = lo; b < hi; b++) dec_block(dtype, src + b * bb, dst + b * be);
    });
    return 0;
}

// ---------------------------------------------------------------------------
// ggmf file inspection + streaming requantization
// ---------------------------------------------------------------------------

struct FileCloser {
    void operator()(FILE *f) const { if (f) std::fclose(f); }
};
using FilePtr = std::unique_ptr<FILE, FileCloser>;

extern "C" RWKV_NATIVE_API int rwkv_ggmf_read_header(const char *path,
                                                     rwkv_ggmf_header *out) {
    FilePtr f(std::fopen(path, "rb"));
    if (!f) return set_error("failed to open file");
    if (std::fread(out, sizeof(*out), 1, f.get()) != 1)
        return set_error("truncated header");
    if (out->magic != 0x67676d66u) return set_error("bad magic");
    if (out->version < 100 || out->version > 101) return set_error("bad version");
    return 0;
}

static int read_tensor_record(FILE *f, rwkv_ggmf_tensor_info *info, bool skip_data) {
    uint32_t head[3];
    size_t got = std::fread(head, 4, 3, f);
    if (got == 0) return 1;  // clean EOF
    if (got != 3) return set_error("truncated tensor header");
    uint32_t dims = head[0], key_len = head[1], dtype = head[2];
    if (dims < 1 || dims > 3) return set_error("invalid dim count");
    if (key_len >= sizeof(info->name)) return set_error("tensor name too long");
    uint32_t sizes[4] = {1, 1, 1, 1};
    if (std::fread(sizes, 4, dims, f) != dims) return set_error("truncated dims");
    if (std::fread(info->name, 1, key_len, f) != key_len)
        return set_error("truncated name");
    info->name[key_len] = 0;
    info->dtype = dtype;
    info->n_dims = dims;
    int64_t n = 1;
    for (uint32_t i = 0; i < dims; i++) {
        // disk order is innermost-first; expose numpy order
        info->shape[i] = sizes[dims - 1 - i];
        n *= sizes[i];
    }
    int64_t nbytes = rwkv_quant_row_size(dtype, n);
    if (nbytes < 0) return set_error("unsupported tensor dtype");
    info->nbytes = (uint64_t)nbytes;
#ifdef _WIN32
    info->offset = (uint64_t)_ftelli64(f);
#else
    info->offset = (uint64_t)ftello(f);
#endif
    if (skip_data) {
#ifdef _WIN32
        _fseeki64(f, (int64_t)info->nbytes, SEEK_CUR);
#else
        fseeko(f, (off_t)info->nbytes, SEEK_CUR);
#endif
    }
    return 0;
}

extern "C" RWKV_NATIVE_API int64_t rwkv_ggmf_scan(const char *path,
                                                  rwkv_ggmf_tensor_info *infos,
                                                  int64_t max_infos) {
    FilePtr f(std::fopen(path, "rb"));
    if (!f) return set_error("failed to open file");
    rwkv_ggmf_header hdr;
    if (std::fread(&hdr, sizeof(hdr), 1, f.get()) != 1)
        return set_error("truncated header");
    int64_t count = 0;
    rwkv_ggmf_tensor_info tmp;
    for (;;) {
        rwkv_ggmf_tensor_info *dst =
            (infos && count < max_infos) ? &infos[count] : &tmp;
        int rc = read_tensor_record(f.get(), dst, true);
        if (rc == 1) break;
        if (rc != 0) return -1;
        count++;
    }
    return count;
}

// Quantization skip-list (reference rwkv_quantize.inc:1-13).
static bool tensor_needs_quant(const char *name) {
    if (!std::strcmp(name, "emb.weight") || !std::strcmp(name, "head.weight"))
        return false;
    static const char *subs[] = {
        "att.v1", "att.v2", "att.g1", "att.g2", "att.a1",
        "att.a2", "att.w1", "att.w2", "att.r_k",
    };
    for (const char *s : subs)
        if (std::strstr(name, s)) return false;
    return true;
}

extern "C" RWKV_NATIVE_API int rwkv_quantize_model_file(
    const char *in_path, const char *out_path, uint32_t target,
    int n_threads, uint64_t *orig_bytes, uint64_t *new_bytes) {
    if (!encoder_for(target)) return set_error("target is not a quantized format");
    FilePtr fin(std::fopen(in_path, "rb"));
    if (!fin) return set_error("failed to open input");
    FilePtr fout(std::fopen(out_path, "wb"));
    if (!fout) return set_error("failed to open output");

    rwkv_ggmf_header hdr;
    if (std::fread(&hdr, sizeof(hdr), 1, fin.get()) != 1)
        return set_error("truncated header");
    if (hdr.magic != 0x67676d66u) return set_error("bad magic");
    if (hdr.data_type != DT_F32 && hdr.data_type != DT_F16)
        return set_error("input must be FP32 or FP16");
    rwkv_ggmf_header out_hdr = hdr;
    out_hdr.version = 101;
    out_hdr.data_type = target;
    std::fwrite(&out_hdr, sizeof(out_hdr), 1, fout.get());

    uint64_t orig_total = 0, new_total = 0;
    std::vector<uint8_t> raw;
    std::vector<float> f32buf;
    std::vector<uint8_t> packed;

    for (;;) {
        rwkv_ggmf_tensor_info info;
        int rc = read_tensor_record(fin.get(), &info, false);
        if (rc == 1) break;
        if (rc != 0) return -1;

        raw.resize(info.nbytes);
        if (std::fread(raw.data(), 1, info.nbytes, fin.get()) != info.nbytes)
            return set_error("truncated tensor data");

        int64_t n = 1;
        for (uint32_t i = 0; i < info.n_dims; i++) n *= info.shape[i];

        uint32_t out_dtype = info.dtype;
        const uint8_t *out_data = raw.data();
        uint64_t out_size = info.nbytes;

        // K-quant superblocks need rows divisible by 256; incompatible
        // tensors take the llama.cpp-convention per-tensor fallback
        // (Q4_K -> Q5_0, Q5_K -> Q5_1), matching io/quantize.py.
        uint32_t t_dtype = target;
        int64_t row = info.n_dims ? info.shape[info.n_dims - 1] : 0;
        if (target == DT_Q4_K && (row % QK_K)) t_dtype = DT_Q5_0;
        if (target == DT_Q5_K && (row % QK_K)) t_dtype = DT_Q5_1;

        bool quantize = info.n_dims == 2 &&
                        (info.dtype == DT_F32 || info.dtype == DT_F16) &&
                        tensor_needs_quant(info.name) &&
                        (n % block_elems(t_dtype)) == 0;
        if (quantize) {
            const float *src;
            if (info.dtype == DT_F16) {
                f32buf.resize(n);
                const uint16_t *h = (const uint16_t *)raw.data();
                for (int64_t i = 0; i < n; i++) f32buf[i] = f16_to_f32(h[i]);
                src = f32buf.data();
            } else {
                src = (const float *)raw.data();
            }
            out_size = (uint64_t)rwkv_quant_row_size(t_dtype, n);
            packed.resize(out_size);
            if (rwkv_quantize_block_data(t_dtype, src, packed.data(), n, n_threads))
                return -1;
            out_dtype = t_dtype;
            out_data = packed.data();
        }

        uint32_t head[3] = {info.n_dims, (uint32_t)std::strlen(info.name), out_dtype};
        std::fwrite(head, 4, 3, fout.get());
        for (uint32_t i = 0; i < info.n_dims; i++) {
            uint32_t dim = info.shape[info.n_dims - 1 - i];  // back to disk order
            std::fwrite(&dim, 4, 1, fout.get());
        }
        std::fwrite(info.name, 1, std::strlen(info.name), fout.get());
        std::fwrite(out_data, 1, out_size, fout.get());
        orig_total += info.nbytes;
        new_total += out_size;
    }
    if (orig_bytes) *orig_bytes = orig_total;
    if (new_bytes) *new_bytes = new_total;
    return 0;
}

// ---------------------------------------------------------------------------
// World trie tokenizer
// ---------------------------------------------------------------------------

struct TrieNode {
    int32_t children[256];
    int32_t token = -1;  // token id terminating here, if any
    TrieNode() { std::memset(children, 0xFF, sizeof(children)); }
};

struct rwkv_trie_tokenizer {
    std::vector<TrieNode> nodes;
    std::vector<std::string> id_to_token;  // indexed by token id
    int max_token_len = 0;

    void add(const std::string &tok, int32_t id) {
        int32_t cur = 0;
        for (unsigned char c : tok) {
            if (nodes[cur].children[c] < 0) {
                nodes[cur].children[c] = (int32_t)nodes.size();
                nodes.emplace_back();
            }
            cur = nodes[cur].children[c];
        }
        nodes[cur].token = id;
        if ((int)tok.size() > max_token_len) max_token_len = (int)tok.size();
    }
};

static void utf8_append(std::string *s, unsigned cp) {
    if (cp < 0x80) {
        s->push_back((char)cp);
    } else if (cp < 0x800) {
        s->push_back((char)(0xC0 | (cp >> 6)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        s->push_back((char)(0xE0 | (cp >> 12)));
        s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        s->push_back((char)(0xF0 | (cp >> 18)));
        s->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        s->push_back((char)(0x80 | (cp & 0x3F)));
    }
}

// Parse a python string/bytes literal (the vocab file's token field).
// In a str literal, \xNN is codepoint U+00NN (UTF-8 encoded to 1-2 bytes);
// in a bytes literal it is the raw byte NN.
static bool parse_py_literal(const std::string &lit, std::string *out) {
    size_t i = 0;
    bool is_bytes = false;
    if (i < lit.size() && (lit[i] == 'b' || lit[i] == 'B')) {
        is_bytes = true;
        i++;
    }
    if (i >= lit.size()) return false;
    char quote = lit[i];
    if (quote != '\'' && quote != '"') return false;
    i++;
    std::string s;
    while (i < lit.size() && lit[i] != quote) {
        char c = lit[i];
        if (c != '\\') {
            s.push_back(c);
            i++;
            continue;
        }
        i++;
        if (i >= lit.size()) return false;
        char e = lit[i++];
        switch (e) {
            case 'n': s.push_back('\n'); break;
            case 't': s.push_back('\t'); break;
            case 'r': s.push_back('\r'); break;
            case '0': s.push_back('\0'); break;
            case 'a': s.push_back('\a'); break;
            case 'b': s.push_back('\b'); break;
            case 'f': s.push_back('\f'); break;
            case 'v': s.push_back('\v'); break;
            case '\\': s.push_back('\\'); break;
            case '\'': s.push_back('\''); break;
            case '"': s.push_back('"'); break;
            case 'x': {
                if (i + 2 > lit.size()) return false;
                unsigned v = (unsigned)std::stoul(lit.substr(i, 2), nullptr, 16);
                i += 2;
                if (is_bytes) s.push_back((char)v);
                else utf8_append(&s, v);
                break;
            }
            case 'u': {
                if (i + 4 > lit.size()) return false;
                unsigned cp = (unsigned)std::stoul(lit.substr(i, 4), nullptr, 16);
                i += 4;
                utf8_append(&s, cp);
                break;
            }
            case 'U': {
                if (i + 8 > lit.size()) return false;
                unsigned cp = (unsigned)std::stoul(lit.substr(i, 8), nullptr, 16);
                i += 8;
                utf8_append(&s, cp);
                break;
            }
            default:
                return false;
        }
    }
    if (i >= lit.size()) return false;
    *out = s;
    return true;
}

extern "C" RWKV_NATIVE_API rwkv_trie_tokenizer *rwkv_tokenizer_init(
    const char *vocab_path) {
    FilePtr f(std::fopen(vocab_path, "rb"));
    if (!f) { set_error("failed to open vocab file"); return nullptr; }
    auto tok = std::make_unique<rwkv_trie_tokenizer>();
    tok->nodes.emplace_back();  // root

    std::string line;
    char buf[8192];
    while (std::fgets(buf, sizeof(buf), f.get())) {
        line.assign(buf);
        while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
            line.pop_back();
        if (line.empty()) continue;
        size_t sp1 = line.find(' ');
        size_t sp2 = line.rfind(' ');
        if (sp1 == std::string::npos || sp2 == sp1) {
            set_error("malformed vocab line");
            return nullptr;
        }
        int32_t id = (int32_t)std::strtol(line.c_str(), nullptr, 10);
        std::string token;
        if (!parse_py_literal(line.substr(sp1 + 1, sp2 - sp1 - 1), &token)) {
            set_error("failed to parse vocab token literal");
            return nullptr;
        }
        long expect_len = std::strtol(line.c_str() + sp2 + 1, nullptr, 10);
        if ((long)token.size() != expect_len) {
            set_error("vocab token length mismatch");
            return nullptr;
        }
        if (id >= (int32_t)tok->id_to_token.size())
            tok->id_to_token.resize(id + 1);
        tok->id_to_token[id] = token;
        tok->add(token, id);
    }
    return tok.release();
}

extern "C" RWKV_NATIVE_API void rwkv_tokenizer_free(rwkv_trie_tokenizer *tok) {
    delete tok;
}

extern "C" RWKV_NATIVE_API int64_t rwkv_tokenizer_encode(
    rwkv_trie_tokenizer *tok, const uint8_t *text, int64_t text_len,
    int32_t *out_tokens, int64_t max_tokens) {
    int64_t n_out = 0;
    int64_t pos = 0;
    while (pos < text_len) {
        int32_t cur = 0;
        int32_t best_token = -1;
        int64_t best_len = 0;
        int64_t i = pos;
        while (i < text_len) {
            cur = tok->nodes[cur].children[text[i]];
            if (cur < 0) break;
            i++;
            if (tok->nodes[cur].token >= 0) {
                best_token = tok->nodes[cur].token;
                best_len = i - pos;
            }
        }
        if (best_token < 0) { set_error("untokenizable byte"); return -1; }
        if (n_out >= max_tokens) { set_error("output buffer too small"); return -1; }
        out_tokens[n_out++] = best_token;
        pos += best_len;
    }
    return n_out;
}

extern "C" RWKV_NATIVE_API int64_t rwkv_tokenizer_decode(
    rwkv_trie_tokenizer *tok, const int32_t *tokens, int64_t n_tokens,
    uint8_t *out, int64_t max_out) {
    int64_t n = 0;
    for (int64_t i = 0; i < n_tokens; i++) {
        int32_t id = tokens[i];
        if (id < 0 || id >= (int32_t)tok->id_to_token.size()) {
            set_error("token id out of range");
            return -1;
        }
        const std::string &s = tok->id_to_token[id];
        if (n + (int64_t)s.size() > max_out) {
            set_error("output buffer too small");
            return -1;
        }
        std::memcpy(out + n, s.data(), s.size());
        n += (int64_t)s.size();
    }
    return n;
}
