"""Block quantization codecs: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K (+ Q8_1
for activations).

A copy of ``rwkv_tpu.io.quant`` (the port keeps its own copies of the JAX
package's modules, even of those that are numpy only): the same encoders and
decoders, byte for byte (``tests/test_torch_io.py`` compares them). They are
bit-compatible with ggml's reference quantizers (the formats rwkv.cpp consumes
via `ggml_quantize_chunk`; rwkv.cpp's rwkv_quantize.inc:149 and
rwkv_file_format.inc:28-47 hold the type tables).

All codecs are pure numpy and fully vectorized. Blocks are 32 elements;
scales are stored as IEEE fp16 (numpy's float16 cast rounds to nearest-even,
matching ggml's FP32->FP16 conversion).

Layout of one block (little-endian):
  Q4_0:  d:f16, qs:16B   (elem j low nibble of qs[j], elem j+16 high nibble;
                          value = (q - 8) * d)
  Q4_1:  d:f16, m:f16, qs:16B                 (value = q * d + m)
  Q5_0:  d:f16, qh:u32, qs:16B  (5th bit of elem j at qh bit j, of elem j+16
                          at qh bit j+16; value = (q - 16) * d)
  Q5_1:  d:f16, m:f16, qh:u32, qs:16B         (value = q * d + m)
  Q8_0:  d:f16, qs:32 x i8                    (value = q * d)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

QK = 32  # block size (elements)


class GgmlDType(enum.IntEnum):
    """On-disk dtype ids used by the `ggmf` format (rwkv_type enum order,
    rwkv.cpp's rwkv_file_format.inc:5-24)."""

    FP32 = 0
    FP16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q4_1_O = 4  # unsupported legacy
    Q4_2 = 5  # unsupported legacy
    Q4_3 = 6  # unsupported legacy
    Q5_0 = 7
    Q5_1 = 8
    Q8_0 = 9
    Q8_1 = 10
    Q2_K = 11
    Q3_K = 12
    Q4_K = 13
    Q5_K = 14
    Q6_K = 15
    Q8_K = 16


QK_K = 256  # K-quant superblock size (elements)
K_SCALE_SIZE = 12  # bytes of packed 6-bit scales/mins per superblock


@dataclass(frozen=True)
class _BlockSpec:
    block_bytes: int  # bytes per `block_elems`-element block
    quantized: bool
    block_elems: int = QK


_SPECS = {
    GgmlDType.FP32: _BlockSpec(4 * QK, False),
    GgmlDType.FP16: _BlockSpec(2 * QK, False),
    GgmlDType.Q4_0: _BlockSpec(2 + 16, True),
    GgmlDType.Q4_1: _BlockSpec(2 + 2 + 16, True),
    GgmlDType.Q5_0: _BlockSpec(2 + 4 + 16, True),
    GgmlDType.Q5_1: _BlockSpec(2 + 2 + 4 + 16, True),
    GgmlDType.Q8_0: _BlockSpec(2 + 32, True),
    GgmlDType.Q8_1: _BlockSpec(2 + 2 + 32, True),
    # K-quant superblocks: 256 elements; fp16 d/dmin + 12B of 6-bit
    # sub-block scales/mins (+ 32B high bits for Q5_K) + packed nibbles.
    GgmlDType.Q4_K: _BlockSpec(2 + 2 + K_SCALE_SIZE + QK_K // 2, True, QK_K),
    GgmlDType.Q5_K: _BlockSpec(
        2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2, True, QK_K
    ),
}

QUANT_FORMATS = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K")

# 256-element superblock formats: rows must be a multiple of QK_K (the
# same ggml_quantize_chunk contract the reference inherits — its
# quantizer passes n_per_row = size0, rwkv_quantize.inc:149).
K_QUANT_FORMATS = ("Q4_K", "Q5_K")

# Names that resolve to a dtype id but have no codec here. Requesting one
# must fail with a clear "unsupported" error, mirroring the reference's
# GGML_TYPE_UNKNOWN mapping path (rwkv_file_format.inc:5-24) rather than
# a KeyError.
UNSUPPORTED_FORMATS = (
    "Q4_1_O", "Q4_2", "Q4_3", "Q2_K", "Q3_K", "Q6_K", "Q8_K",
)

_NAME_TO_DTYPE = {
    "FP32": GgmlDType.FP32,
    "FP16": GgmlDType.FP16,
    "float32": GgmlDType.FP32,
    "float16": GgmlDType.FP16,
    "Q4_0": GgmlDType.Q4_0,
    "Q4_1": GgmlDType.Q4_1,
    "Q5_0": GgmlDType.Q5_0,
    "Q5_1": GgmlDType.Q5_1,
    "Q8_0": GgmlDType.Q8_0,
    "Q4_K": GgmlDType.Q4_K,
    "Q5_K": GgmlDType.Q5_K,
}
_NAME_TO_DTYPE.update({name: GgmlDType[name] for name in UNSUPPORTED_FORMATS})


def dtype_from_name(name: str) -> GgmlDType:
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"Unknown dtype name {name!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype: GgmlDType) -> str:
    return {v: k for k, v in _NAME_TO_DTYPE.items() if not k.startswith("float")}[
        GgmlDType(dtype)
    ]


def is_quantized(dtype: GgmlDType) -> bool:
    return _SPECS[GgmlDType(dtype)].quantized


def tensor_nbytes(dtype: GgmlDType, *sizes: int) -> int:
    """Byte size of a tensor, including quant block math
    (mirrors rwkv.cpp's rwkv_tensor_nbytes, rwkv_utilities.inc:1-9)."""
    n = 1
    for s in sizes:
        n *= int(s)
    spec = _SPECS[GgmlDType(dtype)]
    be = spec.block_elems
    if spec.quantized:
        assert n % be == 0, f"quantized tensor size {n} not a multiple of {be}"
        return (n // be) * spec.block_bytes
    return n * spec.block_bytes // be


def _f16(x: np.ndarray) -> np.ndarray:
    """Round f32 -> IEEE fp16 (RTNE), as ggml's FP32_TO_FP16 does."""
    return x.astype(np.float16)


def _trunc_i(x: np.ndarray) -> np.ndarray:
    """C integer cast: truncate toward zero."""
    return np.trunc(x).astype(np.int32)


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int32)


def _blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert x.size % QK == 0, f"size {x.size} not a multiple of {QK}"
    return x.reshape(-1, QK)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per block: the signed value with the largest magnitude, first occurrence
    winning on strict '>' comparison of magnitudes (matches the ggml scalar loop)."""
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _pack_nibbles(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return (lo.astype(np.uint8) | (hi.astype(np.uint8) << 4)).astype(np.uint8)


def _q5_qh(xi0: np.ndarray, xi1: np.ndarray) -> np.ndarray:
    """Pack the 5th bits: bit j of qh = hi bit of elem j, bit j+16 = of elem j+16."""
    nb = xi0.shape[0]
    qh = np.zeros(nb, dtype=np.uint32)
    shifts = np.arange(16, dtype=np.uint32)
    qh |= np.sum(((xi0 >> 4) & 1).astype(np.uint64) << shifts, axis=1, dtype=np.uint64).astype(np.uint32)
    qh |= np.sum(((xi1 >> 4) & 1).astype(np.uint64) << (shifts + 16), axis=1, dtype=np.uint64).astype(np.uint32)
    return qh


# ---------------------------------------------------------------------------
# Encoders (f32 -> packed bytes). Each returns a uint8 array.
# ---------------------------------------------------------------------------


def _encode_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    nb = xb.shape[0]
    smax = _signed_absmax(xb)
    d = smax / -8.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    xi = np.minimum(15, _trunc_i(xb * inv[:, None] + np.float32(8.5)))
    qs = _pack_nibbles(xi[:, :16], xi[:, 16:])
    out = np.zeros((nb, 18), dtype=np.uint8)
    out[:, 0:2] = _f16(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = qs
    return out.reshape(-1)


def _encode_q4_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / np.float32(15.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    xi = np.minimum(15, _trunc_i((xb - mn[:, None]) * inv[:, None] + np.float32(0.5)))
    qs = _pack_nibbles(xi[:, :16], xi[:, 16:])
    out = np.zeros((nb, 20), dtype=np.uint8)
    out[:, 0:2] = _f16(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = _f16(mn).view(np.uint8).reshape(nb, 2)
    out[:, 4:] = qs
    return out.reshape(-1)


def _encode_q5_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    nb = xb.shape[0]
    smax = _signed_absmax(xb)
    d = smax / -16.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    xi = np.minimum(31, _trunc_i(xb * inv[:, None] + np.float32(16.5)))
    xi0, xi1 = xi[:, :16], xi[:, 16:]
    qs = _pack_nibbles(xi0 & 0xF, xi1 & 0xF)
    qh = _q5_qh(xi0, xi1)
    out = np.zeros((nb, 22), dtype=np.uint8)
    out[:, 0:2] = _f16(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(nb, 4)
    out[:, 6:] = qs
    return out.reshape(-1)


def _encode_q5_1(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    nb = xb.shape[0]
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / np.float32(31.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    xi = np.minimum(31, _trunc_i((xb - mn[:, None]) * inv[:, None] + np.float32(0.5)))
    xi0, xi1 = xi[:, :16], xi[:, 16:]
    qs = _pack_nibbles(xi0 & 0xF, xi1 & 0xF)
    qh = _q5_qh(xi0, xi1)
    out = np.zeros((nb, 24), dtype=np.uint8)
    out[:, 0:2] = _f16(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = _f16(mn).view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(nb, 4)
    out[:, 8:] = qs
    return out.reshape(-1)


def _encode_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks(x)
    nb = xb.shape[0]
    amax = np.abs(xb).max(axis=1)
    d = amax / np.float32(127.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    q = _roundf(xb * inv[:, None]).astype(np.int8)
    out = np.zeros((nb, 34), dtype=np.uint8)
    out[:, 0:2] = _f16(d).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# K-quant superblock codecs (Q4_K / Q5_K)
#
# ggml's 256-element superblock family: fp16 super-scales d/dmin plus 8
# sub-blocks of 32 elements, each with a 6-bit scale and 6-bit min packed
# into 12 bytes, codes stored as nibbles (+ a 32-byte high-bit plane for
# Q5_K). Value of element e in sub-block j:  fp16(d)*sc[j]*q - fp16(dmin)*m[j]
# — i.e. every sub-block is affine in its integer code, which is what lets
# the loader decompose a superblock into the same per-32 (q, d, m) form the
# other formats use (ops/parity.py::Weight).
#
# The encoders reproduce ggml's reference quantizers
# (quantize_row_q4_K_ref / quantize_row_q5_K_ref and their weighted
# least-squares sub-block fit, make_qkx2_quants) with the same f32
# arithmetic and serial accumulation order, so the emitted bytes match
# ggml's for the same input. The reference repo maps Q4_K/Q5_K to real
# ggml types (rwkv_file_format.inc:41-42) and advertises them in its
# binding layer (rwkv_cpp_shared_library.py:11,14); the codecs live in the
# un-vendored ggml submodule.
# ---------------------------------------------------------------------------


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml's nearest_int: round-half-to-even (the 12582912.0f magic-number
    trick is RNE for |x| < 2^22). NaN/inf inputs (degenerate all-equal
    blocks divide by zero upstream, as in C) cast to arbitrary ints that
    the callers' clip+where paths discard."""
    with np.errstate(invalid="ignore"):
        return np.rint(x).astype(np.int32)


def _make_qkx2_quants(xb: np.ndarray, nmax: int, rmin: float, rdelta: float,
                      nstep: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ggml make_qkx2_quants over [B, 32] sub-blocks.

    Weighted least-squares fit of x ~= scale*L + min with L in [0, nmax],
    weights = av_x + |x| (av_x = rms of the sub-block), iterating nstep+1
    candidate inverse scales and keeping the best squared-error fit.
    Serial f32 accumulation order matches the C loops bit-for-bit. The
    work runs on the transposed [32, B] layout, so each of a sub-block's 32
    serial steps is one contiguous row (the same operations in the same
    order as on [B, 32] columns, so the same bits).

    Returns (L [B, 32] int32 codes, scale [B] f32, the_min [B] f32).
    """
    xt = np.ascontiguousarray(np.asarray(xb, dtype=np.float32).T)
    n, B = xt.shape
    assert n == 32
    # weights[l] = av_x + |x[l]|, av_x = sqrt(sum(x^2)/32)
    sum_x2 = np.zeros(B, np.float32)
    for l in range(n):
        sum_x2 += xt[l] * xt[l]
    av_x = np.sqrt(sum_x2 / np.float32(32.0), dtype=np.float32)
    w = av_x[None, :] + np.abs(xt)

    mn = xt.min(axis=0)
    mx = xt.max(axis=0)
    sum_w = np.zeros(B, np.float32)
    sum_x = np.zeros(B, np.float32)
    for l in range(n):
        sum_w += w[l]
        sum_x += w[l] * xt[l]
    mn = np.minimum(mn, np.float32(0.0))  # if (min > 0) min = 0
    degenerate = mx == mn

    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (np.float32(nmax) / (mx - mn)).astype(np.float32)
        scale = (np.float32(1.0) / iscale).astype(np.float32)
        L = np.clip(
            _nearest_int(iscale[None, :] * (xt - mn[None, :])), 0, nmax
        )
    best_mad = np.zeros(B, np.float32)
    for l in range(n):
        diff = scale * L[l].astype(np.float32) + mn - xt[l]
        best_mad += w[l] * (diff * diff)

    cur_min = mn.copy()  # mutated on acceptance, feeds later iscales (as C)
    for is_ in range(nstep + 1):
        with np.errstate(divide="ignore", invalid="ignore"):
            iscale = (
                (np.float32(rmin) + np.float32(rdelta) * np.float32(is_)
                 + np.float32(nmax)) / (mx - cur_min)
            ).astype(np.float32)
        with np.errstate(invalid="ignore"):
            Laux = np.clip(
                _nearest_int(iscale[None, :] * (xt - cur_min[None, :])),
                0, nmax,
            )
        laux = Laux.astype(np.float32)
        sum_l = np.zeros(B, np.float32)
        sum_l2 = np.zeros(B, np.float32)
        sum_xl = np.zeros(B, np.float32)
        for l in range(n):
            la = laux[l]
            sum_l += w[l] * la
            sum_l2 += w[l] * la * la
            sum_xl += w[l] * la * xt[l]
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = ((sum_w * sum_xl - sum_x * sum_l) / D).astype(np.float32)
            this_min = ((sum_l2 * sum_x - sum_l * sum_xl) / D).astype(np.float32)
            alt_scale = (sum_xl / sum_l2).astype(np.float32)
        pos = this_min > 0.0
        this_min = np.where(pos, np.float32(0.0), this_min)
        this_scale = np.where(pos, alt_scale, this_scale)
        mad = np.zeros(B, np.float32)
        for l in range(n):
            diff = this_scale * laux[l] + this_min - xt[l]
            mad += w[l] * (diff * diff)
        accept = (D > 0.0) & (mad < best_mad)
        L = np.where(accept[None, :], Laux, L)
        best_mad = np.where(accept, mad, best_mad)
        scale = np.where(accept, this_scale, scale)
        cur_min = np.where(accept, this_min, cur_min)

    L = np.where(degenerate[None, :], 0, L)
    scale = np.where(degenerate, np.float32(0.0), scale)
    return np.ascontiguousarray(L.T), scale, (-cur_min).astype(np.float32)


def _pack_k_scales(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Pack 8 six-bit (scale, min) pairs into 12 bytes per superblock
    (ggml block layout; inverse of _unpack_k_scales). ls/lm: [B, 8] uint8."""
    B = ls.shape[0]
    sc = np.zeros((B, K_SCALE_SIZE), np.uint8)
    for j in range(4):
        sc[:, j] = ls[:, j]
        sc[:, j + 4] = lm[:, j]
    for j in range(4, 8):
        sc[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
        sc[:, j - 4] |= (ls[:, j] >> 4) << 6
        sc[:, j] |= (lm[:, j] >> 4) << 6
    return sc


def _unpack_k_scales(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12 packed bytes -> (sc [B, 8], m [B, 8]) 6-bit values
    (ggml's get_scale_min_k4)."""
    sc = sc.astype(np.uint8)
    s = np.zeros((sc.shape[0], 8), np.uint8)
    m = np.zeros((sc.shape[0], 8), np.uint8)
    for j in range(4):
        s[:, j] = sc[:, j] & 63
        m[:, j] = sc[:, j + 4] & 63
    for j in range(4, 8):
        s[:, j] = (sc[:, j + 4] & 0xF) | ((sc[:, j - 4] >> 6) << 4)
        m[:, j] = (sc[:, j + 4] >> 4) | ((sc[:, j] >> 6) << 4)
    return s, m


def _encode_k_common(x: np.ndarray, nmax: int, rmin: float, rdelta: float,
                     nstep: int):
    """Shared Q4_K/Q5_K encode: sub-block LS fits, 6-bit scale/min
    quantization against fp16 super-scales, final code recompute.
    Returns (L [B, 8, 32] codes, d16 [B] f16, dmin16 [B] f16,
    scales [B, 12] packed)."""
    xf = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert xf.size % QK_K == 0, f"size {xf.size} not a multiple of {QK_K}"
    xs = xf.reshape(-1, 8, 32)
    B = xs.shape[0]
    L, scales, mins = _make_qkx2_quants(
        xs.reshape(-1, 32), nmax, rmin, rdelta, nstep
    )
    L = L.reshape(B, 8, 32)
    scales = scales.reshape(B, 8)
    mins = mins.reshape(B, 8)

    # C: max_scale/max_min start at 0 and only grow — negative can't win.
    max_scale = np.maximum(scales.max(axis=1), np.float32(0.0))
    max_min = np.maximum(mins.max(axis=1), np.float32(0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(
            max_scale > 0, np.float32(63.0) / max_scale, np.float32(0.0)
        ).astype(np.float32)
        inv_min = np.where(
            max_min > 0, np.float32(63.0) / max_min, np.float32(0.0)
        ).astype(np.float32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)).astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)).astype(np.uint8)
    packed_scales = _pack_k_scales(ls, lm)
    d16 = _f16(max_scale / np.float32(63.0))
    dmin16 = _f16(max_min / np.float32(63.0))

    # Recompute codes against the fp16-rounded super-scales (C ref: skips
    # sub-blocks whose effective scale d*sc is zero, keeping the LS codes).
    sc_u, m_u = _unpack_k_scales(packed_scales)
    d_eff = d16.astype(np.float32)[:, None] * sc_u.astype(np.float32)
    dm = dmin16.astype(np.float32)[:, None] * m_u.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = _nearest_int((xs + dm[:, :, None]) / d_eff[:, :, None])
    l_new = np.clip(l_new, 0, nmax)
    L = np.where((d_eff != 0.0)[:, :, None], l_new, L)
    return L, d16, dmin16, packed_scales


def _encode_q4_k(x: np.ndarray) -> np.ndarray:
    L, d16, dmin16, scales = _encode_k_common(x, 15, -1.0, 0.1, 20)
    B = L.shape[0]
    out = np.zeros((B, _SPECS[GgmlDType.Q4_K].block_bytes), np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(B, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(B, 2)
    out[:, 4:16] = scales
    # nibble layout: per 64-element group g, byte l = L[g, l] | L[g, l+32]<<4
    Lg = L.reshape(B, 4, 64)
    qs = (Lg[:, :, :32] | (Lg[:, :, 32:] << 4)).astype(np.uint8)
    out[:, 16:] = qs.reshape(B, 128)
    return out.reshape(-1)


def _encode_q5_k(x: np.ndarray) -> np.ndarray:
    L, d16, dmin16, scales = _encode_k_common(x, 31, -0.5, 0.1, 15)
    B = L.shape[0]
    out = np.zeros((B, _SPECS[GgmlDType.Q5_K].block_bytes), np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(B, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(B, 2)
    out[:, 4:16] = scales
    # per 64-element group g: low 4 bits as Q4_K nibbles; 5th bit of
    # elem l -> qh[l] bit 2g, of elem l+32 -> qh[l] bit 2g+1
    Lg = L.reshape(B, 4, 64)
    lo = Lg & 0xF
    qs = (lo[:, :, :32] | (lo[:, :, 32:] << 4)).astype(np.uint8)
    out[:, 48:] = qs.reshape(B, 128)
    qh = np.zeros((B, 32), np.uint8)
    for g in range(4):
        qh |= ((Lg[:, g, :32] >> 4) << (2 * g)).astype(np.uint8)
        qh |= ((Lg[:, g, 32:] >> 4) << (2 * g + 1)).astype(np.uint8)
    out[:, 16:48] = qh
    return out.reshape(-1)


def _unpack_k_blocks(b: np.ndarray, dtype: GgmlDType) -> dict[str, np.ndarray]:
    """K-quant superblocks -> per-32 affine sub-blocks.

    Returns q [nb*8, 32] int32 codes, d [nb*8] f32 per-sub-block scale,
    m [nb*8] f32 per-sub-block offset, with value = q*d + m (m is the
    NEGATED ggml min so the affine form matches the `_1` formats)."""
    nb = b.shape[0]
    d16 = b[:, 0:2].copy().view(np.float16).reshape(nb).astype(np.float32)
    dmin16 = b[:, 2:4].copy().view(np.float16).reshape(nb).astype(np.float32)
    sc_u, m_u = _unpack_k_scales(b[:, 4:16])
    d_sub = d16[:, None] * sc_u.astype(np.float32)
    m_sub = -(dmin16[:, None] * m_u.astype(np.float32))
    if dtype == GgmlDType.Q4_K:
        qs = b[:, 16:].reshape(nb, 4, 32)
        q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
    else:
        qh = b[:, 16:48].reshape(nb, 1, 32)
        qs = b[:, 48:].reshape(nb, 4, 32)
        lo = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
        g = np.arange(4)[None, :, None]
        hb0 = (qh >> (2 * g)) & 1
        hb1 = (qh >> (2 * g + 1)) & 1
        hi = np.stack([hb0, hb1], axis=2).reshape(nb, 8, 32)
        q = lo | (hi << 4)
    return {
        "q": q.reshape(nb * 8, 32).astype(np.int32),
        "d": d_sub.reshape(nb * 8),
        "m": m_sub.reshape(nb * 8),
    }


def quantize_q8_k_blocks(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Activation quantization for K-quant dot products (ggml's q8_K):
    per-256 blocks, signed-max scale (iscale = -127/max where max is the
    signed value of largest magnitude), f32 scale (NOT fp16-rounded).

    Returns (q: int32 [nb, 256], d: f32 [nb])."""
    xf = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    assert xf.size % QK_K == 0
    xb = xf.reshape(-1, QK_K)
    idx = np.argmax(np.abs(xb), axis=1)
    smax = xb[np.arange(xb.shape[0]), idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = np.where(
            smax != 0.0, np.float32(-127.0) / smax, np.float32(0.0)
        ).astype(np.float32)
        d = np.where(
            smax != 0.0, np.float32(1.0) / iscale, np.float32(0.0)
        ).astype(np.float32)
    q = np.clip(_nearest_int(iscale[:, None] * xb), -128, 127)
    return q, d


def quantize_q8_1_blocks(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Activation quantization for Q4_1/Q5_1 dot products (ggml's q8_1).

    Returns (q: int32 [nb, 32], d: f32 [nb] (fp16-rounded), s: f32 [nb]
    (fp16-rounded d * sum(q))).
    """
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=1)
    d = amax / np.float32(127.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    q = _roundf(xb * inv[:, None])
    s = d * q.sum(axis=1).astype(np.float32)
    return q, _f16(d).astype(np.float32), _f16(s).astype(np.float32)


def quantize_q8_0_blocks(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Activation quantization for Q4_0/Q5_0/Q8_0 dot products (ggml's q8_0).

    Returns (q: int32 [nb, 32], d: f32 [nb] (fp16-rounded)).
    """
    xb = _blocks(x)
    amax = np.abs(xb).max(axis=1)
    d = amax / np.float32(127.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, np.float32(1.0) / d, np.float32(0.0)).astype(np.float32)
    q = _roundf(xb * inv[:, None])
    return q, _f16(d).astype(np.float32)


# ---------------------------------------------------------------------------
# Decoders (packed bytes -> unpacked integer codes + scales, and to f32)
# ---------------------------------------------------------------------------


def unpack_blocks(data: np.ndarray, dtype: GgmlDType) -> dict[str, np.ndarray]:
    """Unpack raw block bytes into integer codes and f32 scales.

    Returns a dict with:
      q: int32 [nb, 32] — integer codes with the format's offset NOT applied
         (q4_0: 0..15, q5_0: 0..31, q8_0: -128..127)
      d: f32 [nb] — scale
      m: f32 [nb] — min/offset (q4_1/q5_1 only)

    K-quant superblocks decompose into 8 per-32 affine sub-blocks
    (value = q*d + m with m pre-negated), so nb counts SUB-blocks.
    """
    dtype = GgmlDType(dtype)
    spec = _SPECS[dtype]
    raw = np.frombuffer(np.ascontiguousarray(data), dtype=np.uint8)
    assert raw.size % spec.block_bytes == 0
    nb = raw.size // spec.block_bytes
    b = raw.reshape(nb, spec.block_bytes)

    if dtype in (GgmlDType.Q4_K, GgmlDType.Q5_K):
        return _unpack_k_blocks(b, dtype)

    def f16_at(off: int) -> np.ndarray:
        return (
            b[:, off : off + 2].copy().view(np.float16).reshape(nb).astype(np.float32)
        )

    def u32_at(off: int) -> np.ndarray:
        return b[:, off : off + 4].copy().view(np.uint32).reshape(nb)

    def nibbles(off: int) -> np.ndarray:
        qs = b[:, off : off + 16]
        return np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int32)

    if dtype == GgmlDType.Q4_0:
        return {"q": nibbles(2), "d": f16_at(0)}
    if dtype == GgmlDType.Q4_1:
        return {"q": nibbles(4), "d": f16_at(0), "m": f16_at(2)}
    if dtype == GgmlDType.Q5_0 or dtype == GgmlDType.Q5_1:
        off = 6 if dtype == GgmlDType.Q5_0 else 8
        qh_off = 2 if dtype == GgmlDType.Q5_0 else 4
        q = nibbles(off)
        qh = u32_at(qh_off)
        bits = ((qh[:, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int32)
        q = q | (bits << 4)
        out = {"q": q, "d": f16_at(0)}
        if dtype == GgmlDType.Q5_1:
            out["m"] = f16_at(2)
        return out
    if dtype == GgmlDType.Q8_0:
        q = b[:, 2:34].copy().view(np.int8).astype(np.int32)
        return {"q": q, "d": f16_at(0)}
    raise ValueError(f"not a packed quant dtype: {dtype}")


_OFFSETS = {GgmlDType.Q4_0: 8, GgmlDType.Q5_0: 16}


def quant_offset(dtype: GgmlDType) -> int:
    """The integer offset subtracted at dequant time (0 for _1/_8 formats)."""
    return _OFFSETS.get(GgmlDType(dtype), 0)


def dequantize_rows(data: np.ndarray, dtype: GgmlDType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode packed tensor bytes to f32 with the given logical shape."""
    dtype = GgmlDType(dtype)
    if dtype == GgmlDType.FP32:
        return np.frombuffer(np.ascontiguousarray(data), dtype=np.float32).reshape(shape).copy()
    if dtype == GgmlDType.FP16:
        return (
            np.frombuffer(np.ascontiguousarray(data), dtype=np.float16)
            .astype(np.float32)
            .reshape(shape)
        )
    blocks = unpack_blocks(data, dtype)
    q = blocks["q"].astype(np.float32) - np.float32(quant_offset(dtype))
    x = q * blocks["d"][:, None]
    if "m" in blocks:
        x = blocks["q"].astype(np.float32) * blocks["d"][:, None] + blocks["m"][:, None]
    return x.reshape(shape).astype(np.float32)


_ENCODERS = {
    GgmlDType.Q4_0: _encode_q4_0,
    GgmlDType.Q4_1: _encode_q4_1,
    GgmlDType.Q5_0: _encode_q5_0,
    GgmlDType.Q5_1: _encode_q5_1,
    GgmlDType.Q8_0: _encode_q8_0,
    GgmlDType.Q4_K: _encode_q4_k,
    GgmlDType.Q5_K: _encode_q5_k,
}


def quantize_rows(x: np.ndarray, dtype: GgmlDType) -> np.ndarray:
    """Encode an f32 array into packed quant bytes (bit-compatible with
    ggml_quantize_chunk for the supported formats)."""
    dtype = GgmlDType(dtype)
    if dtype == GgmlDType.FP32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if dtype == GgmlDType.FP16:
        return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).view(np.uint8).reshape(-1)
    if dtype not in _ENCODERS:
        raise ValueError(f"Unsupported quantization target {dtype}")
    return _ENCODERS[dtype](np.ascontiguousarray(x, dtype=np.float32))
