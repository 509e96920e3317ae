"""Float32 compute ops with the JAX package's semantics.

Ports ``layer_norm``, ``group_norm``, ``l2_normalize``, ``mm``, the
``Weight`` leaf (a linear weight in its on-disk precision, what
``models.loader.load_params`` returns) and the ggml-parity quantized matmul
(``_quant_matmul``, with ``_roundf`` and ``_fp16_round``) from
``rwkv_tpu.ops.parity``.

The parity matmul is plain PyTorch on purpose: the JAX package computes it
in XLA, outside any Pallas kernel, because it is the validation path that
reproduces ggml's activation rounding bit for bit, not a fast path. Its
integer block dots are exact in float32 (each is at most 32 * 127 * 128 <
2^24), so any summation order gives the same bits as long as the products
are not rounded (TF32 off on the card).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rwkv_tpu_torch.io.quant import (
    GgmlDType, dtype_from_name, dtype_name, quant_offset, unpack_blocks,
)

# formats whose ggml dot consumes q8_1 activations (an explicit per-block
# min) and the K-quant formats, which consume q8_K activations
_Q8_1_ACT = (GgmlDType.Q4_1, GgmlDType.Q5_1)
_Q8_K_ACT = (GgmlDType.Q4_K, GgmlDType.Q5_K)


@dataclass
class Weight:
    """A linear-layer weight in one of the on-disk precisions (CPU tensors).

    kind == "dense": `w` holds the ``[out, in]`` matrix in float32 or
    float16. kind == "quant": `q` holds int8 codes ``[out, n_blocks, 32]``
    with the format's offset already subtracted (Q4_0 codes are -8..7), `d`
    the per-block scales ``[out, n_blocks]`` (float32 holding the fp16
    values exactly) and `m` the per-block minimums of Q4_1, Q5_1 and the
    K-formats (whose sub-block mins are stored negated, so every format
    dequantizes as ``q * d + m``)."""

    kind: str  # "dense" | "quant"
    w: Optional[torch.Tensor] = None
    q: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None
    m: Optional[torch.Tensor] = None
    q8_1_act: bool = False
    fmt: str = ""  # on-disk format name of a quant weight, e.g. "Q4_0"
    q8_k_act: bool = False

    @property
    def shape(self):
        """Logical (out, in) shape."""
        if self.kind == "dense":
            return tuple(self.w.shape)
        return (self.q.shape[0], self.q.shape[1] * 32)

    @classmethod
    def from_codes(cls, q, d, m, fmt: str) -> "Weight":
        """A quant weight from codes ``[out, nb, 32]`` (offset subtracted),
        scales and optional mins ``[out, nb]`` of the format named `fmt`."""
        dtype = dtype_from_name(fmt)
        return cls(kind="quant", q=torch.from_numpy(np.array(q, np.int8)),
                   d=torch.from_numpy(np.array(d, np.float32)),
                   m=None if m is None else torch.from_numpy(np.array(m, np.float32)),
                   q8_1_act=dtype in _Q8_1_ACT, fmt=fmt, q8_k_act=dtype in _Q8_K_ACT)

    @classmethod
    def from_packed(cls, data: bytes, dtype: GgmlDType, shape) -> "Weight":
        """Build from the raw ggmf bytes of a quantized 2-D tensor."""
        out_dim, in_dim = shape
        blocks = unpack_blocks(np.frombuffer(data, dtype=np.uint8), dtype)
        nb = in_dim // 32
        m = blocks.get("m")
        return cls.from_codes((blocks["q"] - quant_offset(dtype)).reshape(out_dim, nb, 32),
                              blocks["d"].reshape(out_dim, nb),
                              None if m is None else m.reshape(out_dim, nb), dtype_name(dtype))

    def to(self, device) -> "Weight":
        """This weight with its tensors on `device` (the fields moved once,
        so ``mm`` copies nothing a call)."""
        def move(t):
            return None if t is None else t.to(device)

        return Weight(kind=self.kind, w=move(self.w), q=move(self.q), d=move(self.d),
                      m=move(self.m), q8_1_act=self.q8_1_act, fmt=self.fmt,
                      q8_k_act=self.q8_k_act)

    def dense(self) -> torch.Tensor:
        """The ``[out, in]`` float32 matrix: a dense weight converted, a
        quant weight ``f32(q * d)`` (``+ m``), rounded after each step, as
        the JAX package's ``_densify`` / ``_np_dense`` compute it."""
        if self.kind == "dense":
            return self.w.float()
        arr = self.q.float() * self.d[..., None]
        if self.m is not None:
            arr = arr + self.m[..., None]
        return arr.reshape(self.q.shape[0], -1)


# On the card a dense product of fewer rows than this runs padded to this
# many: cuBLAS picks its kernel, and with it the order of each dot
# product's sum, by shape, so a row's bits would otherwise depend on how
# many rows share the call. Padded, a pass over a few positions (the
# speculative verification) gives each position the bits the one-token
# decode chain gives it.
ROW_INVARIANT_ROWS = 16


def _matmul(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x @ wt for x [..., M, K]; on the card M < ROW_INVARIANT_ROWS is
    zero-padded to ROW_INVARIANT_ROWS rows."""
    m = x.shape[-2]
    if not x.is_cuda or m >= ROW_INVARIANT_ROWS:
        return torch.matmul(x, wt)
    pad = x.new_zeros(*x.shape[:-2], ROW_INVARIANT_ROWS, x.shape[-1])
    pad[..., :m, :] = x
    return torch.matmul(pad, wt)[..., :m, :]


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the card's float32 products inside (the JAX package's
    ``precision=HIGHEST``); the setting is restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _matmul_f32(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x2 @ wt in float32 at full precision (on the card TF32 off, rows
    padded as ``_matmul`` pads them)."""
    if not x2.is_cuda:
        return torch.matmul(x2, wt)
    with _no_tf32():
        return _matmul(x2, wt)


def _roundf(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest, ties to even: ggml's SIMD activation quantizers
    round in the hardware's default mode, not with C's roundf."""
    return torch.round(x)


def _fp16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).float()


def _const(num: float, like: torch.Tensor) -> torch.Tensor:
    """`num` as a 0-dim tensor on `like`'s device, for quotients. PyTorch
    takes ``num / t`` with a Python number as ``num * reciprocal(t)`` (and,
    on the card, ``t / num`` as ``t * (1 / num)``), an ulp off for some t;
    ggml and XLA divide, and an ulp moves int8 activation codes. A quotient
    of two tensors is the correctly rounded one."""
    return torch.as_tensor(num, dtype=like.dtype, device=like.device)


# the most bytes _quant_matmul holds at once beyond its input and output:
# the float32 codes of a slab of outputs take at most half, and each of its
# two [rows, outputs, n_blocks] float32 temporaries (the block dots, their
# scales) at most a quarter
_QUANT_PIECE_BYTES = 1 << 26


def _block_dots(q_x: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The integer block dots p[m, o, b] = sum_i q_x[m, b, i] wq[b, i, o]
    for q_x [M, nb, 32] and wq [nb, 32, out] (both integer-valued float32),
    as a [M, out, nb] view. Exact in float32 in any order (|p| < 2^24), so
    the rows need no padding; on the card only TF32 is off."""
    with _no_tf32():
        return torch.matmul(q_x.transpose(0, 1), wq).permute(1, 2, 0)


def _quant_act(x: torch.Tensor, w: Weight):
    """Rows x [M, in] quantized as ggml's dot for `w`'s format takes them:
    the codes q_x [M, nb, 32] (integer-valued float32 in [-127, 127]), the
    scale of each 32-block [M, nb] and, for formats with a min, the sum the
    min is multiplied by [M, nb] (else None)."""
    m, in_dim = x.shape
    nb = in_dim // 32
    if w.q8_k_act:
        # q8_K activations: per-256 blocks, iscale = -127 / smax with smax
        # the SIGNED value of largest magnitude (the first one on ties),
        # scale d = 1 / iscale kept in float32 (not rounded through fp16)
        xk = x.reshape(m, in_dim // 256, 256)
        mag = xk.abs()
        amaxk = mag.amax(dim=-1)
        smax = torch.gather(xk, -1, mag.argmax(dim=-1, keepdim=True))[..., 0]
        zero = amaxk == 0.0
        iscale = torch.where(zero, torch.zeros_like(smax), _const(-127.0, smax) / smax)
        d_k = torch.where(zero, torch.zeros_like(smax), _const(1.0, iscale) / iscale)
        q_x = _roundf(xk * iscale[..., None]).reshape(m, nb, 32)
        d_x32 = torch.repeat_interleave(d_k, 8, dim=-1)  # per-32 view of the 256 scale
        return q_x, d_x32, d_x32 * q_x.sum(dim=-1)
    xb = x.reshape(m, nb, 32)
    amax = xb.abs().amax(dim=-1)
    d_x = amax / _const(127.0, amax)
    # the runtime quantizers take the inverse scale as 127 / amax, not 1 / d
    inv = torch.where(amax != 0.0, _const(127.0, amax) / amax, torch.zeros_like(amax))
    q_x = _roundf(xb * inv[..., None])
    s_x = _fp16_round(d_x * q_x.sum(dim=-1)) if w.q8_1_act else None
    return q_x, _fp16_round(d_x), s_x


def _quant_matmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """ggml-parity quantized matmul: y = x @ W.T with W block-quantized.

    Each 32-element block of an activation row is quantized to int8 codes
    (q8_0: scale amax / 127, inverse 127 / amax, ties to even), and
    ``y = sum_b p_b * (fp16(d_x) * d_w)`` over the integer block dots p_b.
    Q4_1 / Q5_1 take q8_1 activations and add ``sum_b m_w * s_x`` with
    ``s_x = fp16(d_x * sum(q_x))``; Q4_K / Q5_K take q8_K activations
    (per-256 blocks, see ``_quant_act``) and add ``sum_b m_w * d * sum(q_x)``.
    The weight's codes are converted to float32 a slab of outputs at a
    time and the rows taken in pieces, within _QUANT_PIECE_BYTES; rows and
    outputs are independent, so the pieces change no bits."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    out_dim, nb = w.q.shape[0], w.q.shape[1]
    q_x, d_x, s_x = _quant_act(x2, w)
    cols = min(out_dim, max(1, _QUANT_PIECE_BYTES // 2 // (nb * 32 * 4)))
    rows = max(1, _QUANT_PIECE_BYTES // 4 // (cols * nb * 4))
    y = x2.new_empty(x2.shape[0], out_dim)
    for o in range(0, out_dim, cols):
        wq = w.q[o : o + cols].float().permute(1, 2, 0)
        d_w = w.d[o : o + cols]
        for i in range(0, x2.shape[0], rows):
            # the scaled dots in a contiguous [rows, cols, nb] tensor, so
            # each output's sum over its blocks runs in one order whatever
            # the piece's shape
            p = _block_dots(q_x[i : i + rows], wq)
            yp = (d_x[i : i + rows, None, :] * d_w).mul_(p).sum(dim=-1)
            if s_x is not None:
                yp = yp + (w.m[o : o + cols] * s_x[i : i + rows, None, :]).sum(dim=-1)
            y[i : i + rows, o : o + cols] = yp
    return y.reshape(*lead, out_dim)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """y[..., o] = sum_i x[..., i] * W[o, i].

    `w` is a dense ``[out, in]`` tensor, a w8a8
    ``rwkv_tpu_torch.ops.kernels.PackedQuantWeight`` or a ``Weight`` of a
    loaded file. Dense f32 weights run an f32 matmul; bf16 weights see
    bf16-rounded activations with float32 accumulation (the JAX package's
    ``preferred_element_type=f32``); on the card both with a row's bits
    independent of the other rows (``ROW_INVARIANT_ROWS``). A dense
    ``Weight`` runs in f32 at full precision against the raw f32
    activations, an FP16 one converted to f32 (what ggml's FP16 matmul
    computes); a quantized ``Weight`` runs the ggml-parity matmul
    (``_quant_matmul``: activations quantized to q8_0, q8_1 or q8_K codes
    as ggml's dot product takes them). Leading dims are flattened into one
    ``[M, in]`` product."""
    if isinstance(w, Weight):
        if w.kind != "dense":
            return _quant_matmul(x, w)
        lead = x.shape[:-1]
        y = _matmul_f32(x.reshape(-1, x.shape[-1]).float(), w.w.to(x.device).float().T)
        return y.reshape(*lead, w.w.shape[0])
    if not isinstance(w, torch.Tensor):
        from rwkv_tpu_torch.ops.kernels import quant_matmul

        return quant_matmul(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.dtype == torch.bfloat16:
        y = _matmul(x2.to(torch.bfloat16).float(), w.float().T)
    else:
        y = _matmul(x2, w.T)
    return y.reshape(*lead, w.shape[0])


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[p, m, o] = sum_i x[p, m, i] * W[p, o, i]: P products in one call
    on a stack of dense ``[P, out, in]`` weights, with ``mm``'s numerics
    (bf16 weights see bf16-rounded activations, f32 accumulation and an
    f32 result)."""
    if w.dtype == torch.bfloat16:
        return _matmul(x.to(torch.bfloat16).float(), w.float().transpose(-1, -2))
    return _matmul(x, w.transpose(-1, -2))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """RWKV layer norm: population variance, eps inside the sqrt,
    elementwise scale and shift."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w + b


def group_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n_heads: int, eps: float):
    """Head-wise group norm: normalize each head's slice, then scale/shift
    over the full channel dim. x: [..., C]."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], n_heads, shape[-1] // n_heads)
    mu = xh.mean(dim=-1, keepdim=True)
    xc = xh - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xh = xc * torch.rsqrt(var + eps)
    return xh.reshape(shape) * w + b


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Row l2-normalize: x / max(sqrt(sum(x^2)), 1e-12)."""
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)
