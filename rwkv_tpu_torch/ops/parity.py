"""Float32 compute ops with the JAX package's semantics.

Ports ``layer_norm``, ``group_norm``, ``l2_normalize``, ``mm`` (the serving
side and its dense ``Weight`` branch) and the ``Weight`` leaf (a linear
weight in its on-disk precision, what ``models.loader.load_params``
returns) from ``rwkv_tpu.ops.parity``. The ggml-parity quantized matmul
(``_quant_matmul``) is not ported yet: ``mm`` refuses a quantized
``Weight``, and ``Weight`` keeps the fields that matmul needs
(``q8_1_act``, ``q8_k_act``).
"""

from __future__ import annotations

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


def _matmul_f32(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x2 @ wt in float32 at full precision: on the card with TF32 off for
    the call (the JAX package's ``precision=HIGHEST``)."""
    if not x2.is_cuda:
        return torch.matmul(x2, wt)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _matmul(x2, wt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


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
    computes); a quantized ``Weight`` needs
    the ggml-parity matmul, not ported (ROADMAP queue A item 9). Leading
    dims are flattened into one ``[M, in]`` product."""
    if isinstance(w, Weight):
        if w.kind != "dense":
            raise NotImplementedError(
                f"mm on a {w.fmt} Weight needs the ggml-parity quantized matmul "
                f"(_quant_matmul), not ported yet (ROADMAP queue A item 9); serve the "
                f"file through ServingModel")
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
