"""Float32 compute ops with the JAX package's semantics.

Ports ``layer_norm``, ``group_norm``, ``l2_normalize`` and the serving side
of ``mm`` from ``rwkv_tpu.ops.parity``. The ggml-parity quantized engine
(``Weight`` / ``_quant_matmul``) is not part of this port yet.
"""

from __future__ import annotations

import torch


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """y[..., o] = sum_i x[..., i] * W[o, i].

    `w` is a dense ``[out, in]`` tensor or a w8a8
    ``rwkv_tpu_torch.ops.kernels.PackedQuantWeight``. Dense f32 weights run
    an f32 matmul; bf16 weights see bf16-rounded activations with float32
    accumulation (the JAX package's ``preferred_element_type=f32``). Leading
    dims are flattened into one ``[M, in]`` product."""
    if not isinstance(w, torch.Tensor):
        from rwkv_tpu_torch.ops.kernels import quant_matmul

        return quant_matmul(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.dtype == torch.bfloat16:
        y = torch.matmul(x2.to(torch.bfloat16).float(), w.float().T)
    else:
        y = torch.matmul(x2, w.T)
    return y.reshape(*lead, w.shape[0])


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
