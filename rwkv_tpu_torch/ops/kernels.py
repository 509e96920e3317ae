"""w8a8 serving weights and the quantized matmul (kernel K1).

Ports the rowwise ``int8_act`` (w8a8) form of ``rwkv_tpu.ops.kernels``:
``PackedQuantWeight``, ``quantize_q8_serving`` (its rowwise ``int8_act``
form) and ``quant_matmul``. The port stores codes ``[N, K]`` (output rows, K
contiguous) with one f32 scale per row and no padding of N; the JAX package
stores the transpose ``[K, N_pad]``. The per-32-block, packed-nibble and
bf16-convert branches of the TPU kernel are not ported yet.

``quant_matmul`` computes ``y = (float(x8 @ q^T) * dx) * d`` with x
quantized per row (``dx = amax/127``, ``rint``, clip +-127), as
``_xla_w8a8_matmul`` does. On a CUDA tensor it launches the hand-written
kernel ``csrc/quant_matmul.cu`` (and counts the launch in
``quant_matmul.launches``); on a CPU tensor it runs
``quant_matmul_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rwkv_tpu_torch.ops import _cuda

QK = 32


@dataclass
class PackedQuantWeight:
    """Rowwise int8 weight for w8a8: ``W[n, k] ~= q[n, k] * d[n]``."""

    q: torch.Tensor  # int8 [N, K]
    d: torch.Tensor  # f32 [N]

    @property
    def shape(self):
        """Logical (out, in) shape."""
        return tuple(self.q.shape)

    def to(self, device) -> "PackedQuantWeight":
        return PackedQuantWeight(q=self.q.to(device), d=self.d.to(device))


def quantize_rows_np(w: np.ndarray, qmax: float = 127.0):
    """Symmetric per-row quantization of ``[..., N, K]`` float32 on the host:
    (codes int8 ``[..., N, K]``, scales f32 ``[..., N]``), with the JAX
    package's formula ``d = amax/qmax``, ``inv = 1/max(d, 1e-30)`` (0 when
    d is 0), ``clip(rint(w * inv), +-qmax)``."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.abs(w).max(axis=-1)
    d = amax / qmax
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    q = np.clip(np.rint(w * inv[..., None]), -qmax, qmax).astype(np.int8)
    return q, d.astype(np.float32)


def quantize_q8_serving(arr) -> PackedQuantWeight:
    """Symmetric int8 quantization of a dense ``[out, in]`` weight, one
    scale per output row: the JAX package's
    ``quantize_q8_serving(rowwise=True, int8_act=True)`` (w8a8)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] % QK:
        raise ValueError(f"expected [out, in] with in % {QK} == 0, got {arr.shape}")
    q, d = quantize_rows_np(arr)
    return PackedQuantWeight(q=torch.from_numpy(q), d=torch.from_numpy(d))


def quantize_act_plain(x: torch.Tensor):
    """Per-row activation codes of x [M, K]: (codes as f32 [M, K], dx [M, 1])."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    dx = amax / torch.full_like(amax, 127.0)
    inv = torch.where(dx > 0, 1.0 / torch.clamp(dx, min=1e-30), torch.zeros_like(dx))
    x8 = torch.clamp(torch.round(x * inv), -127.0, 127.0)
    return x8, dx


def int_dot_plain(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact integer ``x8 @ q^T`` as float32 (rounded once, like the s32 ->
    f32 convert). float64 holds every partial sum exactly at these sizes
    (127^2 * K < 2^53), so the order of summation does not matter."""
    return torch.matmul(x8.double(), q.double().T).float()


def quant_matmul_plain(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    """Plain PyTorch K1 on x [M, K] f32 (any device)."""
    x8, dx = quantize_act_plain(x)
    return int_dot_plain(x8, w.q) * dx * w.d


def _w8a8_matmul_cuda(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    m, k = x.shape
    n = w.q.shape[0]
    if w.q.dtype != torch.int8 or w.d.dtype != torch.float32:
        raise TypeError("w8a8 weight must be int8 codes with f32 row scales")
    if w.q.shape[1] != k or w.d.shape != (n,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {tuple(w.q.shape)}, d {tuple(w.d.shape)}")
    if k % 16:
        raise ValueError(f"the w8a8 kernel needs K % 16 == 0, got K={k}")
    for t in (x, w.q, w.d):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("w8a8 kernel operands must be contiguous, 16-byte aligned, on one device")
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    dx = torch.empty((m,), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("quant_matmul", "rwkv_w8a8_matmul", 6, 3)
    code = fn(x.data_ptr(), x8.data_ptr(), dx.data_ptr(), w.q.data_ptr(),
              w.d.data_ptr(), y.data_ptr(), m, k, n, _cuda.stream_ptr(x.device))
    _cuda.check("quant_matmul", "rwkv_w8a8_matmul", code)
    quant_matmul.launches += 1
    return y


def quant_matmul(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    """y[..., o] = sum_i x[..., i] * W[o, i] under w8a8 (see module doc).
    CUDA tensors launch kernel K1; CPU tensors take the plain version."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).float().contiguous()
    if x2.device.type == "cpu":
        out = quant_matmul_plain(x2, w)
    elif x2.device.type == "cuda":
        out = _w8a8_matmul_cuda(x2, w)
    else:
        raise ValueError(f"unsupported device {x2.device}")
    return out.reshape(*lead, w.q.shape[0])


quant_matmul.launches = 0
