"""Packed serving weights and the quantized matmuls (kernels K1 and K9).

Ports ``rwkv_tpu.ops.kernels``: ``PackedQuantWeight`` in every form the
JAX package has, ``PackedQuantWeight.from_weight``, ``quantize_q8_serving``,
``dequant_weight`` and ``quant_matmul``. The port keeps its own layout:
codes ``[N, K]`` (output rows, K contiguous) with per-32-block scales
``[N, K/32]`` or one scale per row ``[N]``, and no padding of N; the JAX
package stores the transposes ``[K, N_pad]`` and ``[K/32, N_pad]``. The
forms, by the TPU kernel body each replaces
(``rwkv_tpu/ops/kernels.py::_pallas_quant_matmul``):

- ``w8a8`` (``rowwise`` + ``int8_act``; ``_kernel_w8a8``): x quantized per
  row, ``y = (float(x8 @ q^T) * dx) * d``. Kernel K1, ``csrc/quant_matmul.cu``.
- ``plain`` (``_kernel_plain``): ``W = f32(q * d)`` per 32-block; Q5_0 and
  Q8_0 files, ``q8``.
- ``min`` (``_kernel_min``): ``W = f32(f32(q * d) + m)``; Q5_1, Q4_K, Q5_K
  files (the K-formats' sub-block mins ride this form, stored negated).
- ``pack4`` / ``pack4_min`` (``_make_kernel4``): the same on nibbles, two
  codes a byte in ggml's own order (byte j of a 32-block's 16 bytes holds
  code j low and code j + 16 high, ``pack_int4``),
  signed for Q4_0 (codes -8..7), unsigned 0..15 with mins for Q4_1.
- ``rowwise`` (``_kernel_rowwise``; ``q8r``): x rounded to bf16, the codes
  exact in bf16, f32 accumulation, then ``* d[n]``.

Every form but w8a8 runs kernel K9, ``csrc/block_matmul.cu``; with these
weights ``y = x @ W^T`` with f32 accumulation. ``quant_matmul`` on a CUDA
tensor launches K1 or K9 (counted in ``quant_matmul.launches`` for K1 and
``quant_matmul.launches_by_form`` for K9's forms) and on a CPU tensor runs
the plain PyTorch versions ``quant_matmul_plain`` / ``block_matmul_plain``.
``matmul_plan`` picks each launch's route: a GEMV for M <= 8, else a
tensor-core GEMM with its tile and K split.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rwkv_tpu_torch.ops import _cuda

QK = 32

# K9's forms, in the order of the C entry's `form` argument
K9_FORMS = ("plain", "min", "pack4", "pack4_min", "rowwise")


@dataclass
class PackedQuantWeight:
    """A serving weight ``W[n, k]`` (``..., N, K``; leading dims stack
    layers). The defaults are the w8a8 form (rowwise int8 codes, one f32
    scale per row, int8 activations); see the module doc for the others."""

    q: torch.Tensor  # int8 [..., N, K]; [..., N, K/2] nibbles when pack4
    d: torch.Tensor  # f32 [..., N] when rowwise, else [..., N, K/32]
    m: Optional[torch.Tensor] = None  # f32 [..., N, K/32] (per-block forms)
    pack4: bool = False
    signed4: bool = True  # pack4: nibbles two's complement (Q4_0), else 0..15
    rowwise: bool = True
    int8_act: bool = True  # requires rowwise (w8a8)

    @property
    def form(self) -> str:
        if self.rowwise:
            return "w8a8" if self.int8_act else "rowwise"
        if self.pack4:
            return "pack4_min" if self.m is not None else "pack4"
        return "min" if self.m is not None else "plain"

    @property
    def shape(self):
        """Logical (out, in) shape."""
        return (self.q.shape[-2], self.q.shape[-1] * (2 if self.pack4 else 1))

    def map(self, fn) -> "PackedQuantWeight":
        """The same form with `fn` applied to q, d and m."""
        return dataclasses.replace(self, q=fn(self.q), d=fn(self.d),
                                   m=None if self.m is None else fn(self.m))

    def to(self, device) -> "PackedQuantWeight":
        return self.map(lambda t: t.to(device))

    @staticmethod
    def stack(ws) -> "PackedQuantWeight":
        """Stack equal-form weights along a new leading dim."""
        w0 = ws[0]
        return dataclasses.replace(
            w0, q=torch.stack([w.q for w in ws]), d=torch.stack([w.d for w in ws]),
            m=None if w0.m is None else torch.stack([w.m for w in ws]))

    @classmethod
    def from_weight(cls, w) -> "PackedQuantWeight":
        """A file-quantized ``ops.parity.Weight`` keeping its blocks: codes
        ``[N, K]`` and scales (and mins) ``[N, K/32]``; Q4_0 / Q4_1 as
        nibbles (see the module doc)."""
        if w.kind != "quant":
            raise ValueError("from_weight takes a quant Weight")
        out, nb, _ = w.q.shape
        q = w.q.reshape(out, nb * QK)
        m = None if w.m is None else w.m.float().contiguous()
        d = w.d.float().contiguous()
        if w.fmt in ("Q4_0", "Q4_1"):
            return cls(q=pack_int4(q), d=d, m=m, pack4=True, signed4=w.fmt == "Q4_0",
                       rowwise=False, int8_act=False)
        return cls(q=q.contiguous(), d=d, m=m, rowwise=False, int8_act=False)


def pack_int4(codes) -> torch.Tensor:
    """4-bit codes ``[..., K]`` (int8 values in -8..7 or 0..15, K a multiple
    of 32) -> bytes ``[..., K/2]``: byte j of 16-byte chunk c holds code
    32c + j in its low nibble and code 32c + 16 + j in its high nibble (the
    ggml block's own order; two's complement for signed codes). K9's pack4
    forms and the decode kernels' int4 matrices (``csrc/common.cuh``) read
    this layout."""
    a = np.asarray(codes.numpy() if isinstance(codes, torch.Tensor) else codes, np.int8)
    *lead, k = a.shape
    if k % QK:
        raise ValueError(f"int4 rows need K % {QK} == 0, got K={k}")
    a = a.astype(np.int32).reshape(*lead, k // QK, 2, 16)
    b = (a[..., 0, :] & 0xF) | ((a[..., 1, :] & 0xF) << 4)
    return torch.from_numpy(b.astype(np.uint8).view(np.int8).reshape(*lead, k // 2).copy())


def unpack_int4(packed: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Inverse of ``pack_int4`` (any device): bytes ``[..., K/2]`` -> int8
    codes ``[..., K]``, sign-extended (-8..7) or unsigned (0..15)."""
    v = packed.to(torch.int32)
    if signed:
        lo = ((v & 15) ^ 8) - 8
        hi = v >> 4  # arithmetic shift of the sign-extended byte
    else:
        lo, hi = v & 15, (v >> 4) & 15
    *lead, kh = packed.shape
    lo = lo.reshape(*lead, kh // 16, 16)
    hi = hi.reshape(*lead, kh // 16, 16)
    return torch.cat([lo, hi], dim=-1).reshape(*lead, 2 * kh).to(torch.int8)


def codes(w: PackedQuantWeight) -> torch.Tensor:
    """int8 codes ``[..., N, K]`` (nibbles unpacked)."""
    return unpack_int4(w.q, w.signed4) if w.pack4 else w.q


def dequant_weight(w: PackedQuantWeight) -> torch.Tensor:
    """Dense ``[..., N, K]`` float32: ``f32(q * d)`` per block (``+ m``,
    rounded again) or ``q * d[n]`` rowwise, as the JAX package's
    ``dequant_weight`` computes it (transposed)."""
    q = codes(w).float()
    if w.rowwise:
        return q * w.d[..., None]
    *lead, n, k = q.shape
    arr = q.reshape(*lead, n, k // QK, QK) * w.d[..., None]
    if w.m is not None:
        arr = arr + w.m[..., None]
    return arr.reshape(*lead, n, k)


def quantize_rows_np(w: np.ndarray, qmax: float = 127.0):
    """Symmetric quantization of ``[..., K]`` float32 along the last axis on
    the host: (codes int8 ``[..., K]``, scales f32 ``[...]``), with the JAX
    package's formula ``d = amax/qmax``, ``inv = 1/max(d, 1e-30)`` (0 when
    d is 0), ``clip(rint(w * inv), +-qmax)``. Computed with torch's CPU
    ops (every thread; the same f32 roundings as numpy's, half to even) in
    place of numpy's single-threaded ones: building a model at the 1.5B
    widths is mostly this function."""
    t = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
    d = t.abs().amax(dim=-1) / qmax
    inv = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30), 0.0)
    q = t.mul(inv[..., None]).round_().clamp_(-qmax, qmax).to(torch.int8)
    return q.numpy(), d.numpy()


def quantize_q8_serving(arr, rowwise: bool = True, int8_act: bool = True) -> PackedQuantWeight:
    """Symmetric int8 quantization of a dense ``[out, in]`` weight: the JAX
    package's ``quantize_q8_serving``. rowwise=False: per-32-block scales
    (``q8``); rowwise=True: one scale per output row (``q8r``), with
    int8_act=True the w8a8 form (the default here, the port's first form)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] % QK:
        raise ValueError(f"expected [out, in] with in % {QK} == 0, got {arr.shape}")
    if int8_act and not rowwise:
        raise ValueError("int8_act needs rowwise")
    out, k = arr.shape
    if rowwise:
        q, d = quantize_rows_np(arr)
    else:
        q, d = quantize_rows_np(arr.reshape(out, k // QK, QK))
        q = q.reshape(out, k)
    return PackedQuantWeight(q=torch.from_numpy(q), d=torch.from_numpy(d), rowwise=rowwise,
                             int8_act=int8_act)


# -- K1: w8a8 -----------------------------------------------------------------


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


# -- the kernels' launch plan ----------------------------------------------------

SMS = 132  # streaming multiprocessors of an H100 SXM: the blocks a grid should reach
GEMV_MAX_M = 8  # M up to which both kernels take their GEMV route
GEMM_TILES = ((64, 64), (32, 32), (32, 16))  # (BM, BN), the GEMM route's tiles, largest first
GEMM_MIN_BLOCKS = 4 * SMS // 3  # a grid of one block an SM leaves a tail: aim past it
# K1 (int8 x8, cheap to read again) keeps K whole up to this many stages
# and takes the smaller tile that fills the card; K9 (f32 x, read again by
# every column tile) takes the largest tile and splits K (measured on the
# H100: PERF.md, Findings; scripts/probe_torch_matmul.py)
GEMM_UNSPLIT_STEPS = {"w8a8": 8, "block": 0}
MAX_SPLIT = 8  # K ranges of a tile: the blocks of one cluster (the portable cluster size)
# K a GEMM stage: K1's bytes, K9's columns (kBK of csrc/quant_matmul.cu and
# csrc/block_matmul.cu; the C entries refuse a split past their stages)
GEMM_BK = {"w8a8": 128, "block": 64}
# The GEMV route, by kernel: warps a block, the most 16-code chunks a
# lane should take (fewer lanes a row keep more loads in flight a lane), the
# fewest lanes a row, and the blocks the grid should reach before lanes
# are added (measured on the H100: scripts/probe_torch_matmul.py)
GEMV_WARPS = {"w8a8": 8, "block": 4}
GEMV_CHUNKS = {"w8a8": 8, "block": 16}
GEMV_MIN_LANES = {"w8a8": 1, "block": 4}
GEMV_MIN_BLOCKS = {"w8a8": SMS, "block": 2 * SMS}
K1_GEMV_MAX_BLOCKS = 4 * SMS  # K1's GEMV grid loops over the rows past it
K1_GEMV_MAX_SMEM = 232448  # bytes of shared memory a block may use: K1's GEMV stages M x K codes
# ... on top of its static shared memory (csrc/quant_matmul.cu: red[8 * 32]
# and dxs[8] floats; rwkv_w8a8_gemv_static_smem reads the kernel's own)
K1_GEMV_STATIC_SMEM = 4 * (8 * 32 + 8)


@dataclass(frozen=True)
class MatmulPlan:
    """How one K1 / K9 launch runs: route ``gemv`` (``lanes`` lanes an
    output row) or ``gemm`` (a ``bm`` x ``bn`` tile a block, K cut into
    ``split`` ranges of whole GEMM_BK steps, the blocks of a tile one
    cluster); ``blocks`` the grid's blocks, ``scratch`` the bytes the
    wrapper allocates (K1's GEMM route: the activation codes and row
    scales)."""

    route: str
    bm: int = 0
    bn: int = 0
    split: int = 1
    lanes: int = 0
    blocks: int = 0
    scratch: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_plan(form: str, m: int, k: int, n: int) -> MatmulPlan:
    """The launch plan of ``quant_matmul`` on x [m, k] against a weight of
    `form` (``w8a8``: K1; one of ``K9_FORMS``: K9) with n output rows.

    M <= 8 (K1: while x's M x K codes fit in a block's shared memory
    beside the GEMV's static bytes):
    the GEMV. A row's chunks of 16 codes (16 int8 bytes, 8 nibble bytes)
    are shared by the fewest lanes (a power of two, at least
    GEMV_MIN_LANES) that hold at most GEMV_CHUNKS each, widened while the
    grid has fewer than GEMV_MIN_BLOCKS blocks.

    M > 8: the GEMM. K1, while K is at most GEMM_UNSPLIT_STEPS stages: the
    largest tile of GEMM_TILES whose grid reaches GEMM_MIN_BLOCKS with K
    whole. Otherwise (and always for K9) the largest tile that reaches it
    with the fewest K ranges; failing that, the smallest tile with the most.

    Raises ValueError on a shape the kernel cannot take (K1: K a multiple
    of 16; K9: of 32)."""
    if form != "w8a8" and form not in K9_FORMS:
        raise ValueError(f"unknown form {form!r}")
    align = 16 if form == "w8a8" else QK
    if m < 1 or n < 1 or k < align or k % align:
        raise ValueError(f"{form} takes M, N >= 1 and K a positive multiple of {align}, "
                         f"got M={m} K={k} N={n}")
    kind = "w8a8" if form == "w8a8" else "block"
    if m <= GEMV_MAX_M and (kind == "block" or m * k <= K1_GEMV_MAX_SMEM - K1_GEMV_STATIC_SMEM):
        chunks = k // 16
        lanes = GEMV_MIN_LANES[kind]
        while lanes < 32 and lanes * GEMV_CHUNKS[kind] < chunks:
            lanes *= 2

        def grid(lanes):
            blocks = _cdiv(n, GEMV_WARPS[kind] * (32 // lanes))
            return min(blocks, K1_GEMV_MAX_BLOCKS) if kind == "w8a8" else blocks

        while lanes < 32 and grid(lanes) < GEMV_MIN_BLOCKS[kind]:
            lanes *= 2
        return MatmulPlan("gemv", lanes=lanes, blocks=grid(lanes))
    steps = _cdiv(k, GEMM_BK[kind])
    scratch = m * k + 4 * m if kind == "w8a8" else 0

    def plan(bm, bn, split):
        blocks = _cdiv(m, bm) * _cdiv(n, bn) * split
        return MatmulPlan("gemm", bm, bn, split, blocks=blocks, scratch=scratch)

    if steps <= GEMM_UNSPLIT_STEPS[kind]:
        for bm, bn in GEMM_TILES:
            if plan(bm, bn, 1).blocks >= GEMM_MIN_BLOCKS:
                return plan(bm, bn, 1)
    for bm, bn in GEMM_TILES:
        for split in range(1, min(MAX_SPLIT, steps) + 1):
            if plan(bm, bn, split).blocks >= GEMM_MIN_BLOCKS:
                return plan(bm, bn, split)
    return plan(*GEMM_TILES[-1], min(MAX_SPLIT, steps))


def _operands_ok(*ts) -> bool:
    dev = ts[0].device
    return all(t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


def _w8a8_matmul_cuda(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    m, k = x.shape
    n = w.q.shape[0]
    if w.q.dtype != torch.int8 or w.d.dtype != torch.float32:
        raise TypeError("w8a8 weight must be int8 codes with f32 row scales")
    if w.q.shape[1] != k or w.d.shape != (n,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {tuple(w.q.shape)}, d {tuple(w.d.shape)}")
    if k % 16:
        raise ValueError(f"the w8a8 kernel needs K % 16 == 0, got K={k}")
    if not _operands_ok(x, w.q, w.d):
        raise ValueError("w8a8 kernel operands must be contiguous, 16-byte aligned, on one device")
    plan = matmul_plan("w8a8", m, k, n)
    x8 = dx = None
    if plan.route == "gemm":  # the activation codes and row scales, written by a first launch
        x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
        dx = torch.empty((m,), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("quant_matmul", "rwkv_w8a8_matmul", 6, 8)
    code = fn(x.data_ptr(), None if x8 is None else x8.data_ptr(),
              None if dx is None else dx.data_ptr(), w.q.data_ptr(), w.d.data_ptr(),
              y.data_ptr(), m, k, n, plan.bm, plan.bn, plan.split, plan.lanes, plan.blocks,
              _cuda.stream_ptr(x.device))
    _cuda.check("quant_matmul", "rwkv_w8a8_matmul", code)
    quant_matmul.launches += 1
    return y


# -- K9: the block formats, q8 and q8r ------------------------------------------


def block_matmul_plain(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    """Plain PyTorch K9 on x [M, K] f32 (any device): ``x @ W^T`` with
    ``W = dequant_weight(w)``; rowwise rounds x to bf16 first and applies
    the row scales to the output."""
    if w.rowwise:
        return torch.matmul(x.to(torch.bfloat16).float(), w.q.float().T) * w.d
    return torch.matmul(x, dequant_weight(w).T)


def _block_matmul_cuda(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    m, k = x.shape
    n = w.q.shape[0]
    form = w.form
    if form == "pack4" and not w.signed4 or form == "pack4_min" and w.signed4:
        raise ValueError("K9 takes signed nibbles without mins (Q4_0) or unsigned with mins (Q4_1)")
    if w.q.dtype != torch.int8 or w.d.dtype != torch.float32 or (
            w.m is not None and w.m.dtype != torch.float32):
        raise TypeError("K9 weights are int8 codes with f32 scales and mins")
    nb = k // QK
    d_shape = (n,) if w.rowwise else (n, nb)
    if k % QK or w.shape != (n, k) or tuple(w.d.shape) != d_shape or (
            w.m is not None and tuple(w.m.shape) != (n, nb)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, q {tuple(w.q.shape)}, "
                         f"d {tuple(w.d.shape)} ({form}); K must be a multiple of {QK}")
    ops = [x, w.q, w.d] + ([] if w.m is None else [w.m])
    if not _operands_ok(*ops):
        raise ValueError("K9 operands must be contiguous, 16-byte aligned, on one device")
    plan = matmul_plan(form, m, k, n)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _cuda.function("block_matmul", "rwkv_block_matmul", 5, 9)
    code = fn(x.data_ptr(), w.q.data_ptr(), w.d.data_ptr(),
              None if w.m is None else w.m.data_ptr(), y.data_ptr(), m, k, n,
              K9_FORMS.index(form), plan.bm, plan.bn, plan.split, plan.lanes, plan.blocks,
              _cuda.stream_ptr(x.device))
    _cuda.check("block_matmul", "rwkv_block_matmul", code)
    quant_matmul.launches_by_form[form] += 1
    return y


def quant_matmul(x: torch.Tensor, w: PackedQuantWeight) -> torch.Tensor:
    """y[..., o] = sum_i x[..., i] * W[o, i] in `w`'s form (see module
    doc). CUDA tensors launch K1 (w8a8) or K9; CPU tensors take the plain
    versions."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).float().contiguous()
    w8a8 = w.form == "w8a8"
    if x2.device.type == "cpu":
        out = quant_matmul_plain(x2, w) if w8a8 else block_matmul_plain(x2, w)
    elif x2.device.type == "cuda":
        out = _w8a8_matmul_cuda(x2, w) if w8a8 else _block_matmul_cuda(x2, w)
    else:
        raise ValueError(f"unsupported device {x2.device}")
    return out.reshape(*lead, w.q.shape[-2])


quant_matmul.launches = 0
quant_matmul.launches_by_form = dict.fromkeys(K9_FORMS, 0)
