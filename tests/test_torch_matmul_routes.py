"""The launch plan of kernels K1 and K9 (``rwkv_tpu_torch.ops.kernels.
matmul_plan``) and CPU emulations of K9's tensor-core arithmetic, held
against the JAX package.

(a) The plan, a pure function: the GEMV route for M <= 8, else a
    tensor-core GEMM whose tile and K split give at least 132 blocks (one
    an H100 SM) at every shape of the 169M and 1.5B-width main paths,
    whose K ranges are whole stages covering K, and which refuses what the
    kernels cannot take.
(b) The f32 forms (plain, min, pack4, pack4_min): x split into three bf16
    parts, each multiplied by the codes (exact in bf16) on the tensor
    cores with f32 sums per 32-column quant block, that sum scaled by the
    block's scale (plus its min times the block's sum of x) into an f32
    accumulator, the K ranges of the plan summed in rank order. Emulated
    here for every block format and q8 at the 169M shapes, and at one
    shape with weights scaled by 1e-3 and 1e3, against JAX's
    ``quant_matmul(..., force="xla")``: every output within K9_BAND = 1e-5
    of sum_k |x_k| |W_nk|, the band the card holds the kernel to.
(c) rowwise (q8r): bf16-rounded x times the codes, f32 sums, the row scale
    last; against JAX's Pallas ``_kernel_rowwise`` in interpret mode,
    within the same band.

The emulations take each quant block's (or each K range's) sum exactly in
float64 and round it to f32 once; the tensor cores' own f32 sums of at
most 32 products differ from that by a few f32 ulps of the block's sum,
far inside the band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.io import quant as JQ
from rwkv_tpu.ops import kernels as JK
from rwkv_tpu.ops.parity import Weight as JWeight
from rwkv_tpu_torch.io import quant as TQ
from rwkv_tpu_torch.ops import kernels as TK
from rwkv_tpu_torch.ops.parity import Weight

K9_BAND = 1e-5
SMS = 132

# (M, K, N) of the main paths' prefill buckets: v7 169M (r, k, v, out; the
# LoRA down and up; fk; fv) and the 1.5B / 1.6B widths
MAIN_GEMM = [(256, 768, 768), (256, 768, 64), (256, 64, 768), (256, 768, 3072),
             (256, 3072, 768), (256, 2048, 2048), (256, 2048, 8192), (256, 8192, 2048)]
FORMS = ("w8a8",) + TK.K9_FORMS


def _steps(form, k):
    return -(-k // TK.GEMM_BK["w8a8" if form == "w8a8" else "block"])


def _ranges(steps, split):
    """The K steps of each cluster rank, as gemm_common.cuh::split_range."""
    return [(steps * z // split, steps * (z + 1) // split) for z in range(split)]


# -- (a) the plan ----------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", MAIN_GEMM, ids=lambda s: "x".join(map(str, s)))
def test_plan_fills_the_card_at_main_path_shapes(form, shape):
    m, k, n = shape
    p = TK.matmul_plan(form, m, k, n)
    kind = "w8a8" if form == "w8a8" else "block"
    assert p.route == "gemm" and (p.bm, p.bn) in TK.GEMM_TILES
    assert p.blocks == -(-m // p.bm) * -(-n // p.bn) * p.split >= SMS
    assert 1 <= p.split <= TK.MAX_SPLIT and p.split <= _steps(form, k)
    assert p.scratch == (m * k + 4 * m if form == "w8a8" else 0)


def _cases(forms, shapes):
    """(form, shape) pairs the form's kernel takes (K9: K % 32 == 0)."""
    return [pytest.param(f, s, id=f"{f}-{'x'.join(map(str, s))}") for f in forms for s in shapes
            if f == "w8a8" or s[1] % 32 == 0]


@pytest.mark.parametrize("form, shape", _cases(["w8a8", "plain", "rowwise"], MAIN_GEMM + [
    (300, 2080, 195), (9, 32, 200), (33, 48, 200)]))
def test_plan_splits_k_into_whole_stages(form, shape):
    m, k, n = shape
    p = TK.matmul_plan(form, m, k, n)
    ranges = _ranges(_steps(form, k), p.split)
    assert ranges[0][0] == 0 and ranges[-1][1] == _steps(form, k)
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))


@pytest.mark.parametrize("form, shape", _cases(FORMS, [
    (1, 768, 65536), (1, 3072, 768), (1, 768, 768), (8, 768, 768), (5, 2080, 195), (1, 64, 768),
    (8, 8192, 2048), (3, 48, 200)]))
def test_plan_takes_the_gemv_route_up_to_m8(form, shape):
    m, k, n = shape
    p = TK.matmul_plan(form, m, k, n)
    assert p.route == "gemv" and p.bm == 0 and p.split == 1 and p.scratch == 0
    assert p.lanes in (1, 2, 4, 8, 16, 32)
    kind = "w8a8" if form == "w8a8" else "block"
    rows_per_block = TK.GEMV_WARPS[kind] * (32 // p.lanes)
    full = -(-n // rows_per_block)
    assert p.blocks == (min(full, TK.K1_GEMV_MAX_BLOCKS) if kind == "w8a8" else full)
    if p.lanes < 32:
        assert p.blocks >= TK.GEMV_MIN_BLOCKS[kind] or p.blocks == TK.K1_GEMV_MAX_BLOCKS


def test_plan_sends_k1_past_its_gemv_shared_memory_to_the_gemm():
    """K1's GEMV stages x's M x K codes in shared memory beside its static
    bytes: a wider x takes the tensor-core route, which takes any M. The
    last GEMV shapes at M = 8 and 7 leave the static bytes room; one more
    16-code step (and M x K = 232,448, which left none) goes to the GEMM."""
    room = TK.K1_GEMV_MAX_SMEM - TK.K1_GEMV_STATIC_SMEM
    assert room == 232448 - 1056
    assert TK.matmul_plan("w8a8", 8, 28912, 64).route == "gemv"
    assert TK.matmul_plan("w8a8", 7, 33056, 64).route == "gemv" and 7 * 33056 == room
    for m, k in ((8, 28928), (8, 29056), (7, 33072)):
        assert TK.matmul_plan("w8a8", m, k, 64).route == "gemm", (m, k)
    p = TK.matmul_plan("w8a8", 8, 32768, 64)
    assert p.route == "gemm" and p.scratch == 8 * 32768 + 4 * 8
    assert TK.matmul_plan("plain", 8, 32768, 64).route == "gemv"


def test_plan_of_the_head_fills_the_card():
    assert TK.matmul_plan("w8a8", 1, 768, 65536).blocks >= SMS
    for form in TK.K9_FORMS:
        assert TK.matmul_plan(form, 1, 768, 65536).blocks >= 2 * SMS


@pytest.mark.parametrize("form, m, k, n", [
    ("w8a8", 4, 24, 64), ("w8a8", 300, 8, 64), ("plain", 4, 48, 64), ("rowwise", 300, 16, 64),
    ("pack4", 300, 80, 64), ("w8a8", 0, 64, 64), ("min", 5, 64, 0), ("int4", 5, 64, 64)])
def test_plan_refuses_what_the_kernels_cannot_take(form, m, k, n):
    with pytest.raises(ValueError):
        TK.matmul_plan(form, m, k, n)


# -- (b) and (c): the tensor-core arithmetic, emulated -----------------------------


def _weight(fmt, n, k, seed, scale=1.0):
    """(the port's PackedQuantWeight, JAX's) of one seeded weight in `fmt`."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k) * scale).astype(np.float32)
    w[0] = 0.0
    if fmt in ("q8", "q8r"):
        rowwise = fmt == "q8r"
        return (TK.quantize_q8_serving(w, rowwise=rowwise, int8_act=False),
                JK.quantize_q8_serving(jnp.asarray(w), rowwise=rowwise))
    data = TQ.quantize_rows(w, TQ.dtype_from_name(fmt)).tobytes()
    tw = TK.PackedQuantWeight.from_weight(Weight.from_packed(data, TQ.dtype_from_name(fmt), (n, k)))
    jw = JK.PackedQuantWeight.from_weight(JWeight.from_packed(data, JQ.dtype_from_name(fmt), (n, k)))
    return tw, jw


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 3.0, (m, 1))).astype(np.float32)
    x[-1] = 0.0
    return x


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def emulate_f32_forms(x: torch.Tensor, w: TK.PackedQuantWeight) -> torch.Tensor:
    """K9's GEMM route on the f32 forms, as block_matmul.cu computes it."""
    m, k = x.shape
    n = w.q.shape[0]
    hi = _bf16(x)
    mid = _bf16(x - hi)
    lo = _bf16(x - hi - mid)
    xp = hi.double() + mid.double() + lo.double()  # what the three bf16 passes carry
    q = TK.codes(w).double()
    plan = TK.matmul_plan(w.form, m, k, n)
    out = torch.zeros((m, n), dtype=torch.float32)
    for first, last in _ranges(_steps(w.form, k), plan.split):  # rank order
        acc = torch.zeros((m, n), dtype=torch.float32)
        for b in range(first * 2, min(last * 2, k // 32)):  # two quant blocks a stage
            cols = slice(32 * b, 32 * b + 32)
            part = (xp[:, cols] @ q[:, cols].T).float()
            acc = (w.d[:, b].double() * part.double() + acc.double()).float()  # fma
            if w.m is not None:
                s = x[:, cols].double().sum(dim=1, keepdim=True).float()
                acc = (w.m[:, b].double() * s.double() + acc.double()).float()
        out = out + acc
    return out


def emulate_rowwise(x: torch.Tensor, w: TK.PackedQuantWeight) -> torch.Tensor:
    """K9's GEMM route on rowwise weights: bf16 x times the codes, f32
    sums, the row scale last."""
    m, k = x.shape
    n = w.q.shape[0]
    xb = _bf16(x).double()
    q = w.q.double()
    plan = TK.matmul_plan("rowwise", m, k, n)
    out = torch.zeros((m, n), dtype=torch.float32)
    for first, last in _ranges(_steps("rowwise", k), plan.split):
        cols = slice(64 * first, min(64 * last, k))
        out = out + (xb[:, cols] @ q[:, cols].T).float()
    return out * w.d


def _band(x, w):
    return np.abs(x) @ np.abs(TK.dequant_weight(w).numpy()).T


# the 169M shapes each format meets: a file quantizes r, k, v, out, fk and
# fv; q8 also the LoRAs (768 -> 64, 64 -> 768)
FILE_SHAPES = [(256, 768, 768), (256, 768, 3072), (256, 3072, 768)]
EMU_CASES = [pytest.param(f, s, id=f"{f}-{'x'.join(map(str, s))}")
             for f in ["Q8_0", "Q5_0", "Q5_1", "Q4_0", "Q4_1", "Q4_K", "Q5_K"] for s in FILE_SHAPES]
EMU_CASES += [pytest.param("q8", s, id=f"q8-{'x'.join(map(str, s))}")
              for s in FILE_SHAPES + [(256, 768, 64), (256, 64, 768)]]


@pytest.mark.parametrize("fmt, shape", EMU_CASES)
def test_f32_forms_emulation_within_band_of_jax(fmt, shape):
    m, k, n = shape
    tw, jw = _weight(fmt, n, k, seed=m + k + n)
    assert tw.form in ("plain", "min", "pack4", "pack4_min")
    x = _x(m, k, seed=k + n)
    got = emulate_f32_forms(torch.from_numpy(x), tw).numpy()
    ref = np.asarray(JK.quant_matmul(jnp.asarray(x), jw, force="xla"))[:, :n]
    assert np.all(np.abs(got - ref) <= K9_BAND * _band(x, tw) + 1e-30), fmt


@pytest.mark.parametrize("fmt", ["Q8_0", "Q5_1", "Q4_0", "Q4_1", "Q5_K", "q8"])
@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_f32_forms_emulation_within_band_at_extreme_scales(fmt, scale):
    m, k, n = 64, 768, 256
    tw, jw = _weight(fmt, n, k, seed=11, scale=scale)
    x = _x(m, k, seed=12)
    got = emulate_f32_forms(torch.from_numpy(x), tw).numpy()
    ref = np.asarray(JK.quant_matmul(jnp.asarray(x), jw, force="xla"))[:, :n]
    assert np.all(np.isfinite(got))
    assert np.all(np.abs(got - ref) <= K9_BAND * _band(x, tw) + 1e-30), (fmt, scale)


@pytest.mark.parametrize("shape", [(256, 768, 768), (256, 768, 64), (33, 3072, 768)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rowwise_emulation_within_band_of_jax_kernel(shape):
    m, k, n = shape
    tw, jw = _weight("q8r", n, k, seed=m + n)
    x = _x(m, k, seed=k)
    got = emulate_rowwise(torch.from_numpy(x), tw).numpy()
    ref = np.asarray(JK.quant_matmul(jnp.asarray(x), jw, force="interpret"))[:, :n]
    assert np.all(np.abs(got - ref) <= K9_BAND * _band(x, tw) + 1e-30)
