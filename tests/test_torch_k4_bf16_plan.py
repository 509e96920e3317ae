"""K4's bf16 form on the CPU: its launch plan, the three-part split of its
f32 inputs, and the operand order of its bf16 tensor-core sweep.

``batched_plan("bf16", ...)`` is the plan the bf16 form of K4
(``csrc/v7_decode_batched.cu`` over ``csrc/batch_mma.cuh``) launches
with: the tests hold its shared bytes within a block's limit for every
batch at the widths the port serves and on small grids. ``split3`` is
the split of ``gemm::bf16_parts`` (``csrc/gemm_common.cuh``), in torch.
``emulate_sweep_bf16`` replays, in numpy, what the kernel's
``sweep_pass_bf16`` hands to ``mma.sync.m16n8k16.bf16``: each lane's 8
bytes of weight rows g and g + 8 and 16 bytes of sequence g's f32 inputs
per 16-value block, rebuilt into the mma's A and B from the PTX fragment
layout; the three parts' mmas from zero (each mma modelled as its exact
sum rounded once to f32), each block's product added into its leaf in
f32, the leaves' K steps dealt as the kernel deals them (passes of the
plan's tiles, K slices of the plan's size, warps by leaf and unit, steps
in pairs) and added as (L0 + L2) + (L1 + L3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu_torch.ops import megakernel as TM

# (C, F, D): the 169M width and the 1.5B width
WIDTHS = {"169M": (768, 3072, 64), "1.5B": (2048, 8192, 64)}
GRIDS = (132, 64, 33, 7)


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("blocks", GRIDS)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_bf16_plan_fits_a_block_for_every_batch(width, blocks):
    """Every B in 1..256 has a bf16 plan whose shared bytes, static
    included, fit a block on grids of 132, 64, 33 and 7 blocks; its K
    slices are whole 64-value steps up to each sweep's K; no sweep is cut
    into K parts (the bf16 sums' order); placement (a) only up to
    K4_PLACE_A_MAX_B."""
    c, f, d = WIDTHS[width]
    ks_max = (c, c, c, c, f)
    for b in range(1, TM.K4_MAX_BATCH + 1):
        p = TM.batched_plan("bf16", b, c, f, d, blocks=blocks)
        assert p.smem + p.static <= TM.K4_SMEM_LIMIT, (b, p)
        assert p.smem % 16 == 0 and p.split == (1,) * 5
        assert p.place == "b" or b <= TM.K4_PLACE_A_MAX_B, (b, p)
        assert p.ring in (1, 2) and (p.n_tiles - 1) * 8 < b <= p.n_tiles * 8
        for ks, k in zip(p.k_slice, ks_max):
            assert ks % TM.K4_BF16_STEP == 0 and TM.K4_BF16_STEP <= ks <= k, (b, p)


def test_bf16_plan_placement():
    """(a) where it fits (C=768 up to B=8, the f32 inputs of 6 x 8 rows in
    shared memory), (b) above and at every B at C=2048, where (a)'s inputs
    alone pass the limit; (b) may be forced where (a) fits."""
    assert TM.batched_plan("bf16", 8, 768, 3072, 64).place == "a"
    assert TM.batched_plan("bf16", 9, 768, 3072, 64).place == "b"
    assert TM.batched_plan("bf16", 1, 2048, 8192, 64).place == "b"
    assert TM.batched_plan("bf16", 8, 768, 3072, 64, place="b").place == "b"
    with pytest.raises(ValueError):
        TM.batched_plan("bf16", 1, 2048, 8192, 64, place="a")
    # (a): phase C's scratch (4 D f32), 8 x C sequence rows, 6 x 8 input rows
    base = (12 * 64 + 264) * 4 + 16 * 64 + 8 * 768 * 4 + 6 * 8 * (4 * 768 + 64)
    p = TM.batched_plan("bf16", 8, 768, 3072, 64)
    assert p.smem - base == 2 * 16 * (2 * 768 + 32)  # rkv's two 16-row tiles, K whole


def test_bf16_plan_ints_match_the_c_entry():
    """The bf16 entry takes the dims, emb_f32 and the grid (9 ints), then
    the plan's eight: place, ring, five K slices (values), the shared
    bytes."""
    p = TM.batched_plan("bf16", 17, 2048, 8192, 64)
    assert p.ints() == (1, p.ring, *p.k_slice, p.smem)
    assert TM.BATCHED_ARGS["bf16"] == (13, 9 + len(p.ints()))
    assert TM.K4_FORM_CODE["bf16"] == 2


@pytest.mark.parametrize("batch", [1, 8, 9, 64, 256])
def test_bf16_scratch_holds_the_f32_inputs(batch):
    """The bf16 scratch adds placement (b)'s f32 inputs (max(6C, F) x B
    floats) after the arrays every form has, on a 16-byte boundary, and no
    int codes, scales or split sums."""
    c, f, d = 768, 3072, 64
    base = TM.batched_scratch_floats(c, d, f, batch, codes=False)
    full = TM.batched_scratch_floats(c, d, f, batch, bf16=True)
    assert base % 4 == 0 and full - base == max(6 * c, f) * batch
    assert TM.batched_scratch_floats(c, d, f, batch, codes=False, bf16=True) == base


# -- the three-part split ------------------------------------------------------------


def split3(x: torch.Tensor):
    """gemm::bf16_parts<3>: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), round to nearest even, the differences in f32."""
    parts, r = [], x.clone()
    for p in range(3):
        h = r.to(torch.bfloat16)
        parts.append(h)
        if p < 2:
            r = r - h.float()
    return parts


def _split_cases():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal(4096).astype(np.float32) * np.float32(3.0)
    wide = (rng.standard_normal(2048) * 2.0 ** rng.integers(-90, 100, 2048)).astype(np.float32)
    k = rng.integers(-100, 120, 1024)
    near = np.concatenate([np.ldexp(np.float32(1), k).astype(np.float32)[:, None]
                           * np.float32([1.0, 1 - 2 ** -24, 1 + 2 ** -23, 1 - 2 ** -9,
                                         1 + 2 ** -8 + 2 ** -9])]).ravel()
    near = np.concatenate([near, -near]).astype(np.float32)
    # up to bf16's largest value and a half ulp, 2^128 (1 - 2^-9)
    large = np.float32(2.0 ** 127) * (1 + rng.random(2048, dtype=np.float32) * np.float32(0.99))
    large = np.concatenate([large, [np.float32(2.0 ** 128 * (1 - 2 ** -9)) * np.float32(1 - 2 ** -23)]])
    return {"normal": normal, "wide": wide, "near powers of two": near, "large": large}


@pytest.mark.parametrize("case", ["normal", "wide", "near powers of two", "large"])
def test_split3_is_exact(case):
    """hi + mid + lo == x bit for bit, each part a bf16 value (its widening
    back to f32 exact), for f32 values from 2^-110 up to bf16's largest
    value and a half ulp: random, spread over the exponents, just around
    powers of two, and very large."""
    x = torch.from_numpy(_split_cases()[case])
    assert bool(torch.isfinite(x).all())
    hi, mid, lo = split3(x)
    for part in (hi, mid, lo):
        assert bool(torch.isfinite(part.float()).all())
        assert torch.equal(part.float().to(torch.bfloat16), part)
    total = hi.float() + mid.float() + lo.float()  # exact: the parts' bits do not overlap
    assert torch.equal(total, x)
    assert torch.equal((hi.float() + (mid.float() + lo.float())), x)


def test_split3_on_subnormals_and_tiny_values():
    """Below 2^-110 the parts keep what bf16's subnormals hold (multiples
    of 2^-133): three bf16 values cannot carry an f32 subnormal's last
    bits, so the split misses x by at most 2^-134 there, and nothing at
    2^-110 and above; zero splits into zeros."""
    rng = np.random.default_rng(1)
    sub = (rng.integers(1, 2 ** 23, 4096) * 2.0 ** -149).astype(np.float32)
    tiny = (rng.standard_normal(4096) * 2.0 ** rng.integers(-126, -110, 4096)).astype(np.float32)
    for vals in (sub, -sub, tiny):
        x = torch.from_numpy(vals)
        hi, mid, lo = split3(x)
        for part in (hi, mid, lo):
            assert torch.equal(part.float().to(torch.bfloat16), part)
        err = (x.double() - (hi.double() + mid.double() + lo.double())).abs()
        assert float(err.max()) <= 2.0 ** -134
    edge = torch.tensor([2.0 ** -110, -3 * 2.0 ** -110, 0.0])
    assert torch.equal(sum(p.float() for p in split3(edge)), edge)


# -- the sweep's fragments ----------------------------------------------------------


def _perm():
    """mma k -> value of the 16-value block, from the lanes' reads: lane (g,
    t) reads values 4 t .. 4 t + 3 of the block (8 bytes of a weight row,
    16 of an input row); its words 0 and 1 are a0 / a2 (weights) and its
    value pairs (0, 1) and (2, 3) b0 / b1 (inputs), and the PTX layout of
    m16n8k16 puts a0 / b0 at k = 2 t, 2 t + 1 and a2 / b1 at k = 2 t + 8,
    2 t + 9."""
    perm = np.full(16, -1)
    for lane in range(32):
        t = lane % 4
        for i in range(2):
            for reg_k, value in ((2 * t + i, 4 * t + i), (2 * t + 8 + i, 4 * t + 2 + i)):
                assert perm[reg_k] in (-1, value)
                perm[reg_k] = value
    assert sorted(perm) == list(range(16))
    return perm


PERM = _perm()


def _mma_block(w16: np.ndarray, x8: np.ndarray) -> np.ndarray:
    """block_bf16 for one 16x16 weight block (bf16 values as f32) and the
    8 columns' 16 f32 inputs: A [16 rows][mma k] and B [mma k][8 cols]
    from the lanes' fragments, x split into hi / mid / lo, three mmas from
    zero in the order lo, mid, hi, each its exact sum rounded to f32."""
    a = w16[:, PERM].astype(np.float64)
    parts = [p.float().numpy() for p in split3(torch.from_numpy(np.ascontiguousarray(x8)))]
    d = np.zeros((16, 8), np.float32)
    for part in parts[::-1]:
        b = part[:, PERM].T.astype(np.float64)  # [mma k][col]
        d = (d.astype(np.float64) + a @ b).astype(np.float32)
    return d


def emulate_sweep_bf16(w: np.ndarray, x: np.ndarray, ks: int, passes=None) -> np.ndarray:
    """The f32 sums K4's bf16 sweep computes for weight rows w [N, K] (bf16
    values as f32, N a multiple of 16) against inputs x [B, K] f32, in the
    kernel's order: the block's tiles in passes of `passes` tiles each (by
    default the kernel's: a pass's units, tile x group of 4 n-tiles, fill
    the 8 warps), n-tiles of 8 sequences (zero past B here; the kernel's
    pad columns, whatever they hold, feed only themselves), K slices of ks
    values (zero past K), warp w summing leaf w % 4 (the 16-value blocks
    4 s + leaf) of units w / 4 + 2 r, two steps' products at a time, each
    added into its leaf in f32; then (L0 + L2) + (L1 + L3). Returns
    [N, B]."""
    n, k = w.shape
    b = x.shape[0]
    nt = -(-b // 8)
    groups = -(-nt // 4)
    tiles = n // 16
    if passes is None:
        per_pass = 1 if groups >= 8 else 8 // groups
        passes = [min(per_pass, tiles - c) for c in range(0, tiles, per_pass)]
    assert sum(passes) == tiles
    step = TM.K4_BF16_STEP
    kr = -(-k // step) * step
    wz = np.zeros((n, kr), np.float32)
    wz[:, :k] = w
    xz = np.zeros((8 * nt, kr), np.float32)
    xz[:b, :k] = x
    out = np.zeros((n, 8 * nt), np.float32)
    c0 = 0
    for ntc in passes:
        units = ntc * groups
        assert units <= 8
        leaves = np.zeros((4, ntc * 16, 8 * nt), np.float32)
        for k0 in range(0, kr, ks):
            steps = -(-min(kr - k0, ks) // step)
            for warp in range(8):
                leaf, u0 = warp % 4, warp // 4
                for r in range(4):
                    u = u0 + 2 * r
                    if u >= units:
                        continue
                    j, n0 = u // groups, (u % groups) * 4
                    rows = slice((c0 + j) * 16, (c0 + j + 1) * 16)
                    for kk0 in range(0, steps, 2):
                        for nti in range(n0, min(n0 + 4, nt)):
                            cols = slice(nti * 8, nti * 8 + 8)
                            ds = []
                            for kk in range(kk0, min(kk0 + 2, steps)):
                                v = k0 + kk * step + 16 * leaf
                                ds.append(_mma_block(wz[rows, v:v + 16], xz[cols, v:v + 16]))
                            acc = leaves[leaf, j * 16:j * 16 + 16, cols]
                            for d in ds:
                                acc = (acc + d).astype(np.float32)
                            leaves[leaf, j * 16:j * 16 + 16, cols] = acc
        total = ((leaves[0] + leaves[2]).astype(np.float32)
                 + (leaves[1] + leaves[3]).astype(np.float32)).astype(np.float32)
        out[c0 * 16:(c0 + ntc) * 16] = total
        c0 += ntc
    return out[:, :b]


def _bf16_rows(n, k, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((n, k)) * scale).astype(np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n, k, b, ks", [(16, 64, 1, 64), (32, 256, 9, 128), (16, 320, 17, 192),
                                         (48, 128, 8, 128), (16, 80, 3, 128)])
def test_sweep_fragments_on_small_integers_equal_the_plain_dot(n, k, b, ks):
    """bf16 rows and inputs that are small integers: every product and sum
    is exact, so the emulated sweep equals x @ W.T bit for bit, whatever
    the K slice, the ragged last n-tile and a K not a multiple of 64."""
    rng = np.random.default_rng(n + k + b + ks)
    w = rng.integers(-8, 9, (n, k)).astype(np.float32)
    x = rng.integers(-100, 101, (b, k)).astype(np.float32)
    got = emulate_sweep_bf16(w, x, ks)
    np.testing.assert_array_equal(got, (x.astype(np.float64) @ w.T.astype(np.float64)).T)


def test_sweep_fragments_see_k_in_natural_order():
    """A single nonzero weight at K position p and a single nonzero input
    at p reach exactly the product of that row and sequence: the lanes' K
    permutation is the same for both operands, in every block and leaf."""
    k, b = 256, 9
    for p in (0, 3, 5, 15, 16, 31, 47, 63, 64, 100, 200, 255):
        w = np.zeros((16, k), np.float32)
        x = np.zeros((b, k), np.float32)
        w[11, p] = 3.0
        x[8, p] = -5.0
        got = emulate_sweep_bf16(w, x, 128)
        want = np.zeros((16, b), np.float32)
        want[11, 8] = -15.0
        np.testing.assert_array_equal(got, want, err_msg=f"p={p}")


@pytest.mark.parametrize("k", [768, 256])
def test_sweep_matches_jax_quant_false_matv(k):
    """Random bf16 rows against random f32 inputs: the emulated sweep (x in
    three parts, each block's mmas from zero, f32 adds) lies within 2e-6
    of sum |x| |W| of JAX's quant=False matv (the rows widened to f32, an
    f32 dot at Precision.HIGHEST) on the CPU: both are the exact dot but
    for a few f32 roundings."""
    n, b = 32, 9
    w = _bf16_rows(n, k, seed=k)
    x = np.random.default_rng(k + 1).standard_normal((b, k)).astype(np.float32)
    got = emulate_sweep_bf16(w, x, 256)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax.lax.dot_general(
            jnp.asarray(w, jnp.bfloat16).astype(jnp.float32), jnp.asarray(x.T),
            dimension_numbers=(((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST))
    scale = np.abs(w).astype(np.float64) @ np.abs(x.T).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= 2e-6 * scale)
    exact = w.astype(np.float64) @ x.T.astype(np.float64)
    assert np.all(np.abs(got - exact) <= 2e-6 * scale)


def test_sweep_sum_order_does_not_depend_on_the_batch():
    """Sequence s's sums come out bit-identical whether it sits in a batch
    of 1, 8, 9, 64 or 256 (other n-tiles, units and passes; the K slice
    batched_plan gives each batch's rkv sweep) and however the block's
    tiles fall into passes (another grid): the order of a row's sums
    depends on K alone."""
    c, f, d = 768, 3072, 64
    n, k = 32, 256
    w = _bf16_rows(n, k, seed=5)
    x = np.random.default_rng(6).standard_normal((256, k)).astype(np.float32)
    seqs = {1: [0], 8: [0, 5], 9: [0, 5, 8], 64: [0, 5, 8, 63], 256: [0, 5, 8, 63, 200]}
    outs = {}
    for b in seqs:
        ks = min(TM.batched_plan("bf16", b, c, f, d).k_slice[0], k)
        outs[(b, "plan")] = emulate_sweep_bf16(w, x[:b], ks)
        outs[(b, "one a pass")] = emulate_sweep_bf16(w, x[:b], ks, passes=[1, 1])
    for (b, how), got in outs.items():
        for s in seqs[b]:
            np.testing.assert_array_equal(got[:, s], outs[(256, "plan")][:, s],
                                          err_msg=f"B={b} {how} sequence {s}")
