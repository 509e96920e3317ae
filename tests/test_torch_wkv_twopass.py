"""The two-pass association of kernels K2 and K5 (``wkv7_twopass`` /
``wkv6_twopass``, plain PyTorch) against the JAX package's
``wkv7_chunked_twopass``, its Pallas kernels in interpret mode and its
token scans; and their launch plan ``wkv_chunk_plan``.

Inputs are made with numpy from a seed. Tolerances: rtol 1e-4 / atol 1e-5
against the token scan (the kernels' own band against their recurrence),
rtol 3e-4 / atol 3e-5 against the chunked forms (tests/test_chunked.py's
band: another association of the same f32 sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.graph import wkv6_scan as j_scan6
from rwkv_tpu.models.graph import wkv7_scan as j_scan7
from rwkv_tpu.ops.chunked import (
    wkv6_chunked_pallas, wkv7_chunked_pallas, wkv7_chunked_twopass,
)
from rwkv_tpu_torch.ops import chunked as TC

SCAN = dict(rtol=1e-4, atol=1e-5)
CHUNKED = dict(rtol=3e-4, atol=3e-5)


def _ops7(t, bh, s, seed):
    """v7 operands [T, BH, S]: bounded decay, a = -kk, b = kk * gate; s0
    [BH, S, S]."""
    rng = np.random.RandomState(seed)
    shape = (t, bh, s)
    r, k, v = (rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3))
    w = np.exp(-0.606531 / (1 + np.exp(-rng.randn(*shape)))).astype(np.float32)
    kk = rng.randn(*shape).astype(np.float32)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    gate = (1 / (1 + np.exp(-rng.randn(*shape)))).astype(np.float32)
    s0 = rng.randn(bh, s, s).astype(np.float32) * 0.3
    return [s0, r, w, k, v, -kk, (kk * gate).astype(np.float32)]


def _ops6(t, bh, s, seed, decay):
    """v6 operands [T, BH, S], tf [BH, S], s0 [BH, S, S]; decay 'normal'
    (exp(-exp(N(0, 1)))), 'extreme' (half the channels at exp(-20) a token)
    or 'zero' (exp(-exp(3 N(0, 1))), some of which underflow to 0, and 5%
    of them 0: XLA's CPU flushes the 1e-38 log floor to zero, so only the
    scans take these)."""
    rng = np.random.RandomState(seed)
    shape = (t, bh, s)
    r, k, v = (rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3))
    scale = 3.0 if decay == "zero" else 1.0
    w = np.exp(-np.exp(scale * rng.randn(*shape)))
    if decay == "extreme":
        w = np.where(rng.rand(*shape) < 0.5, np.exp(-20.0), w)
    w = w.astype(np.float32)
    if decay == "zero":
        w[rng.rand(*shape) < 0.05] = 0.0
    tf = rng.randn(bh, s).astype(np.float32) * 0.2
    s0 = rng.randn(bh, s, s).astype(np.float32) * 0.3
    return [s0, r, k, v, w, tf]


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, tol):
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **tol)


@pytest.mark.parametrize("t", [3, 16, 17, 48])
@pytest.mark.parametrize("bh", [1, 3])
@pytest.mark.parametrize("s", [32, 64])
def test_wkv7_twopass_matches_jax_scan(t, bh, s):
    """Every T (ragged ones padded with identity tokens, T < P a single
    padded chunk) against JAX's token scan."""
    ops = _ops7(t, bh, s, seed=t * 7 + bh + s)
    y_ref, s_ref = j_scan7(*(jnp.asarray(x) for x in ops))
    _close(TC.wkv7_twopass(*_t(ops)), (y_ref, s_ref), SCAN)


@pytest.mark.parametrize("t,bh,s", [(16, 3, 32), (48, 1, 64), (48, 3, 32)])
def test_wkv7_twopass_matches_jax_twopass_and_pallas(t, bh, s):
    """T a multiple of P: JAX's wkv7_chunked_twopass (dense A, B state
    maps) and wkv7_chunked_pallas in interpret mode (the grouped kernel)."""
    ops = _ops7(t, bh, s, seed=t + 11 * bh + s)
    got = TC.wkv7_twopass(*_t(ops))
    jops = [jnp.asarray(x) for x in ops]
    _close(got, wkv7_chunked_twopass(*jops, chunk_size=16), CHUNKED)
    _close(got, wkv7_chunked_pallas(*jops, chunk_size=16, interpret=True), CHUNKED)


@pytest.mark.parametrize("t", [3, 16, 17, 48])
@pytest.mark.parametrize("bh", [1, 3])
@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("decay", ["normal", "extreme", "zero"])
def test_wkv6_twopass_matches_jax_scan(t, bh, s, decay):
    """Every T against JAX's token scan, also with extreme decays and
    decays that underflowed to 0 (the 1e-38 log floor keeps every exponent
    finite)."""
    ops = _ops6(t, bh, s, seed=t * 5 + bh + s, decay=decay)
    y_ref, s_ref = j_scan6(*(jnp.asarray(x) for x in ops))
    got = TC.wkv6_twopass(*_t(ops))
    assert all(torch.isfinite(x).all() for x in got)
    _close(got, (y_ref, s_ref), SCAN)


@pytest.mark.parametrize("t,bh,s", [(16, 3, 32), (48, 1, 64)])
@pytest.mark.parametrize("decay", ["normal", "extreme"])
def test_wkv6_twopass_matches_jax_pallas(t, bh, s, decay):
    """T a multiple of P: wkv6_chunked_pallas in interpret mode, extreme
    decays included; and the plain token scan."""
    s0, r, k, v, w, tf = _ops6(t, bh, s, seed=t + 3 * bh + s, decay=decay)
    got = TC.wkv6_twopass(*_t([s0, r, k, v, w, tf]))
    want = wkv6_chunked_pallas(*(jnp.asarray(x) for x in (s0, r, k, v, w, tf)), chunk_size=16,
                               interpret=True)
    _close(got, want, CHUNKED)
    _close(got, TC.wkv6_recurrence_plain(*_t([s0, r, k, v, w, tf])), SCAN)


def test_pad_chunks_appends_identity_tokens():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    c = TC._pad_chunks(x, 16, 1.0)
    assert c.shape == (1, 3, 16, 4)
    torch.testing.assert_close(c[0, :, :2].transpose(0, 1), x)
    assert (c[0, :, 2:] == 1.0).all()


@pytest.mark.parametrize("kind", [6, 7])
@pytest.mark.parametrize("bh,rows", [(12, 32), (32, 32), (96, 64)])
def test_plan_crossover(kind, bh, rows):
    """Below the crossover the launch runs the token recurrence (at S = 64
    32 rows a block, 64 where 2 BH blocks would outnumber the SMs; a block
    a (head, row group) pair; no chunks, no stages, no scratch); from it
    on, ceil(T / P) chunks. The crossover grows with the heads."""
    x = TC.recurrence_below(kind, bh)
    assert x >= TC.recurrence_below(kind, 1) and x <= TC.recurrence_below(kind, 1000)
    below = TC.wkv_chunk_plan(kind, x - 1, bh, 64)
    at = TC.wkv_chunk_plan(kind, x, bh, 64)
    assert below.crossover == at.crossover == x
    assert below.recurrent == 1 and below.n_chunks == 0 and below.scratch_floats == 0
    assert (below.rows, below.groups, below.grid, below.stages) == (rows, 64 // rows,
                                                                    bh * 64 // rows, 0)
    assert at.recurrent == 0 and at.n_chunks == -(-x // TC.WKV_P)
    assert at.scratch_floats == at.n_chunks * bh * TC.wkv_item_floats(kind, 64)


@pytest.mark.parametrize("kind", [6, 7])
@pytest.mark.parametrize("t", [1, 3, 15, 16, 17, 33, 255, 256, 257])
def test_plan_ragged_and_short_t(kind, t):
    """With the two passes forced (below=0), a ragged T takes one padded
    chunk more, and T < P one chunk."""
    plan = TC.wkv_chunk_plan(kind, t, 3, 32, below=0)
    assert plan.recurrent == 0 and plan.p == 16
    assert plan.n_chunks == (t + 15) // 16
    assert plan.grid == min(132 * plan.blocks_per_sm, plan.n_chunks * 3 + 3 * plan.groups)


@pytest.mark.parametrize("kind", [6, 7])
@pytest.mark.parametrize("bh,recurrent,rows,groups,grid", [(12, 0, 8, 8, 264), (32, 0, 8, 8, 264),
                                                           (96, 1, 64, 1, 96)])
def test_plan_heads_of_the_main_paths(kind, bh, recurrent, rows, groups, grid):
    """BH = 12 (v7 169M), 32 (v6 1.6B) and 96 (a batch of 8 at 169M) at
    S = 64, T = 256: the two passes on two blocks an SM, pass B's (head, row
    group) items within the 264 slots, the grid every slot; at 96 heads the
    recurrence, two rows a lane, a block a head."""
    plan = TC.wkv_chunk_plan(kind, 256, bh, 64)
    assert (plan.recurrent, plan.rows, plan.groups, plan.grid) == (recurrent, rows, groups, grid)
    if not recurrent:
        assert plan.blocks_per_sm == 2 and plan.stages == 4
        assert plan.smem_bytes <= TC.SMEM_TWO_PER_SM
        assert plan.scratch_floats == 16 * bh * TC.wkv_item_floats(kind, 64)


@pytest.mark.parametrize("kind", [6, 7])
@pytest.mark.parametrize("s", [32, 64, 128])
@pytest.mark.parametrize("bh", [1, 2, 12, 32, 96, 133, 1000])
def test_plan_fits_the_card(kind, s, bh):
    """Every plan: rows a power-of-two share of S (>= 8); the recurrence a
    block a (head, row group) pair, its rows and two tiles of operands in
    shared memory; the two passes a grid within one block a slot, shared
    memory within the budget of its blocks an SM and holding pass A and
    pass B's ring."""
    rec = TC.wkv_chunk_plan(kind, 5, bh, s, below=50)
    assert rec.recurrent == 1 and rec.rows == TC.recurrence_rows(s, bh, 132)
    assert rec.rows * rec.groups == s and rec.rows >= min(s, 2048 // s)
    assert rec.grid == bh * rec.groups and rec.stages == 0
    assert rec.smem_bytes == TC.WKV_BAR_BYTES + 4 * TC._recurrence_floats(kind, s, rec.rows)
    plan = TC.wkv_chunk_plan(kind, 100, bh, s, below=50)
    assert plan.recurrent == 0 and plan.rows * plan.groups == s and plan.rows >= 8
    assert plan.grid <= 132 * plan.blocks_per_sm
    assert 2 <= plan.stages <= 4
    budget = TC.SMEM_TWO_PER_SM if plan.blocks_per_sm == 2 else TC.SMEM_ONE_PER_SM
    floats = max(TC._pass_a_floats(kind, s), TC._pass_b_floats(kind, s, plan.rows, plan.stages))
    assert plan.smem_bytes == TC.WKV_BAR_BYTES + 4 * floats <= budget
    if bh <= 132 * plan.blocks_per_sm:
        assert bh * plan.groups <= 132 * plan.blocks_per_sm


def test_plan_rejects_what_no_kernel_takes():
    for args in ((5, 16, 1, 64), (7, 16, 1, 48), (6, 0, 1, 64), (7, 16, 0, 64)):
        with pytest.raises(ValueError):
            TC.wkv_chunk_plan(*args)
