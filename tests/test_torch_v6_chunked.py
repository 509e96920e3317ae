"""The port's wkv6 recurrence (kernel K5's plain versions: the chunked
form and the token scan) against the JAX package's Pallas kernel
wkv6_chunked_pallas in interpret mode, wkv6_chunked and graph.wkv6_scan,
with an extreme-decay case and a static (v5) decay."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.graph import wkv6_scan as j_scan
from rwkv_tpu.ops.chunked import wkv6_chunked as j_chunked
from rwkv_tpu.ops.chunked import wkv6_chunked_pallas
from rwkv_tpu_torch.models.graph import wkv6_scan
from rwkv_tpu_torch.ops import chunked as TC

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 sums in another order than JAX's einsums


def _operands(t, lead, s, seed, decay="normal"):
    """r/k/v/w [T, *lead, S], tf [H, S], s0 [*lead, S, S]; decay 'normal'
    (exp(-exp(N(0,1)))), 'extreme' (half the channels at exp(-20)) or
    'static' (one [H, S] decay for every token: v5)."""
    rng = np.random.RandomState(seed)
    shape = (t, *lead, s)
    r, k, v = (rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3))
    if decay == "extreme":
        w = np.exp(-np.where(rng.rand(*shape) < 0.5, 20.0, 0.01))
    elif decay == "static":
        w = np.exp(-np.exp(rng.randn(lead[-1], s)))
    else:
        w = np.exp(-np.exp(rng.randn(*shape)))
    tf = rng.randn(lead[-1], s).astype(np.float32) * 0.2
    s0 = rng.randn(*lead, s, s).astype(np.float32) * 0.3
    return s0, r, k, v, w.astype(np.float32), tf


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _pallas(s0, r, k, v, w, tf, rank):
    """JAX's kernel on the operands, batch folded into heads as wkv6_auto
    folds it."""
    t, s = r.shape[0], r.shape[-1]
    bh = int(np.prod(r.shape[1:-1]))
    if w.ndim == 2:
        w = np.broadcast_to(w, r.shape)
    tf_f = np.broadcast_to(tf, r.shape[1:]).reshape(bh, s)
    y, s_new = wkv6_chunked_pallas(
        jnp.asarray(s0.reshape(bh, s, s)),
        *(jnp.asarray(np.ascontiguousarray(x).reshape(t, bh, s)) for x in (r, k, v, w)),
        jnp.asarray(tf_f), chunk_size=16, interpret=True)
    return np.asarray(y).reshape(r.shape), np.asarray(s_new).reshape(s0.shape)


@pytest.mark.parametrize("decay", ["normal", "extreme", "static"])
@pytest.mark.parametrize("rank", [3, 4])
def test_wkv6_auto_matches_jax_pallas_interpret(rank, decay):
    """CPU dispatch (chunked form) against the TPU kernel in interpret
    mode on the same operands, 1e-4."""
    lead = (4,) if rank == 3 else (2, 4)
    s0, r, k, v, w, tf = _operands(32, lead, 64, seed=rank, decay=decay)
    y_pl, s_pl = _pallas(s0, r, k, v, w, tf, rank)
    y, s_new = TC.wkv6_auto(*_t([s0, r, k, v, w, tf]))
    assert np.isfinite(y.numpy()).all() and np.isfinite(s_new.numpy()).all()
    np.testing.assert_allclose(y.numpy(), y_pl, **TOL)
    np.testing.assert_allclose(s_new.numpy(), s_pl, **TOL)


@pytest.mark.parametrize("decay", ["normal", "extreme", "static"])
def test_wkv6_chunked_and_scan_match_jax(decay):
    """Both plain forms against JAX's wkv6_chunked and wkv6_scan."""
    s0, r, k, v, w, tf = _operands(48, (1, 3), 16, seed=5, decay=decay)
    j_ops = [jnp.asarray(x) for x in (s0, r, k, v, w, tf)]
    y_ref, s_ref = j_chunked(*j_ops, chunk_size=16)
    y_chk, s_chk = TC.wkv6_chunked(*_t([s0, r, k, v, w, tf]), chunk_size=16)
    np.testing.assert_allclose(y_chk.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s_chk.numpy(), np.asarray(s_ref), **TOL)
    y_sc, s_sc = j_scan(*j_ops)
    y_scan, s_scan = wkv6_scan(*_t([s0, r, k, v, w, tf]))
    np.testing.assert_allclose(y_scan.numpy(), np.asarray(y_sc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_scan.numpy(), np.asarray(s_sc), rtol=1e-5, atol=1e-6)


def test_wkv6_auto_falls_back_to_scan():
    """T not a chunk multiple (and T=1): the scan, bit for bit."""
    for t in (1, 30):
        s0, r, k, v, w, tf = _operands(t, (2,), 8, seed=t)
        y, s_new = TC.wkv6_auto(*_t([s0, r, k, v, w, tf]))
        y_ref, s_ref = wkv6_scan(*_t([s0, r, k, v, w, tf]))
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        torch.testing.assert_close(s_new, s_ref, rtol=0, atol=0)


def test_wkv6_recurrence_cpu_is_plain_scan_and_counts_nothing():
    s0, r, k, v, w, tf = _operands(8, (6,), 32, seed=3)
    tf_f = np.ascontiguousarray(np.broadcast_to(tf, (6, 32)))
    before = TC.wkv6_recurrence.launches
    y, s_new = TC.wkv6_recurrence(*_t([s0, r, k, v, w, tf_f]))
    y_ref, s_ref = TC.wkv6_recurrence_plain(*_t([s0, r, k, v, w, tf_f]))
    assert TC.wkv6_recurrence.launches == before
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s_new, s_ref, rtol=0, atol=0)


def test_wkv6_chunked_stays_finite_when_a_decay_underflows_to_zero():
    """A decay exp(-exp(.)) that underflowed to 0: the port's chunked form
    keeps its 1e-38 log floor (subnormal, which XLA's CPU flushes to zero,
    so JAX's wkv6_chunked returns non-finite values there) and agrees with
    the scan, the JAX package's included."""
    s0, r, k, v, w, tf = _operands(32, (1, 2), 16, seed=11)
    w[3, 0, 0, 1] = 0.0
    w[20, 0, 1, 5] = 0.0
    y_ref, s_ref = j_scan(*(jnp.asarray(x) for x in (s0, r, k, v, w, tf)))
    y, s_new = TC.wkv6_chunked(*_t([s0, r, k, v, w, tf]), chunk_size=16)
    assert torch.isfinite(y).all() and torch.isfinite(s_new).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_ref), **TOL)
