"""The port's wkv7 recurrence (kernel K2's plain versions: the chunked
form and the token scan) against the JAX package's Pallas kernel in
interpret mode and graph.wkv7_scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.graph import wkv7_scan as j_scan
from rwkv_tpu.ops.chunked import wkv7_chunked_pallas
from rwkv_tpu_torch.models.graph import wkv7_scan
from rwkv_tpu_torch.ops import chunked as TC

TOL = dict(rtol=3e-4, atol=3e-5)  # the band tests/test_chunked.py uses


def _operands(t, lead, s, seed):
    """Realistic v7 operands: bounded decay, a = -kk, b = kk * gate."""
    rng = np.random.RandomState(seed)
    shape = (t, *lead, s)
    r, k, v = (rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3))
    w = np.exp(-0.606531 / (1 + np.exp(-rng.randn(*shape).astype(np.float32))))
    kk = rng.randn(*shape).astype(np.float32)
    kk /= np.linalg.norm(kk, axis=-1, keepdims=True)
    ag = 1 / (1 + np.exp(-rng.randn(*shape).astype(np.float32)))
    s0 = rng.randn(*lead[:-1], lead[-1], s, s).astype(np.float32) * 0.3
    return s0, [r, w.astype(np.float32), k, v, -kk, (kk * ag).astype(np.float32)]


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("rank", [3, 4])
def test_wkv7_auto_matches_jax_pallas_interpret(t, rank):
    """CPU dispatch (chunked form) against the TPU kernel, run in interpret
    mode, on the same operands; batch is folded into its head dim."""
    h, s = 4, 32
    lead = (h,) if rank == 3 else (2, h)
    s0, ops = _operands(t, lead, s, seed=t + rank)
    bh = int(np.prod(lead))
    y_pl, s_pl = wkv7_chunked_pallas(
        jnp.asarray(s0.reshape(bh, s, s)), *(jnp.asarray(x.reshape(t, bh, s)) for x in ops),
        chunk_size=16, interpret=True,
    )
    y, s_new = TC.wkv7_auto(*_t([s0] + ops))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl).reshape(y.shape), **TOL)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_pl).reshape(s_new.shape), **TOL)


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("rank", [3, 4])
def test_wkv7_chunked_and_scan_match_jax_scan(t, rank):
    lead = (3,) if rank == 3 else (2, 3)
    s0, ops = _operands(t, lead, 16, seed=7 * t + rank)
    y_ref, s_ref = j_scan(jnp.asarray(s0), *(jnp.asarray(x) for x in ops))
    y_scan, s_scan = wkv7_scan(*_t([s0] + ops))
    np.testing.assert_allclose(y_scan.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_scan.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-6)
    s0b, opsb = (s0, ops) if rank == 4 else (s0[None], [x[:, None] for x in ops])
    y_chk, s_chk = TC.wkv7_chunked(*_t([s0b] + opsb), chunk_size=16)
    np.testing.assert_allclose(y_chk.numpy().reshape(y_ref.shape), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s_chk.numpy().reshape(s_ref.shape), np.asarray(s_ref), **TOL)


def test_wkv7_auto_falls_back_to_scan_and_p32_rule():
    s0, ops = _operands(30, (2,), 8, seed=1)
    y, _ = TC.wkv7_auto(*_t([s0] + ops))
    y_ref, _ = wkv7_scan(*_t([s0] + ops))
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    s0, ops = _operands(1024, (1,), 8, seed=2)
    y, s_new = TC.wkv7_auto(*_t([s0] + ops))
    y32, s32 = TC.wkv7_chunked(*_t([s0[None]] + [x[:, None] for x in ops]), chunk_size=32)
    torch.testing.assert_close(y, y32[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(s_new, s32[0], rtol=0, atol=0)


def test_wkv7_recurrence_cpu_is_plain_scan_and_counts_nothing():
    s0, ops = _operands(8, (6,), 32, seed=3)
    before = TC.wkv7_recurrence.launches
    y, s_new = TC.wkv7_recurrence(*_t([s0] + ops))
    y_ref, s_ref = wkv7_scan(*_t([s0] + ops))
    assert TC.wkv7_recurrence.launches == before
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s_new, s_ref, rtol=0, atol=0)
