"""The port's w8a8 weights and quantized matmul (kernel K1's plain version)
against the JAX package's quantize_q8_serving and _xla_w8a8_matmul."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import kernels as JK
from rwkv_tpu_torch.ops import kernels as TK
from rwkv_tpu_torch.ops.parity import mm


def _weight(n, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) / np.sqrt(k)
    w[0] = 0.0  # an all-zero row: scale 0, codes 0
    return w


@pytest.mark.parametrize("n,k", [(256, 64), (200, 128), (65, 96)])
def test_quantize_q8_serving_bit_equal_jax(n, k):
    w = _weight(n, k, n + k)
    ref = JK.quantize_q8_serving(jnp.asarray(w), rowwise=True, int8_act=True)
    got = TK.quantize_q8_serving(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.d.dtype == torch.float32
    assert got.shape == (n, k)
    # JAX stores [K, N_pad] and [1, N_pad]; the port [N, K] and [N]
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T[:n])
    np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d)[0, :n])


def test_quantize_q8_serving_rejects_unaligned_in_dim():
    with pytest.raises(ValueError):
        TK.quantize_q8_serving(np.zeros((4, 33), np.float32))


@pytest.mark.parametrize("m", [1, 7, 64])
@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("n", [256, 200])
def test_quant_matmul_plain_matches_xla_w8a8(m, k, n):
    """Same int8 codes, exact integer sums, same epilogue order: equal to
    float32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(m * 1000 + k + n)
    w = _weight(n, k, k * n)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 3.0, (m, 1))).astype(np.float32)
    x[0, :] = 0.0 if m > 1 else x[0, :]  # a zero activation row when M > 1
    ref = np.asarray(JK._xla_w8a8_matmul(
        jnp.asarray(x), JK.quantize_q8_serving(jnp.asarray(w), rowwise=True, int8_act=True)))
    pw = TK.quantize_q8_serving(torch.from_numpy(w))
    got = TK.quant_matmul(torch.from_numpy(x), pw)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    # the integer sum itself is exact: equal codes give equal int32 dots
    x8, _ = TK.quantize_act_plain(torch.from_numpy(x))
    acc_ref = x8.numpy().astype(np.int64) @ pw.q.numpy().astype(np.int64).T
    np.testing.assert_array_equal(TK.int_dot_plain(x8, pw.q).numpy(), acc_ref.astype(np.float32))


def test_quant_matmul_leading_dims_and_mm_dispatch():
    rng = np.random.default_rng(0)
    w = _weight(96, 64, 1)
    pw = TK.quantize_q8_serving(w)
    x = torch.from_numpy(rng.standard_normal((3, 2, 64)).astype(np.float32))
    y = mm(x, pw)
    assert y.shape == (3, 2, 96)
    torch.testing.assert_close(y.reshape(6, 96), TK.quant_matmul_plain(x.reshape(6, 64), pw),
                               rtol=0, atol=0)


def test_quant_matmul_cpu_does_not_count_launches():
    before = TK.quant_matmul.launches
    TK.quant_matmul(torch.ones(2, 32), TK.quantize_q8_serving(np.ones((8, 32), np.float32)))
    assert TK.quant_matmul.launches == before


def test_dense_mm_matches_jax_serving_mm():
    from rwkv_tpu.ops.parity import mm as jmm

    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    np.testing.assert_allclose(mm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(jmm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-6)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    ref = np.asarray(jmm(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16)))
    np.testing.assert_allclose(mm(torch.from_numpy(x), wb).numpy(), ref, rtol=1e-5, atol=1e-5)
