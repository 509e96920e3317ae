"""The port's ggml-parity quantized matmul (``ops.parity.mm`` on a quantized
``Weight``) against the JAX package's ``mm`` on the same codes: every
format, inputs of rank 1-3, zero blocks, q8_K's ties, and rows and
outputs taken in pieces. Band: 2e-6 of sum |x| |W| (the integer block
dots are exact; only the order of the per-block sum differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import parity as JP
from rwkv_tpu_torch.io.quant import dtype_from_name, quantize_rows
from rwkv_tpu_torch.ops import parity as TP

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]
OUT, IN = 96, 512
BAND = 2e-6


def _weights(fmt: str, seed: int = 0):
    w = np.random.default_rng(seed).standard_normal((OUT, IN)).astype(np.float32)
    dtype = dtype_from_name(fmt)
    data = quantize_rows(w, dtype).tobytes()
    return (JP.Weight.from_packed(data, dtype, (OUT, IN)),
            TP.Weight.from_packed(data, dtype, (OUT, IN)))


def _check(x: np.ndarray, jw, tw):
    ref = np.asarray(JP.mm(jnp.asarray(x), jw))
    got = TP.mm(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    scale = np.abs(x) @ np.abs(tw.dense().numpy()).T
    err = np.abs(got.numpy() - ref) / scale.max()
    assert err.max() <= BAND, err.max()
    return got.numpy(), ref


@pytest.mark.parametrize("shape", [(IN,), (5, IN), (3, 2, IN)], ids=["C", "TxC", "TxBxC"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_mm_matches_jax(fmt, shape):
    jw, tw = _weights(fmt)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _check(x, jw, tw)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_mm_zero_blocks(fmt):
    """A zero 32-block (and, for q8_K, a zero 256-block) gives inverse 0 and
    codes 0, no NaN; an all-zero row gives zeros plus nothing else."""
    jw, tw = _weights(fmt, seed=2)
    x = np.random.default_rng(3).standard_normal((3, IN)).astype(np.float32)
    x[0, 32:64] = 0.0
    x[1, 256:512] = 0.0
    x[2] = 0.0
    got, ref = _check(x, jw, tw)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("fmt", ["Q4_K", "Q5_K"])
@pytest.mark.parametrize("first", [1.0, -1.0], ids=["pos_first", "neg_first"])
def test_quant_mm_q8k_equal_magnitudes(fmt, first):
    """Two elements of one 256-block share the largest magnitude with
    opposite signs: the first one sets smax, as with jnp.argmax."""
    jw, tw = _weights(fmt, seed=4)
    x = np.random.default_rng(5).standard_normal((2, IN)).astype(np.float32)
    x[:, 10] = 4.0 * first
    x[:, 200] = -4.0 * first
    x[1, 300] = 3.0
    x[1, 301] = -3.0
    _check(x, jw, tw)


def _pieces_check(fmt, monkeypatch, budget):
    jw, tw = _weights(fmt, seed=6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((70, IN)).astype(np.float32))
    whole = TP.mm(x, tw)
    monkeypatch.setattr(TP, "_QUANT_PIECE_BYTES", budget)
    torch.testing.assert_close(TP.mm(x, tw), whole, rtol=0, atol=0)
    _check(x.numpy(), jw, tw)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_mm_rows_in_pieces_change_no_bits(fmt, monkeypatch):
    # every output in one slab, 16 of the 70 rows a piece
    _pieces_check(fmt, monkeypatch, 2 * OUT * IN * 4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_mm_outputs_in_pieces_change_no_bits(fmt, monkeypatch):
    # slabs of 10 of the 96 outputs (the last one 6), 16 rows a piece
    _pieces_check(fmt, monkeypatch, 2 * 10 * IN * 4)


def test_quant_mm_pieces_stay_within_the_budget(monkeypatch):
    """The float32 codes a call converts at once stay within half of
    _QUANT_PIECE_BYTES and the block dots within a quarter."""
    _, tw = _weights("Q4_K", seed=6)
    budget = 2 * 10 * IN * 4
    monkeypatch.setattr(TP, "_QUANT_PIECE_BYTES", budget)
    seen = []
    block_dots = TP._block_dots

    def spy(q_x, wq):
        p = block_dots(q_x, wq)
        seen.append((wq.numel() * 4, p.numel() * 4))
        return p

    monkeypatch.setattr(TP, "_block_dots", spy)
    TP.mm(torch.ones(70, IN), tw)
    assert len(seen) == 10 * 5  # 10 slabs of outputs x 5 pieces of rows
    assert max(c for c, _ in seen) <= budget // 2
    assert max(d for _, d in seen) <= budget // 4


@pytest.mark.parametrize("fmt", ["Q5_1", "Q4_K"])
def test_weight_to_device_keeps_codes(fmt):
    _, tw = _weights(fmt, seed=8)
    moved = tw.to("cpu")
    assert (moved.kind, moved.fmt, moved.q8_1_act, moved.q8_k_act) == (
        tw.kind, tw.fmt, tw.q8_1_act, tw.q8_k_act)
    for name in ("q", "d", "m"):
        a, b = getattr(tw, name), getattr(moved, name)
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_fp16_round_and_roundf_match_jax():
    x = np.random.default_rng(9).standard_normal(4096).astype(np.float32) * 1e3
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, 65520.0, 1e-8, 0.0]
    np.testing.assert_array_equal(TP._fp16_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(JP._fp16_round(jnp.asarray(x))))
    np.testing.assert_array_equal(TP._roundf(torch.from_numpy(x)).numpy(),
                                  np.asarray(JP._roundf(jnp.asarray(x))))
