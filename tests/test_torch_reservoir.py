"""The port's ``reservoir.ReservoirRWKV`` against the JAX package's on the
CPU, on synth ggmf files (L=2, C=256, V=256, seed 3) of RWKV v7.0 and v5.2
in FP32 and Q5_1, the same tokens on both sides.

The activation at token t is layer 0's FFN token-shift row after token t.
JAX takes it from a compiled scan of one-token forwards; the port from one
``graph.forward`` pass over the sequence (``ffn_rows=True``). Bands, against
the largest value of the reference: FP32 1e-5; Q5_1 ``QUANT_BAND``
(``test_torch_model_api.py``: a last-bit difference moves an int8
activation code across a .5 boundary). Ridge readouts (``ridge_fit``,
numpy float64 in both packages) are bit-equal on equal activations; fitted
on each side's own activations, coefficients, predictions and ``score``
stay within RIDGE_BAND.

Each JAX instance of one file shares one compiled scan (``_scan_fn``), and
every sequence here has SEQ_LEN tokens, so JAX compiles once a file."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rwkv_tpu.models.model import RWKVModel as JaxModel
from rwkv_tpu.reservoir import reservoir as JR
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models.graph import forward
from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.reservoir import reservoir as TR
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf
from test_torch_model_api import QUANT_BAND
from test_torch_quant_serve import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
SHAPE = (2, 256, 256, 64)  # L, C, V, S
SEQ_LEN = 12
N_SEQ = 6
UNITS = 32
DENSE_BAND = 1e-5
# about twice the worst FP32 reading over task seeds 0-3 and both versions
# at alpha 1e-4 (coefficients 1.54e-6, predictions 1.27e-6 of their scale,
# v5.2); Q5_1 fits are held to QUANT_BAND (readings to 6.7e-4, v7)
RIDGE_BAND = 3e-6
CASES = [("7.0", "FP32"), ("7.0", "Q5_1"), ("5.2", "FP32"), ("5.2", "Q5_1")]
_IDS = [f"v{v}-{f}" for v, f in CASES]
_PAIRS: dict = {}


def pair(tmp_path_factory, version: str, fmt: str):
    """(path, JAX RWKVModel, the port's RWKVModel on the CPU, JAX's scan
    shared by every JAX ReservoirRWKV of the file)."""
    key = (version, fmt)
    if key not in _PAIRS:
        d = tmp_path_factory.mktemp(f"res-v{version}-{fmt}")
        cfg = synth_config(version, *SHAPE)
        src = str(d / "FP32.bin")
        write_synth_ggmf(cfg, synth_params(cfg, seed=3), src)
        path = src
        if fmt != "FP32":
            path = str(d / f"{fmt}.bin")
            quantize_model_file(src, path, fmt, verbose=False)
        jm = JaxModel(path)
        scan = JR.ReservoirRWKV(jm)._build_scan()
        _PAIRS[key] = (path, jm, RWKVModel(path, device="cpu"), scan)
    return _PAIRS[key]


def reservoirs(tmp_path_factory, version, fmt, **kw):
    """A JAX and a port ReservoirRWKV over the same file."""
    _, jm, tm, scan = pair(tmp_path_factory, version, fmt)
    jres = JR.ReservoirRWKV(jm, **kw)
    jres._scan_fn = scan
    return jres, TR.ReservoirRWKV(tm, **kw)


def band(fmt: str) -> float:
    return DENSE_BAND if fmt == "FP32" else QUANT_BAND


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def task(seed: int = 0):
    """N_SEQ sequences of SEQ_LEN tokens; target: the last token / 255."""
    rng = np.random.default_rng(seed)
    xs = [list(rng.integers(0, SHAPE[2], size=SEQ_LEN)) for _ in range(N_SEQ)]
    ys = np.array([[x[-1] / 255.0] for x in xs], dtype=np.float32)
    return xs, ys


@pytest.mark.parametrize("version,fmt", CASES, ids=_IDS)
def test_activations_match_jax(tmp_path_factory, version, fmt):
    jres, tres = reservoirs(tmp_path_factory, version, fmt, units=UNITS)
    xs, _ = task()
    for seq in xs[:2]:
        got, ref = tres.run(seq), jres.run(seq)
        assert got.shape == ref.shape == (SEQ_LEN, UNITS) and got.dtype == np.float32
        assert rel(got, ref) <= band(fmt), rel(got, ref)


@pytest.mark.parametrize("version,fmt", CASES, ids=_IDS)
def test_one_pass_matches_token_by_token_eval(tmp_path_factory, version, fmt):
    """JAX's own check (tests/test_reservoir.py): the activations are the
    first `units` values of the flat state after each token of a
    token-by-token ``eval``; the pass's final state is that run's."""
    _, _, tm, _ = pair(tmp_path_factory, version, fmt)
    tres = TR.ReservoirRWKV(tm, units=UNITS)
    tokens = task()[0][0]
    acts = tres.run(tokens)
    state, expected = tm.init_state(), []
    for t in tokens:
        _, state = tm.eval(int(t), state, compute_logits=False)
        expected.append(tm.state_to_flat(state)[:UNITS])
    assert rel(acts, np.stack(expected)) <= band(fmt)
    for k in state:
        assert rel(tres._reservoir_state[k], state[k]) <= band(fmt), k


@pytest.mark.parametrize("version", ["7.0", "5.2"])
def test_forward_without_ffn_rows_is_unchanged(tmp_path_factory, version):
    """``ffn_rows`` adds a return value and changes nothing else: logits
    and state bit-equal with and without it; the last row is the new
    ffn_xx[0] bit for bit."""
    _, _, tm, _ = pair(tmp_path_factory, version, "FP32")
    tokens = torch.tensor(task()[0][1])
    state = tm.init_state()
    lg, st = forward(tm.params, state, tokens, tm.config)
    lg2, st2, rows = forward(tm.params, state, tokens, tm.config, ffn_rows=True)
    assert torch.equal(lg, lg2)
    assert sorted(st) == sorted(st2) and all(torch.equal(st[k], st2[k]) for k in st)
    assert rows.shape == (SEQ_LEN, SHAPE[1]) and torch.equal(rows[-1], st["ffn_xx"][0])
    assert len(forward(tm.params, state, tokens, tm.config, compute_logits=False)) == 2


def test_ridge_fit_and_r2_bit_equal_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    y = rng.standard_normal((40, 2)).astype(np.float32)
    for use_bias in (True, False):
        jc, jb = JR.ridge_fit(x, y, 1e-3, use_bias)
        tc, tb = TR.ridge_fit(x, y, 1e-3, use_bias)
        np.testing.assert_array_equal(tc, jc)
        assert (tb is None) == (jb is None)
        if tb is not None:
            np.testing.assert_array_equal(tb, jb)
    assert TR.r2_score(y, x[:, :2]) == JR.r2_score(y, x[:, :2])
    assert TR.r2_score(np.ones(4), np.zeros(4)) == 0.0


@pytest.mark.parametrize("version,fmt", [("7.0", "FP32"), ("5.2", "FP32"), ("7.0", "Q5_1")],
                         ids=["v7.0-FP32", "v5.2-FP32", "v7.0-Q5_1"])
def test_ridge_fit_predict_score_match_jax(tmp_path_factory, version, fmt):
    jres, tres = reservoirs(tmp_path_factory, version, fmt, units=UNITS, alpha=1e-4)
    xs, ys = task()
    jres.fit(xs, ys, warmup=2)
    tres.fit(xs, ys, warmup=2)
    assert tres.is_trained
    limit = RIDGE_BAND if fmt == "FP32" else QUANT_BAND
    assert rel(tres._readout_weights, jres._readout_weights) <= limit
    assert rel(tres._readout_bias, jres._readout_bias) <= limit
    got, ref = tres.predict(xs[0]), jres.predict(xs[0])
    assert got.shape == ref.shape == (SEQ_LEN,)
    assert rel(got, ref) <= limit
    assert abs(tres.score(xs, ys) - jres.score(xs, ys)) <= limit


def test_ridge_on_equal_activations_bit_equal_jax(tmp_path_factory):
    """Fed the same activations (JAX's), the port's fit, predict and score
    give JAX's bits: everything past the reservoir is the same numpy."""
    jres, tres = reservoirs(tmp_path_factory, "7.0", "FP32", units=UNITS, alpha=1e-4)
    xs, ys = task(1)
    acts = {tuple(seq): jres.run(seq) for seq in xs}
    tres._get_reservoir_activations = lambda tokens, return_states=False: acts[tuple(tokens)]
    jres.fit(xs, ys, warmup=3)
    tres.fit(xs, ys, warmup=3)
    np.testing.assert_array_equal(tres._readout_weights, jres._readout_weights)
    np.testing.assert_array_equal(tres._readout_bias, jres._readout_bias)
    jres._get_reservoir_activations = tres._get_reservoir_activations
    np.testing.assert_array_equal(tres.predict(xs[2]), jres.predict(xs[2]))
    assert tres.score(xs, ys, warmup=3) == jres.score(xs, ys, warmup=3)
    # one sequence with per-token targets
    y_seq = np.arange(SEQ_LEN, dtype=np.float32) / SEQ_LEN
    jres.fit(xs[0], y_seq, warmup=2)
    tres.fit(xs[0], y_seq, warmup=2)
    np.testing.assert_array_equal(tres._readout_weights, jres._readout_weights)
    assert tres.score(xs[0], y_seq, warmup=2) == jres.score(xs[0], y_seq, warmup=2)


@pytest.mark.parametrize("version,fmt", [("7.0", "FP32"), ("5.2", "Q5_1")],
                         ids=["v7.0-FP32", "v5.2-Q5_1"])
def test_return_states_matches_jax(tmp_path_factory, version, fmt):
    jres, tres = reservoirs(tmp_path_factory, version, fmt, units=UNITS)
    seq = task(2)[0][0]
    jres.reset_state()
    tres.reset_state()
    ja, jflat = jres._get_reservoir_activations(seq, return_states=True)
    ta, tflat = tres._get_reservoir_activations(seq, return_states=True)
    assert tflat.shape == jflat.shape and tflat.dtype == np.float32
    assert rel(ta, ja) <= band(fmt) and rel(tflat, jflat) <= band(fmt)
    np.testing.assert_array_equal(ta[-1], tflat[:UNITS])


@pytest.mark.parametrize("version", ["7.0", "5.2"])
def test_run_without_reset_continues_the_state(tmp_path_factory, version):
    """A second ``run(..., reset_state=False)`` carries on from the first:
    the two halves equal one run of both (within the port), and JAX's."""
    jres, tres = reservoirs(tmp_path_factory, version, "FP32", units=UNITS)
    a, b = task(3)[0][:2]
    first, second = tres.run(a), tres.run(b, reset_state=False)
    whole = TR.ReservoirRWKV(tres.rwkv_model, units=UNITS).run(a + b)
    assert rel(np.concatenate([first, second]), whole) <= DENSE_BAND
    jres.run(a)
    assert rel(second, jres.run(b, reset_state=False)) <= DENSE_BAND
    assert rel(tres.run(b), jres.run(b)) <= DENSE_BAND  # reset by default


def test_empty_sequence_gives_no_rows(tmp_path_factory):
    _, _, tm, _ = pair(tmp_path_factory, "7.0", "FP32")
    tres = TR.ReservoirRWKV(tm, units=UNITS)
    assert tres.run([]).shape == (0, UNITS)


def test_units_above_n_embed_raise(tmp_path_factory):
    _, _, tm, _ = pair(tmp_path_factory, "7.0", "FP32")
    with pytest.raises(ValueError, match="cannot exceed"):
        TR.ReservoirRWKV(tm, units=SHAPE[1] + 1)
    res = TR.ReservoirRWKV(tm)
    assert res.units == SHAPE[1] and res.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="fit"):
        res.predict([1, 2])


_NO_CARD = r"""
import sys, torch
import numpy as np
assert not torch.cuda.is_available()
from rwkv_tpu_torch.reservoir import ESNChatbot, MultiLayerReadout, ReservoirRWKV
for make in (lambda: ReservoirRWKV(sys.argv[1]), lambda: MultiLayerReadout(4),
             lambda: ESNChatbot(sys.argv[1])):
    try:
        make()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("ran without a card instead of raising")
res = ReservoirRWKV(sys.argv[1], units=8, device="cpu")
assert res.run([1, 2, 3]).shape == (3, 8)
m = MultiLayerReadout(4, hidden_layers=[8], device="cpu").fit(np.ones((3, 4)), np.ones(3), 2)
assert m.predict(np.ones((2, 4))).shape == (2,)
ESNChatbot(sys.argv[1], device="cpu")
print("ok")
"""


def test_without_a_card_path_and_readout_raise_unless_asked_for_cpu(tmp_path_factory):
    """ReservoirRWKV(path), MultiLayerReadout() and ESNChatbot(path) run on
    the card by default and raise without one; device="cpu" runs."""
    path = pair(tmp_path_factory, "7.0", "FP32")[0]
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_CARD, path], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
