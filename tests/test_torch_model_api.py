"""The port's parity engine, ``models.model.RWKVModel(path, device="cpu")``,
against the JAX package's ``RWKVModel`` on synth ggmf files (L=2, C=256,
V=256, seed 3): the API here (getters, ``eval``, ``eval_sequence``,
``eval_sequence_in_chunks`` with 10 tokens in chunks of 4 and its
remainder, ``compute_logits=False``, the flat-state round trip, the error
without a card); every format of every version in
``test_torch_model_formats_v*.py``, one file a version, through
``check_file`` from here.

Bands: FP32 and FP16 within 1e-5 of the scale for logits and state.
Quantized files within QUANT_BAND with equal argmax: last-bit differences
in float32 activations (layer norm and other sums run in another order)
move an int8 activation code across a .5 boundary or an fp16-rounded block
scale across its rounding midpoint, and the flip grows through the layers
(``scripts/probe_torch_parity_flips.py`` finds the first flip of each
case; PERF.md has the readings)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rwkv_tpu.models.model import RWKVModel as JaxModel
from rwkv_tpu.ops.parity import Weight as JWeight
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

REPO = Path(__file__).resolve().parent.parent
FORMATS = ["FP32", "FP16", "Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]
SHAPE = (2, 256, 256, 64)  # L, C, V, S
DENSE_BAND = 1e-5
# about twice the worst logits reading (1.821e-2, v6 Q4_1) of
# scripts/probe_torch_parity_flips.py over 6 seeds x 35 (version, format)
# cases at this size and these 10 tokens (PERF.md)
QUANT_BAND = 4e-2
TOKENS = [int(t) for t in np.random.default_rng(1).integers(0, SHAPE[2], 10)]
_JAX_CACHES: dict = {}


def jax_model(path: str, version: str) -> JaxModel:
    """JAX's RWKVModel on `path`, compiling once per parameter structure:
    the models of one version share one compile cache (``_jit_cache``,
    keyed by T), and each quantized Weight's ``fmt`` (the file format's
    name, part of its pytree but never read by the forward) is blanked, so
    Q4_0 / Q5_0 / Q8_0, Q4_1 / Q5_1 and Q4_K / Q5_K each compile once."""
    jm = JaxModel(path)
    jm.params = jax.tree_util.tree_map(
        lambda w: dataclasses.replace(w, fmt="") if isinstance(w, JWeight) else w,
        jm.params, is_leaf=lambda w: isinstance(w, JWeight))
    jm._jit_cache = _JAX_CACHES.setdefault(version, {})
    return jm


def model_file(tmp_path_factory, version: str, fmt: str) -> str:
    """The synth model of `version` (seed 3) as a ggmf file in `fmt`:
    FP32 / FP16 written directly, the rest quantized from FP32 by the port."""
    d = tmp_path_factory.mktemp(f"v{version}-{fmt}")
    cfg = synth_config(version, *SHAPE)
    params = synth_params(cfg, seed=3)
    if fmt in ("FP32", "FP16"):
        path = str(d / f"{fmt}.bin")
        write_synth_ggmf(cfg, params, path, fmt)
        return path
    src, path = str(d / "FP32.bin"), str(d / f"{fmt}.bin")
    write_synth_ggmf(cfg, params, src)
    quantize_model_file(src, path, fmt, verbose=False)
    return path


def rel(got, ref) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def assert_close(got, ref, band: float, what: str, argmax: bool = False):
    """Logits [V] or a state dict within `band` of the scale (a state key
    by key)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), what
        for k in ref:
            assert tuple(got[k].shape) == tuple(ref[k].shape), (what, k)
            e = rel(got[k], ref[k])
            assert e <= band, f"{what} state {k}: {e:.3e} of the scale, band {band}"
        return
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(ref)), what
    e = rel(got, ref)
    assert e <= band, f"{what}: {e:.3e} of the scale, band {band}"
    if argmax:
        assert int(got.argmax()) == int(np.argmax(ref)), f"{what}: argmax differs"


def check_file(tmp_path_factory, version: str, fmt: str):
    """The synth model of `version` as a `fmt` file through both engines:
    eval_sequence_in_chunks over the first 8 of TOKENS in chunks of 4;
    logits and state within DENSE_BAND (FP32, FP16) or QUANT_BAND with
    equal argmax."""
    path = model_file(tmp_path_factory, version, fmt)
    band = DENSE_BAND if fmt in ("FP32", "FP16") else QUANT_BAND
    jl, js = jax_model(path, version).eval_sequence_in_chunks(TOKENS[:8], chunk_size=4)
    tl, ts = RWKVModel(path, device="cpu").eval_sequence_in_chunks(TOKENS[:8], chunk_size=4)
    assert_close(tl, jl, band, f"v{version} {fmt} logits", band == QUANT_BAND)
    assert_close(ts, js, band, f"v{version} {fmt}")


@pytest.fixture(scope="module")
def v7_pair(tmp_path_factory):
    path = model_file(tmp_path_factory, "7.0", "Q5_1")
    return path, JaxModel(path), RWKVModel(path, device="cpu")


def test_getters_match_jax(v7_pair):
    _, jm, tm = v7_pair
    for name in ("n_vocab", "n_embed", "n_layer", "state_len", "logits_len"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.device == torch.device("cpu")


def test_eval_sequence_and_eval_match_jax(v7_pair):
    """eval_sequence in one pass of 10 tokens, then eval from its state."""
    _, jm, tm = v7_pair
    jl, js = jm.eval_sequence(TOKENS)
    tl, ts = tm.eval_sequence(TOKENS)
    assert_close(tl, jl, QUANT_BAND, "eval_sequence logits", argmax=True)
    assert_close(ts, js, QUANT_BAND, "eval_sequence")
    jl, js = jm.eval(5, js)
    tl, ts = tm.eval(5, ts)
    assert_close(tl, jl, QUANT_BAND, "eval logits", argmax=True)
    assert_close(ts, js, QUANT_BAND, "eval")


def test_compute_logits_false_returns_none_and_the_same_state(v7_pair):
    _, jm, tm = v7_pair
    tl, ts = tm.eval_sequence_in_chunks(TOKENS, chunk_size=4, compute_logits=False)
    jl, js = jm.eval_sequence_in_chunks(TOKENS, chunk_size=4, compute_logits=False)
    assert tl is None and jl is None
    _, ts2 = tm.eval_sequence_in_chunks(TOKENS, chunk_size=4)
    for k in ts:
        torch.testing.assert_close(ts[k], ts2[k], rtol=0, atol=0)
    assert_close(ts, js, QUANT_BAND, "compute_logits=False")
    tl, _ = tm.eval(3, ts, compute_logits=False)
    assert tl is None


def test_chunks_carry_the_state_of_one_pass(v7_pair):
    """Chunks of 4 give what passes of 4, 4 and 2 by hand give, bit for bit,
    and logits only for the last chunk."""
    _, _, tm = v7_pair
    cl, cs = tm.eval_sequence_in_chunks(TOKENS, chunk_size=4)
    st = None
    for i in range(0, len(TOKENS), 4):
        hl, st = tm.eval_sequence(TOKENS[i : i + 4], st, compute_logits=i + 4 >= len(TOKENS))
        assert (hl is None) == (i + 4 < len(TOKENS))
    torch.testing.assert_close(cl, hl, rtol=0, atol=0)
    for k in cs:
        torch.testing.assert_close(cs[k], st[k], rtol=0, atol=0)


def test_empty_sequence_raises(v7_pair):
    _, _, tm = v7_pair
    with pytest.raises(ValueError, match="Sequence length is 0"):
        tm.eval_sequence_in_chunks([])


def test_flat_state_round_trip_matches_jax(v7_pair):
    _, jm, tm = v7_pair
    _, ts = tm.eval_sequence(TOKENS[:4])
    flat = tm.state_to_flat(ts)
    assert flat.dtype == np.float32 and flat.shape == (tm.state_len,)
    back = tm.state_from_flat(flat)
    for k in ts:
        torch.testing.assert_close(back[k], ts[k], rtol=0, atol=0)
    js = jm.state_from_flat(flat)
    np.testing.assert_array_equal(jm.state_to_flat(js), flat)
    # the blank states agree in the flat layout (v4's pp = -1e30 included)
    np.testing.assert_array_equal(tm.state_to_flat(tm.init_state()),
                                  jm.state_to_flat(jm.init_state()))
    # eval from a flat state read back equals eval from the state itself
    a, _ = tm.eval(7, back)
    b, _ = tm.eval(7, ts)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_v4_blank_flat_state_matches_jax(tmp_path_factory):
    path = model_file(tmp_path_factory, "4.0", "FP32")
    jm, tm = JaxModel(path), RWKVModel(path, device="cpu")
    np.testing.assert_array_equal(tm.state_to_flat(tm.init_state()),
                                  jm.state_to_flat(jm.init_state()))


_NO_CARD = r"""
import sys, torch
assert not torch.cuda.is_available()
from rwkv_tpu_torch.models.model import RWKVModel
try:
    RWKVModel(sys.argv[1])
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("RWKVModel ran without a card instead of raising")
m = RWKVModel(sys.argv[1], device="cpu")
assert m.init_state()["att_xx"].device.type == "cpu"
print("ok")
"""


def test_without_a_card_raises_unless_asked_for_cpu(v7_pair):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_CARD, v7_pair[0]], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
