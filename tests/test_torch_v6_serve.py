"""The port's ServingModel on RWKV v6 against the JAX package's: the f32
path against graph.forward, and the w8a8 and w4a8 megakernel routes
(prefill through K1/K5's plain versions, B=1 decode through K6's, B=3
per-op) against JAX's ServingModel, whose B=1 decode runs its v6 kernels
in interpret mode on the CPU (v6_decode_megakernel with the head under
w8a8, v6_decode_megakernel_tiled and the per-op head under w4a8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.state import init_state as j_init_state
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from test_torch_models import jax_tree_to_numpy

SMALL6 = ("6.0", 2, 256, 256, 64)  # version, L, C, V, S (H = 4)
TOL = dict(rtol=2e-2, atol=2e-2)  # int8 codes may flip at .5 under ulp-level differences
# The per-op w8a8 prefill: the two packages' chunked wkv6 forms agree to
# ~1e-5 (both within 1e-5 of a float64 scan), and the next projection's
# int8 activation codes flip at .5 under such differences, over 16-token
# chunks and every layer: logits measured 0.027 apart on the first prompt.
PREFILL_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module")
def models6():
    jc, tc = j_synth_config(*SMALL6), synth_config(*SMALL6)
    jp = j_synth_params(jc, seed=12)
    return jc, tc, jp, params_from_numpy(tc, jax_tree_to_numpy(jp))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), **tol)


@pytest.fixture
def k6_calls(monkeypatch):
    """Counts the calls of K6's plain version, which v6_decode_step takes
    on CPU tensors (the launch counter stays at 0 there)."""
    calls = []
    ref = TM.v6_decode_step_ref

    def counted(*args):
        calls.append(1)
        return ref(*args)

    monkeypatch.setattr(TM, "v6_decode_step_ref", counted)
    return calls


def test_v6_f32_prefill_and_decode_match_graph_forward(models6):
    jc, tc, jp, tp = models6
    srv = ServingModel((tc, tp), precision="f32", device="cpu")
    prompt = np.random.default_rng(0).integers(0, tc.n_vocab, 21)  # buckets 16 + 4 + 1
    logits, state = srv.prefill(prompt)
    j_logits, j_state = JG.forward(jp, j_init_state(jc), jnp.asarray(prompt, jnp.int32), jc)
    _close(logits, j_logits, rtol=1e-4, atol=1e-5)
    for k in j_state:
        _close(state[k][0], j_state[k], rtol=1e-4, atol=1e-5)
    for _ in range(4):
        tok = int(np.argmax(np.asarray(j_logits)))
        assert int(logits.argmax()) == tok
        j_logits, j_state = JG.forward(jp, j_state, jnp.asarray([tok], jnp.int32), jc)
        lg, state = srv.decode([tok], state)
        logits = lg[0]
        _close(logits, j_logits, rtol=1e-4, atol=1e-5)


def _decode_steps(jsrv, srv, j_state, state, first, n_steps):
    """Greedy decode from tokens `first` [B] for n_steps on both engines,
    holding logits and state to TOL; returns the last logits."""
    toks = np.asarray(first)
    for step in range(n_steps):
        j_lg, j_state = jsrv.decode(toks, j_state)
        lg, state = srv.decode(toks, state)
        _close(lg, j_lg, **TOL)
        for k in j_state:
            _close(state[k], j_state[k], **TOL)
        toks = np.asarray(j_lg).argmax(-1)
        assert lg.argmax(-1).tolist() == toks.tolist(), step
    return lg


@pytest.mark.parametrize("precision", ["w8a8", "w4a8"])
def test_v6_megakernel_routes_match_jax(models6, precision, k6_calls):
    """Prefill of 20 tokens (buckets 16 + 4) for three prompts (PREFILL_TOL),
    then, from JAX's prefill states, 4 decode steps at B=1 (K6's plain
    version; JAX's whole-layer kernel with the head under w8a8, its tiled
    kernel and the per-op head under w4a8) and 3 at B=3 (the per-op path in
    both packages)."""
    jc, tc, jp, tp = models6
    jsrv = JServingModel((jc, jp), precision=precision, megakernel=True)
    srv = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    assert srv._mega["version"] == 6 and srv._mega["w4"] == (precision == "w4a8")
    assert srv.params["emb"].dtype == torch.bfloat16  # as JAX stacks it
    rng = np.random.default_rng(3)
    states, j_states, firsts = [], [], []
    for _ in range(3):
        prompt = rng.integers(0, tc.n_vocab, 20)
        j_logits, j_state = jsrv.prefill(prompt)
        logits, state = srv.prefill(prompt)
        _close(logits, j_logits, **PREFILL_TOL)
        for k in j_state:
            _close(state[k], j_state[k], **PREFILL_TOL)
        assert int(logits.argmax()) == int(np.argmax(np.asarray(j_logits)))
        states.append({k: torch.from_numpy(np.array(v)) for k, v in j_state.items()})
        j_states.append(j_state)
        firsts.append(int(np.argmax(np.asarray(j_logits))))
    assert not k6_calls  # prefill is per-op
    _decode_steps(jsrv, srv, j_states[0], states[0], firsts[:1], 4)
    assert len(k6_calls) == 4
    j_state3 = {k: jnp.concatenate([s[k] for s in j_states]) for k in j_states[0]}
    state3 = {k: torch.cat([s[k] for s in states]) for k in states[0]}
    lg = _decode_steps(jsrv, srv, j_state3, state3, firsts, 3)
    assert lg.shape == (3, tc.n_vocab)
    assert len(k6_calls) == 4  # B > 1 never takes K6


def test_v6_b1_decode_is_k6_step_exactly(models6):
    """Under megakernel=True, B=1 decode returns exactly what
    v6_decode_step gives on the serving pack, and a state it leaves
    untouched."""
    _, tc, _, tp = models6
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    _, state = srv.prefill([5, 6, 7, 8])
    before = {k: v.clone() for k, v in state.items()}
    lg, new = srv.decode([9], state)
    ref_lg, ref_new = TM.v6_decode_step(srv._mega, {k: v[0] for k, v in state.items()},
                                        torch.tensor([9]), tc)
    torch.testing.assert_close(lg[0], ref_lg, rtol=0, atol=0)
    for k in ref_new:
        torch.testing.assert_close(new[k][0], ref_new[k], rtol=0, atol=0)
        torch.testing.assert_close(state[k], before[k], rtol=0, atol=0)


def test_v6_stacked_params_keep_maa2_f32_and_quantize_the_weights(models6):
    _, tc, _, tp = models6
    srv = ServingModel((tc, tp), precision="w8a8", device="cpu")
    blocks = srv.params["blocks"]
    assert blocks["att.time_maa_w2"].dtype == torch.float32
    assert blocks["att.time_maa_w2"].shape == (tc.n_layer, 5, tc.n_embed, 32)
    for k in ("att.gate.weight", "ffn.receptance.weight", "att.time_maa_w1",
              "att.time_decay_w1", "att.time_decay_w2"):
        assert blocks[k].q.dtype == torch.int8, k


def test_serving_model_refuses_v4_and_v5():
    """What the port still refuses for v4 and v5 under megakernel=True, in
    every precision (bf16 included, since the bf16 forms of K7 and K8 are
    ported): shapes K7 and K8 cannot take -- a head size above 64 (v5) and
    a width that is no multiple of 16 (v4)."""
    for version, shape in (("5.2", (1, 256, 64, 128)), ("4.0", (1, 72, 64, 8))):
        tc = synth_config(version, *shape)
        params = synth_params(tc, seed=0)
        for precision in ("bf16", "w8a8"):
            with pytest.raises(NotImplementedError, match="megakernel=True"):
                ServingModel((tc, params), precision=precision, megakernel=True, device="cpu")
    tc = synth_config("4.0", 1, 64, 64, 16)
    srv = ServingModel((tc, synth_params(tc, seed=0)), precision="bf16", megakernel=True,
                       device="cpu")
    assert srv._mega["form"] == "bf16" and srv._mega["version"] == 4
