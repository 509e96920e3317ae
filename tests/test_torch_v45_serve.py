"""The port's ServingModel on RWKV-4 and RWKV-5 (v5.1, v5.2) against the
JAX package's: the f32 path against graph.forward, and the w8a8 and w4a8
megakernel routes (prefill per-op through K1's and K5's plain versions or
the log-depth wkv4 scan, B=1 decode through K7's / K8's plain versions,
B=3 per-op) against JAX's ServingModel, whose B=1 decode runs its v4 / v5
kernels in interpret mode on the CPU (the whole-layer kernel with the head
under w8a8, the tiled kernel and the per-op head under w4a8)."""

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
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM
from test_torch_models import jax_tree_to_numpy

VERSIONS = ("4.0", "5.1", "5.2")
TOL = dict(rtol=2e-2, atol=2e-2)  # int8 codes may flip at .5 under ulp-level differences
# The per-op w8a8 prefill: the two packages' wkv forms agree to ~1e-5, and
# the next projection's int8 codes flip at .5 under such differences (as
# on the v6 path, tests/test_torch_v6_serve.py).
PREFILL_TOL = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(scope="module", params=VERSIONS)
def models45(request):
    small = (request.param, 2, 256, 256, 64)
    jc, tc = j_synth_config(*small), synth_config(*small)
    jp = j_synth_params(jc, seed=12)
    return jc, tc, jp, params_from_numpy(tc, jax_tree_to_numpy(jp))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), **tol)


def _step_name(tc):
    return "v5_decode_step_ref" if tc.version_major == 5 else "v4_decode_step_ref"


@pytest.fixture
def b1_calls(monkeypatch, models45):
    """Counts the calls of K7's or K8's plain version, which the kernel
    wrapper takes on CPU tensors (the launch counter stays at 0 there)."""
    calls = []
    name = _step_name(models45[1])
    ref = getattr(TM, name)

    def counted(*args):
        calls.append(1)
        return ref(*args)

    monkeypatch.setattr(TM, name, counted)
    return calls


def test_v45_f32_prefill_and_decode_match_graph_forward(models45):
    jc, tc, jp, tp = models45
    srv = ServingModel((tc, tp), precision="f32", device="cpu")
    prompt = np.random.default_rng(0).integers(0, tc.n_vocab, 21)  # buckets 16 + 4 + 1
    logits, state = srv.prefill(prompt)
    j_logits, j_state = JG.forward(jp, j_init_state(jc), jnp.asarray(prompt, jnp.int32), jc)
    _close(logits, j_logits, rtol=1e-4, atol=1e-5)
    assert state.keys() == j_state.keys()
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
def test_v45_megakernel_routes_match_jax(models45, precision, b1_calls):
    """Prefill of 20 tokens (buckets 16 + 4) for three prompts
    (PREFILL_TOL), then, from JAX's prefill states, 3 decode steps at B=1
    (K7's / K8's plain version against JAX's kernels) and 2 at B=3 (the
    per-op path in both packages)."""
    jc, tc, jp, tp = models45
    jsrv = JServingModel((jc, jp), precision=precision, megakernel=True)
    srv = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    assert srv._mega["version"] == tc.version_major and srv._mega["w4"] == (precision == "w4a8")
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
    assert not b1_calls  # prefill is per-op
    _decode_steps(jsrv, srv, j_states[0], states[0], firsts[:1], 3)
    assert len(b1_calls) == 3
    j_state3 = {k: jnp.concatenate([s[k] for s in j_states]) for k in j_states[0]}
    state3 = {k: torch.cat([s[k] for s in states]) for k in states[0]}
    lg = _decode_steps(jsrv, srv, j_state3, state3, firsts, 2)
    assert lg.shape == (3, tc.n_vocab)
    assert len(b1_calls) == 3  # B > 1 never takes K7 / K8


def test_v45_b1_decode_is_the_kernel_step_exactly(models45):
    """Under megakernel=True, B=1 decode returns exactly what the kernel
    wrapper gives on the serving pack, and leaves its input state as is."""
    _, tc, _, tp = models45
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    _, state = srv.prefill([5, 6, 7, 8])
    before = {k: v.clone() for k, v in state.items()}
    lg, new = srv.decode([9], state)
    step = TM.v5_decode_step if tc.version_major == 5 else TM.v4_decode_step
    ref_lg, ref_new = step(srv._mega, {k: v[0] for k, v in state.items()}, torch.tensor([9]), tc)
    torch.testing.assert_close(lg[0], ref_lg, rtol=0, atol=0)
    for k in ref_new:
        torch.testing.assert_close(new[k][0], ref_new[k], rtol=0, atol=0)
        torch.testing.assert_close(state[k], before[k], rtol=0, atol=0)


def test_v45_stacked_params_keep_vectors_f32_and_quantize_the_weights(models45):
    """Under w8a8 the matrices become int8 rows (K1); the decay and bonus
    vectors (v4's [C], v5.1's per-head scalars, v5.2's [H, S]) and the mixes
    stay float32."""
    _, tc, _, tp = models45
    blocks = ServingModel((tc, tp), precision="w8a8", device="cpu").params["blocks"]
    mats = ["att.key.weight", "att.value.weight", "att.receptance.weight", "att.output.weight",
            "ffn.key.weight", "ffn.value.weight", "ffn.receptance.weight"]
    if tc.version == "5.2":
        mats.append("att.gate.weight")
    for k in mats:
        assert blocks[k].q.dtype == torch.int8, k
    for k, v in blocks.items():
        if k not in mats:
            assert isinstance(v, torch.Tensor) and v.dtype == torch.float32, k
    if tc.version_major == 4:
        assert blocks["att.time_first"].shape == (tc.n_layer, tc.n_embed)
    elif tc.version_minor == 1:
        assert blocks["att.time_decay"].shape == (tc.n_layer, tc.head_count)
