"""The port's ServingModel against the JAX package: the f32 path against
graph.forward, and the w8a8 and w4a8 megakernel routes (prefill through
K1/K2's plain versions, B=1 decode through K3's, B>1 through K4's and the
head on K1's) against JAX's ServingModel, whose decode runs its whole-model
kernels in interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.state import init_state as j_init_state
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops.parity import Weight
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.serve import PREFILL_BUCKETS, ServingModel
from rwkv_tpu_torch.models.synth import synth_config

SMALL = ("7.0", 2, 128, 256, 32)  # version, L, C, V, S (H = 4)


def jax_tree_to_numpy(tree):
    def leaf(x):
        return np.asarray(x.w if isinstance(x, Weight) else x, np.float32)

    return {
        "emb": leaf(tree["emb"]),
        "ln0": tuple(leaf(x) for x in tree["ln0"]),
        "ln_out": tuple(leaf(x) for x in tree["ln_out"]),
        "head": leaf(tree["head"]),
        "blocks": [{k: leaf(v) for k, v in b.items()} for b in tree["blocks"]],
    }


@pytest.fixture(scope="module")
def models():
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    jp = j_synth_params(jc, seed=11, lora_dim=32)
    return jc, tc, jp, params_from_numpy(tc, jax_tree_to_numpy(jp))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), **tol)


def test_f32_prefill_decode_and_greedy_stream_match_graph_forward(models):
    jc, tc, jp, tp = models
    srv = ServingModel((tc, tp), precision="f32", device="cpu")
    prompt = np.random.default_rng(0).integers(0, tc.n_vocab, 21)  # buckets 16 + 4 + 1
    logits, state = srv.prefill(prompt)
    j_logits, j_state = JG.forward(jp, j_init_state(jc), jnp.asarray(prompt, jnp.int32), jc)
    _close(logits, j_logits, rtol=1e-4, atol=1e-5)
    for k in j_state:
        _close(state[k][0], j_state[k], rtol=1e-4, atol=1e-5)
    got, ref = [], []
    j_tok = t_tok = None
    for _ in range(8):
        j_tok = int(np.argmax(np.asarray(j_logits)))
        t_tok = int(logits.argmax())
        ref.append(j_tok)
        got.append(t_tok)
        j_logits, j_state = JG.forward(jp, j_state, jnp.asarray([j_tok], jnp.int32), jc)
        lg, state = srv.decode([t_tok], state)
        logits = lg[0]
        _close(logits, j_logits, rtol=1e-4, atol=1e-5)
    assert got == ref


def test_f32_generate_greedy_matches_jax_generate(models):
    jc, tc, jp, tp = models
    prompt = [1, 2, 3, 4, 5]
    j_toks, j_logits, _ = JServingModel((jc, jp), precision="f32").generate(prompt, 6, temperature=0.0)
    toks, logits, state = ServingModel((tc, tp), precision="f32", device="cpu").generate(
        prompt, 6, temperature=0.0)
    assert toks.tolist() == np.asarray(j_toks).tolist()
    _close(logits, j_logits, rtol=1e-4, atol=1e-5)
    assert state["heads"].shape == (1, tc.n_layer, tc.head_count, tc.head_size, tc.head_size)


def test_generate_sampling_is_seeded(models):
    _, tc, _, tp = models
    srv = ServingModel((tc, tp), precision="f32", device="cpu")
    a, _, _ = srv.generate([7, 8], 5, temperature=1.0, seed=3)
    b, _, _ = srv.generate([7, 8], 5, temperature=1.0, seed=3)
    assert a.tolist() == b.tolist()
    assert all(0 <= t < tc.n_vocab for t in a)


def test_w8a8_megakernel_route_matches_jax(models):
    """Prefill of 20 tokens (buckets 16 + 4), then 4 decode steps at B=1."""
    jc, tc, jp, tp = models
    jsrv = JServingModel((jc, jp), precision="w8a8", megakernel=True)
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    assert srv.params["emb"].dtype == torch.bfloat16  # as JAX stacks it
    prompt = np.random.default_rng(1).integers(0, tc.n_vocab, 20)
    assert sum(b for b in (16, 4)) == 20 and {16, 4} <= set(PREFILL_BUCKETS)
    j_logits, j_state = jsrv.prefill(prompt)
    logits, state = srv.prefill(prompt)
    tol = dict(rtol=2e-2, atol=2e-2)
    _close(logits, j_logits, **tol)
    for step in range(4):
        tok = int(np.argmax(np.asarray(j_logits)))
        assert int(logits.argmax()) == tok, step
        j_lg, j_state = jsrv.decode(np.array([tok]), j_state)
        lg, state = srv.decode(np.array([tok]), state)
        j_logits, logits = np.asarray(j_lg)[0], lg[0]
        _close(logits, j_logits, **tol)
        for k in j_state:
            _close(state[k], j_state[k], **tol)
    assert int(logits.argmax()) == int(np.argmax(j_logits))


def test_w8a8_batched_decode_matches_jax_per_op(models):
    """B=2 decode without the megakernel takes the per-op path (K1's plain
    version)."""
    jc, tc, jp, tp = models
    jsrv = JServingModel((jc, jp), precision="w8a8")
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=False, device="cpu")
    j_state, state = jsrv.init_state(2), srv.init_state(2)
    toks = np.array([[3, 9], [100, 4], [5, 5]])
    for row in toks:
        j_lg, j_state = jsrv.decode(row, j_state)
        lg, state = srv.decode(row, state)
        _close(lg, j_lg, rtol=2e-2, atol=2e-2)
    assert lg.shape == (2, tc.n_vocab)


def test_bf16_prefill_matches_jax(models):
    jc, tc, jp, tp = models
    prompt = list(range(10, 26))
    j_logits, _ = JServingModel((jc, jp), precision="bf16").prefill(prompt)
    logits, _ = ServingModel((tc, tp), precision="bf16", device="cpu").prefill(prompt)
    _close(logits, j_logits, rtol=2e-2, atol=2e-2)


def test_serving_model_rejects_unported_options(models):
    """What is still refused: an unknown precision (ValueError); mm on a
    quantized file's Weight, which needs the ggml-parity matmul that is not
    ported (a dense one runs); a model file path goes to the loader (a
    missing one raises there)."""
    _, tc, _, tp = models
    with pytest.raises(ValueError, match="precision"):
        ServingModel((tc, tp), precision="fp8", megakernel=True, device="cpu")
    from rwkv_tpu_torch.ops.parity import Weight as TWeight, mm as t_mm

    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, (4, 2, 32)).astype(np.int8)
    quant = TWeight.from_codes(codes, np.ones((4, 2), np.float32), None, "Q4_0")
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    with pytest.raises(NotImplementedError, match="_quant_matmul"):
        t_mm(x, quant)
    dense = TWeight(kind="dense", w=quant.dense())
    torch.testing.assert_close(t_mm(x, dense), x @ quant.dense().T, rtol=1e-6, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        ServingModel("model.bin", precision="w8a8", device="cpu")


def _decode_steps(jsrv, srv, j_state, state, first, n_steps, tol):
    """Greedy decode from tokens `first` [B] for n_steps on both engines,
    holding logits and state to `tol`; returns the last logits."""
    toks = np.asarray(first)
    for step in range(n_steps):
        j_lg, j_state = jsrv.decode(toks, j_state)
        lg, state = srv.decode(toks, state)
        _close(lg, j_lg, **tol)
        for k in j_state:
            _close(state[k], j_state[k], **tol)
        toks = np.asarray(j_lg).argmax(-1)
        assert lg.argmax(-1).tolist() == toks.tolist(), step
    return lg


def test_w4a8_megakernel_route_matches_jax(models):
    """Prefill 20 tokens, then 4 decode steps at B=1 (K3's w4 path) and at
    B=2 (K4's; JAX runs its phase-tiled kernel with lane-packed state)."""
    jc, tc, jp, tp = models
    jsrv = JServingModel((jc, jp), precision="w4a8", megakernel=True)
    srv = ServingModel((tc, tp), precision="w4a8", megakernel=True, device="cpu")
    assert srv._mega["w4"] and srv._mega_k3
    tol = dict(rtol=2e-2, atol=2e-2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tc.n_vocab, 20), rng.integers(0, tc.n_vocab, 20)]
    states, j_states, firsts = [], [], []
    for prompt in prompts:
        j_logits, j_state = jsrv.prefill(prompt)
        logits, state = srv.prefill(prompt)
        _close(logits, j_logits, **tol)
        states.append(state)
        j_states.append(j_state)
        firsts.append(int(np.argmax(np.asarray(j_logits))))
    _decode_steps(jsrv, srv, j_states[0], states[0], firsts[:1], 4, tol)
    j_state2 = {k: jnp.concatenate([s[k] for s in j_states]) for k in j_states[0]}
    state2 = {k: torch.cat([s[k] for s in states]) for k in states[0]}
    lg = _decode_steps(jsrv, srv, j_state2, state2, firsts, 4, tol)
    assert lg.shape == (2, tc.n_vocab)


@pytest.mark.parametrize("batch", [2, 4])
def test_w8a8_megakernel_batched_route_matches_jax(models, batch):
    """B>1 under megakernel=True goes through K4 and the head on K1 at M=B;
    JAX with mega_min_batch = 2 runs its lane-packed batched kernel."""
    jc, tc, jp, tp = models
    jsrv = JServingModel((jc, jp), precision="w8a8", megakernel=True)
    jsrv.mega_min_batch = 2
    srv = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    assert srv.mega_min_batch == 2
    tol = dict(rtol=2e-2, atol=2e-2)
    firsts = np.random.default_rng(batch).integers(0, tc.n_vocab, batch)
    lg = _decode_steps(jsrv, srv, jsrv.init_state(batch), srv.init_state(batch), firsts, 3, tol)
    assert lg.shape == (batch, tc.n_vocab)
