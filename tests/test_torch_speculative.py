"""Speculative decoding in the port against the JAX package, on the CPU:
``forward_stacked_trace``, ``ServingModel.score`` / ``score_trace``, the
fused v7 dense path, ``models/speculative.py`` and one-layer v7 serving.

Trees: a v7 target (L=2, C=128, V=256, S=32) with a v7 draft (L=2, C=64),
and v6 / v5.2 / v4 targets at L=2, C=128-256, drawn from numpy seeds (the
port's ``synth_params`` gives the JAX package's weights bit for bit). Both
sides start from the same state: the port's prefill, handed to JAX.

Bands, each against the largest value of the reference tensor:
- f32: rtol 1e-4 (readings up to 1.5e-6);
- bf16: 5e-3 of the scale (readings: v7 4e-6, v6 4.2e-3, v5.2 1.7e-3: a
  last-bit difference flips the bf16 rounding of an activation, and v6's
  decay amplifies it);
- w8a8: 2e-2 of the scale with equal argmax, the band
  ``test_torch_quant_serve.py`` holds where activations are quantized on
  both sides (readings up to 7e-3, v4: int8 code flips).
The port's fused and unfused v7 stacks agree to rtol 1e-5, and a trace's
states equal ``score``'s and the decode chain's to 1e-5. Greedy
speculative streams equal the target's greedy stream and JAX's, with
JAX's stats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models import speculative as JS
from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.state import init_state as j_init_state
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu_torch.models import serve as TSV
from rwkv_tpu_torch.models import speculative as TS
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.state import init_state
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.utils.sampling import gumbel_noise

TARGETS = {  # version, L, C, V, S
    "7.0": ("7.0", 2, 128, 256, 32),
    "6.0": ("6.0", 2, 256, 256, 64),
    "5.2": ("5.2", 2, 128, 256, 32),
    "4.0": ("4.0", 2, 128, 256, 32),
}
DRAFT = ("7.0", 2, 64, 256, 32)
BANDS = {"f32": 1e-4, "bf16": 5e-3, "w8a8": 2e-2}
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
SEQ = [7, 8, 9, 10, 11]
N_TOKENS, K = 10, 3


def _rel(got, ref) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


def _close(got, ref, band: float, what: str) -> None:
    if band == BANDS["f32"]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=band,
                                   atol=band * float(np.abs(np.asarray(ref)).max()), err_msg=what)
    else:
        r = _rel(got, ref)
        assert r <= band, f"{what}: {r:.3e} of the scale (band {band})"


def _tree(shape, seed):
    kw = {"lora_dim": 32} if shape[0] == "7.0" else {}
    return synth_config(*shape), synth_params(synth_config(*shape), seed=seed, **kw), kw


def _pair(shape, precision, seed=3):
    """(JAX ServingModel, port ServingModel) on the same tree."""
    tc, tp, kw = _tree(shape, seed)
    jc = j_synth_config(*shape)
    return (JServingModel((jc, j_synth_params(jc, seed=seed, **kw)), precision=precision),
            ServingModel((tc, tp), precision=precision, device="cpu"))


def _to_jax(state):
    return {k: jnp.asarray(v.numpy()) for k, v in state.items()}


def _greedy(model, prompt, n):
    logits, state = model.prefill(prompt)
    out = []
    for _ in range(n):
        out.append(int(logits.argmax()))
        lg, state = model.decode([out[-1]], state)
        logits = lg[0]
    return out


@pytest.mark.parametrize("precision", ["f32", "bf16", "w8a8"])
@pytest.mark.parametrize("version", list(TARGETS))
def test_score_and_score_trace_match_jax(version, precision):
    """score on two sequences and score_trace from one prefilled state:
    logits and every trace array within the band, argmax equal."""
    jm, tm = _pair(TARGETS[version], precision)
    _, state = tm.prefill(PROMPT)
    band = BANDS[precision]
    two = {k: torch.cat([v, v]) for k, v in state.items()}
    toks = np.array([SEQ, SEQ[::-1]])
    j_logits, j_state = jm.score(toks, _to_jax(two))
    logits, new_state = tm.score(toks, two)
    assert logits.shape == (2, len(SEQ), tm.config.n_vocab)
    _close(logits, j_logits, band, "score logits")
    for k in j_state:
        _close(new_state[k], j_state[k], band, f"score state {k}")
    j_tl, j_trace = jm.score_trace(SEQ, _to_jax(state))
    tl, trace = tm.score_trace(SEQ, state)
    _close(tl, j_tl, band, "score_trace logits")
    assert sorted(trace) == sorted(j_trace)
    for k in j_trace:
        assert trace[k].shape == j_trace[k].shape, k
        _close(trace[k], j_trace[k], band, f"trace {k}")
    assert logits.argmax(-1).tolist() == np.asarray(j_logits).argmax(-1).tolist()
    assert tl.argmax(-1).tolist() == np.asarray(j_tl).argmax(-1).tolist()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fused_v7_stack_matches_unfused(precision):
    """The fused dense v7 stack (att.rkv.weight, att.lora1 / lora2) against
    the unfused one: forward_stacked over a prompt and the trace pass."""
    tc, tp, _ = _tree(TARGETS["7.0"], 3)
    dtype = torch.float32 if precision == "f32" else torch.bfloat16
    fused = TSV.stack_layer_params(tp, tc, dtype, "dense", "cpu")
    plain = TSV.stack_layer_params(tp, tc, dtype, "dense", "cpu", fuse=False)
    assert fused["blocks"]["att.rkv.weight"].shape == (2, 3, 128, 128)
    assert fused["blocks"]["att.lora1"].shape == (2, 4, 32, 128)
    assert fused["blocks"]["att.lora2"].shape == (2, 4, 128, 32)
    assert "att.receptance.weight" in plain["blocks"] and "att.w1" not in fused["blocks"]
    w8 = TSV.stack_layer_params(tp, tc, torch.bfloat16, "w8a8", "cpu")
    assert "att.rkv.weight" not in w8["blocks"]  # packed leaves stay unfused
    toks = torch.tensor(PROMPT)
    lf, sf = TSV.forward_stacked(fused, init_state(tc, "cpu"), toks, tc, "all")
    lp, sp = TSV.forward_stacked(plain, init_state(tc, "cpu"), toks, tc, "all")
    np.testing.assert_allclose(lf.numpy(), lp.numpy(), rtol=1e-5, atol=1e-5 * float(lp.abs().max()))
    for k in sp:
        np.testing.assert_allclose(sf[k].numpy(), sp[k].numpy(), rtol=1e-5, atol=1e-6)
    tf, trf = TSV.forward_stacked_trace(fused, sf, torch.tensor(SEQ), tc)
    tq, trp = TSV.forward_stacked_trace(plain, sp, torch.tensor(SEQ), tc)
    np.testing.assert_allclose(tf.numpy(), tq.numpy(), rtol=1e-5, atol=1e-5 * float(tq.abs().max()))
    for k in trp:
        np.testing.assert_allclose(trf[k].numpy(), trp[k].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("version", list(TARGETS) + ["5.1"])
def test_trace_states_match_score_and_decode_chain(version):
    """trace[:, -1] equals score's state, trace[:, j] the decode chain's
    state after j+1 tokens, and the trace logits score's (1e-5); every
    version, v5.1 too."""
    tc, tp, _ = _tree(TARGETS.get(version, ("5.1", 2, 128, 256, 32)), 3)
    tm = ServingModel((tc, tp), precision="f32", device="cpu")
    _, st0 = tm.prefill(PROMPT)
    logits, new_state = tm.score([SEQ], st0)
    tl, trace = tm.score_trace(SEQ, st0)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), logits[0].numpy(), **tol)
    st = st0
    for j, tok in enumerate(SEQ):
        _, st = tm.decode([tok], st)
        for k in st:
            np.testing.assert_allclose(trace[k][:, j].numpy(), st[k][0].numpy(), **tol,
                                       err_msg=f"{k} after {j + 1} tokens")
    for k in new_state:
        np.testing.assert_allclose(trace[k][:, -1].numpy(), new_state[k][0].numpy(), **tol)


@pytest.fixture(scope="module")
def spec_models():
    """(JAX, port) target and draft pairs under f32 and w8a8."""
    out = {}
    for precision in ("f32", "w8a8"):
        out[precision] = (_pair(TARGETS["7.0"], precision, 3), _pair(DRAFT, precision, 4))
    return out


@pytest.mark.parametrize("precision", ["f32", "w8a8"])
@pytest.mark.parametrize("loop", ["host", "device"])
def test_greedy_loops_match_jax_and_greedy(spec_models, precision, loop):
    """Weak draft: the target's greedy stream and JAX's stats. Under f32
    also the perfect draft (acceptance 1) and force_accept against JAX;
    under w8a8 those two against the port's own greedy stream and counts."""
    (jt, tt), (jd, td) = spec_models[precision]
    want = _greedy(tt, PROMPT, N_TOKENS)
    j_fn = JS.speculative_generate if loop == "host" else JS.speculative_generate_device
    t_fn = TS.speculative_generate if loop == "host" else TS.speculative_generate_device
    got, stats = t_fn(tt, td, PROMPT, N_TOKENS, k=K)
    j_got, j_stats = j_fn(jt, jd, PROMPT, N_TOKENS, k=K)
    assert got.dtype == np.int32 and got.tolist() == want == np.asarray(j_got).tolist()
    assert stats == j_stats, (stats, j_stats)
    runs = {"perfect": t_fn(tt, tt, PROMPT, N_TOKENS, k=K)}
    perfect, p_stats = runs["perfect"]
    assert perfect.tolist() == want and p_stats["acceptance_rate"] == 1.0
    if loop == "device":
        runs["force_accept"] = t_fn(tt, td, PROMPT, N_TOKENS, k=K, force_accept=True)
        forced, f_stats = runs["force_accept"]
        assert f_stats["acceptance_rate"] == 1.0 and f_stats["rounds"] == -(-N_TOKENS // (K + 1))
        assert forced[0] == want[0]
    if precision != "f32":
        return
    j_runs = {"perfect": lambda: j_fn(jt, jt, PROMPT, N_TOKENS, k=K),
              "force_accept": lambda: j_fn(jt, jd, PROMPT, N_TOKENS, k=K, force_accept=True)}
    for name, (got, stats) in runs.items():
        j_got, j_stats = j_runs[name]()
        assert got.tolist() == np.asarray(j_got).tolist() and stats == j_stats, name


@pytest.mark.parametrize("version", ["6.0", "5.2", "4.0"])
def test_device_loop_on_v4_v5_v6_targets(version):
    """Every version's trace path as the target of the device loop, with
    the v7 draft: the target's greedy stream (6 tokens), from the host
    loop too."""
    tc, tp, _ = _tree(TARGETS[version], 5)
    target = ServingModel((tc, tp), precision="f32", device="cpu")
    dc, dp, _ = _tree(DRAFT, 6)
    draft = ServingModel((dc, dp), precision="f32", device="cpu")
    want = _greedy(target, PROMPT, 6)
    got, stats = TS.speculative_generate_device(target, draft, PROMPT, 6, k=K)
    assert got.tolist() == want and stats["rounds"] > 0
    got, _ = TS.speculative_generate(target, draft, PROMPT, 6, k=K)
    assert got.tolist() == want


def test_spec_accept_matches_jax_on_jax_noise():
    """_spec_accept fed JAX's uniforms and Gumbel row (from the key split
    JAX's own _spec_accept makes) gives JAX's (j, next_token)."""
    v, k, n = 16, 3, 24
    rs = np.random.RandomState(0)
    p_t = rs.dirichlet(np.ones(v) * 0.5, size=(n, k + 1)).astype(np.float32)
    p_d = rs.dirichlet(np.ones(v) * 0.5, size=(n, k)).astype(np.float32)
    drafts = np.stack([[rs.choice(v, p=p_d[i, r] / p_d[i, r].sum()) for r in range(k)]
                       for i in range(n)]).astype(np.int32)
    drafts[::4] = p_t[::4, :k].argmax(-1)  # likely proposals: full acceptance occurs

    def one(pt, pd, d, key):
        j, nxt = JS._spec_accept(pt, pd, d, key)
        ku, kr = jax.random.split(key)
        return j, nxt, jax.random.uniform(ku, (k,)), jax.random.gumbel(kr, (v,))

    keys = jax.random.split(jax.random.PRNGKey(7), n)
    j_ref, nxt_ref, u, g = (np.asarray(a) for a in jax.jit(jax.vmap(one))(
        jnp.asarray(p_t), jnp.asarray(p_d), jnp.asarray(drafts), keys))
    got = []
    for i in range(n):
        j, nxt = TS._spec_accept(torch.from_numpy(p_t[i]), torch.from_numpy(p_d[i]),
                                 torch.from_numpy(drafts[i]).long(),
                                 uniforms=torch.tensor(u[i]), gumbel=torch.tensor(g[i]))
        got.append((int(j), int(nxt)))
    assert got == list(zip(j_ref.tolist(), nxt_ref.tolist()))
    assert {j for j, _ in got} >= {0, k}


def test_spec_accept_keeps_the_target_distribution():
    """50k independent rounds with noise from a seeded torch.Generator
    (``torch.rand`` and ``gumbel_noise``, as the module draws it): the
    first emitted token follows p_t (total variation < 0.02)."""
    v, k, n = 16, 1, 50000
    rs = np.random.RandomState(0)
    p_t = torch.from_numpy(rs.dirichlet(np.ones(v), size=k + 1).astype(np.float32))
    p_d = torch.from_numpy(rs.dirichlet(np.ones(v), size=k).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    d1 = torch.multinomial(p_d[0], n, replacement=True, generator=gen)
    u = torch.rand(n, k, generator=gen)
    g = gumbel_noise(torch.empty(n, v), gen)
    j, nxt = torch.func.vmap(
        lambda d, uu, gg: TS._spec_accept(p_t, p_d, d[None], uniforms=uu, gumbel=gg))(d1, u, g)
    toks = torch.where(j > 0, d1, nxt)
    emp = torch.bincount(toks, minlength=v).double() / n
    tv = 0.5 * float((emp - p_t[0].double()).abs().sum())
    assert tv < 0.02, tv


def test_sampling_loop_books_and_perfect_draft_accepts():
    """The sampling loop: tokens in range, coherent stats, and a perfect
    draft at temperature 0.05 accepting > 0.9; a weak draft at 0.9 runs
    and books; the same seed gives the same stream."""
    tc, tp, _ = _tree(TARGETS["7.0"], 3)
    target = ServingModel((tc, tp), precision="f32", device="cpu")
    dc, dp, _ = _tree(DRAFT, 4)
    draft = ServingModel((dc, dp), precision="f32", device="cpu")
    toks, stats = TS.speculative_sample_generate_device(target, target, PROMPT, 8, k=3,
                                                        temperature=0.05, seed=0)
    assert toks.shape == (8,) and all(0 <= t < tc.n_vocab for t in toks.tolist())
    assert stats["acceptance_rate"] > 0.9, stats
    toks2, stats2 = TS.speculative_sample_generate_device(target, draft, PROMPT, 8, k=3,
                                                          temperature=0.9, seed=1)
    assert toks2.shape == (8,) and all(0 <= t < tc.n_vocab for t in toks2.tolist())
    assert stats2["rounds"] >= 1 and stats2["drafted"] == 3 * stats2["rounds"]
    assert 0 <= stats2["accepted"] <= stats2["drafted"]
    assert stats2["acceptance_rate"] == stats2["accepted"] / stats2["drafted"]
    again, _ = TS.speculative_sample_generate_device(target, draft, PROMPT, 8, k=3,
                                                     temperature=0.9, seed=1)
    assert again.tolist() == toks2.tolist()
    with pytest.raises(ValueError, match="greedy"):
        TS.speculative_sample_generate_device(target, draft, PROMPT, 4, temperature=0.0)


def test_models_on_two_devices_refused():
    tc, tp, _ = _tree(DRAFT, 4)
    draft = ServingModel((tc, tp), precision="f32", device="cpu")
    draft.device = torch.device("meta")
    target = ServingModel((tc, tp), precision="f32", device="cpu")
    with pytest.raises(ValueError, match="one device"):
        TS.speculative_generate_device(target, draft, PROMPT, 4)


@pytest.mark.parametrize("route", ["f32", "bf16", "w8a8", "w8a8 megakernel"])
def test_one_layer_v7_serves_and_matches_graph_forward(route):
    """A one-layer v7 model (JAX's ServingModel raises KeyError 'att.v1'
    on it) serves in the port: prefill then 4 greedy decode steps against
    JAX's unrolled graph.forward (its v_first=None path) on the leaves JAX
    would serve (``_prepare_weight`` of each: bf16, or w8a8 PackedQuant
    weights), within the precision's band, argmax equal. Readings: f32
    7.8e-7, bf16 1.8e-7, w8a8 1.5e-2 (int8 code flips)."""
    from rwkv_tpu.models.serve import _prepare_weight as j_prepare

    shape = ("7.0", 1, 128, 256, 32)
    precision, mega = route.split()[0], route.endswith("megakernel")
    tc, tp, kw = _tree(shape, 8)
    jc = j_synth_config(*shape)
    jp = j_synth_params(jc, seed=8, **kw)
    dtype = jnp.float32 if precision == "f32" else jnp.bfloat16
    mode = "w8a8" if precision == "w8a8" else "dense"
    jp = {"emb": jnp.asarray(jp["emb"], dtype), "ln0": jp["ln0"], "ln_out": jp["ln_out"],
          "head": j_prepare(jp["head"], dtype, mode),
          "blocks": [{k: j_prepare(v, dtype, mode) for k, v in b.items()} for b in jp["blocks"]]}
    srv = ServingModel((tc, tp), precision=precision, megakernel=mega, device="cpu")
    assert (srv._mega is not None) == mega
    band = BANDS[precision]
    logits, state = srv.prefill(PROMPT)
    j_logits, j_state = JG.forward(jp, j_init_state(jc), jnp.asarray(PROMPT, jnp.int32), jc)
    for step in range(5):
        _close(logits, j_logits, band, f"{route} step {step} logits")
        for k in j_state:
            _close(state[k][0], j_state[k], band, f"{route} step {step} {k}")
        tok = int(np.argmax(np.asarray(j_logits)))
        assert int(logits.argmax()) == tok, step
        lg, state = srv.decode([tok], state)
        logits = lg[0]
        j_logits, j_state = JG.forward(jp, j_state, jnp.asarray([tok], jnp.int32), jc)
