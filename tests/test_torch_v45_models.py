"""The port's RWKV-4 and RWKV-5 (v5.1, v5.2) graph against the JAX package:
wkv4_scan and its trace, att_v4 / att_v5 with trace=True, the f32 forward
over T = 1, 16 and 48 tokens, and weight conversion of v4 and v5.1 trees
(1-D time_first / time_decay)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models import state as JS
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models import graph as TG
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from test_torch_models import jax_tree_to_numpy

VERSIONS = ("4.0", "5.1", "5.2")
TOL = dict(rtol=1e-4, atol=1e-5)


def _small(version):
    return (version, 2, 256, 256, 64)  # L, C, V, S (v5: H = 4)


@pytest.fixture(scope="module", params=VERSIONS)
def model45(request):
    jc, tc = j_synth_config(*_small(request.param)), synth_config(*_small(request.param))
    jp = j_synth_params(jc, seed=4)
    return jc, tc, jp, params_from_numpy(tc, jax_tree_to_numpy(jp))


def test_params_from_numpy_v45_tree_equals_port_synth(model45):
    """The converted tree equals the port's own synth leaf for leaf, as
    float32; v4's time_first / time_decay are [C], v5.1's per-head [H]."""
    _, tc, _, tp = model45
    own = synth_params(tc, seed=4)
    for got, ref in zip(tp["blocks"], own["blocks"]):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    first = tp["blocks"][0]
    if tc.version_major == 4:
        assert first["att.time_first"].shape == first["att.time_decay"].shape == (tc.n_embed,)
    elif tc.version_minor == 1:
        assert first["att.time_first"].shape == first["att.time_decay"].shape == (tc.head_count,)
    else:
        assert first["att.time_faaaa"].shape == (tc.head_count, tc.head_size)


def _wkv4_operands(t, c, seed, lead=()):
    rng = np.random.default_rng(seed)
    tf = rng.standard_normal(c).astype(np.float32) * 0.3
    td = (-np.abs(rng.standard_normal(c)) - 0.1).astype(np.float32)
    k, v = (rng.standard_normal((t, *lead, c)).astype(np.float32) for _ in range(2))
    aa = rng.standard_normal((*lead, c)).astype(np.float32)
    bb = (np.abs(rng.standard_normal((*lead, c))) + 0.5).astype(np.float32)
    pp = rng.standard_normal((*lead, c)).astype(np.float32)
    return tf, td, k, v, aa, bb, pp


@pytest.mark.parametrize("n_tokens", [1, 16, 48])
def test_wkv4_scan_and_trace_match_jax(n_tokens):
    ops = _wkv4_operands(n_tokens, 32, seed=n_tokens)
    ref = JG.wkv4_scan(*(jnp.asarray(x) for x in ops))
    got = TG.wkv4_scan(*(torch.from_numpy(x) for x in ops))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    ref_t = JG.wkv4_scan_trace(*(jnp.asarray(x) for x in ops))
    got_t = TG.wkv4_scan_trace(*(torch.from_numpy(x) for x in ops))
    for g, r in zip(got_t, ref_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    for g_all, g_last in zip(got_t[1:], got[1:]):
        torch.testing.assert_close(g_all[-1], g_last, rtol=0, atol=0)


@pytest.mark.parametrize("n_tokens", [1, 16, 48])
def test_v45_f32_forward_matches_jax(model45, n_tokens):
    jc, tc, jp, tp = model45
    rng = np.random.default_rng(n_tokens)
    s0 = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in JS.init_state(jc).items()}
    toks = rng.integers(0, tc.n_vocab, n_tokens).astype(np.int32)
    jl, js = JG.forward(jp, {k: jnp.asarray(v) for k, v in s0.items()}, jnp.asarray(toks), jc)
    tl, ts = TG.forward(tp, {k: torch.from_numpy(v) for k, v in s0.items()},
                        torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert ts.keys() == js.keys()
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), err_msg=k, **TOL)


def test_v45_f32_forward_from_blank_state_matches_jax(model45):
    """From the blank state (v4: pp = -1e30): finite and equal to JAX's."""
    jc, tc, jp, tp = model45
    toks = np.arange(5, 21, dtype=np.int32)
    jl, js = JG.forward(jp, JS.init_state(jc), jnp.asarray(toks), jc)
    s0 = {k: torch.from_numpy(np.array(v)) for k, v in JS.init_state(jc).items()}
    tl, ts = TG.forward(tp, s0, torch.from_numpy(toks).long(), tc)
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), err_msg=k, **TOL)


def test_v45_att_trace_matches_jax(model45):
    """att_v4 / att_v5 (trace=True): the output, new state and the
    per-position states equal JAX's."""
    jc, tc, jp, tp = model45
    rng = np.random.default_rng(8)
    c = tc.n_embed
    x = rng.standard_normal((6, c)).astype(np.float32)
    xx = rng.standard_normal(c).astype(np.float32)
    if tc.version_major == 4:
        aa, bb, pp = _wkv4_operands(1, c, seed=3)[4:]
        args = (xx, aa, bb, pp)
        j_out = JG.att_v4(jp["blocks"][1], jnp.asarray(x), *(jnp.asarray(a) for a in args),
                          trace=True)
        t_out = TG.att_v4(tp["blocks"][1], torch.from_numpy(x),
                          *(torch.from_numpy(a) for a in args), trace=True)
        n_state = 5
    else:
        heads = rng.standard_normal((tc.head_count, 64, 64)).astype(np.float32) * 0.1
        j_out = JG.att_v5(jp["blocks"][1], jnp.asarray(x), jnp.asarray(xx), jnp.asarray(heads),
                          jc, trace=True)
        t_out = TG.att_v5(tp["blocks"][1], torch.from_numpy(x), torch.from_numpy(xx),
                          torch.from_numpy(heads), tc, trace=True)
        n_state = 3
    got = list(t_out[:n_state]) + list(t_out[n_state])
    ref = list(j_out[:n_state]) + list(j_out[n_state])
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_v5_mix_keeps_the_reference_op_order():
    """_mix is x*c + (prev - prev*c), not prev + (x - prev)*c: the two
    round differently, and a last-bit difference flips int8 codes."""
    rng = np.random.default_rng(1)
    x, prev, c = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    ref = np.asarray(JG._mix(jnp.asarray(x), jnp.asarray(prev), jnp.asarray(c)))
    got = TG._mix(*(torch.from_numpy(a) for a in (x, prev, c))).numpy()
    np.testing.assert_array_equal(got, ref)
    other = (torch.from_numpy(prev) + (torch.from_numpy(x) - torch.from_numpy(prev))
             * torch.from_numpy(c)).numpy()
    assert not np.array_equal(other, ref)
