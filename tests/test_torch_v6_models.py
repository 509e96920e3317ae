"""The port's RWKV v6 (Finch) graph against the JAX package: wkv6_scan and
its trace, the f32 forward over T = 1, 16 and 48 tokens, and weight
conversion of a v6 tree (its 3-D time_maa_w2 included)."""

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

SMALL6 = ("6.0", 2, 256, 256, 64)  # version, L, C, V, S (H = 4)


@pytest.fixture(scope="module")
def model6():
    jc, tc = j_synth_config(*SMALL6), synth_config(*SMALL6)
    jp = j_synth_params(jc, seed=4)
    return jc, tc, jp, params_from_numpy(tc, jax_tree_to_numpy(jp))


def test_params_from_numpy_v6_tree_equals_port_synth(model6):
    """The converted v6 tree equals the port's own synth leaf for leaf,
    the 3-D time_maa_w2 [5, C, d_maa] included."""
    _, tc, _, tp = model6
    own = synth_params(tc, seed=4)
    assert len(tp["blocks"]) == tc.n_layer
    for got, ref in zip(tp["blocks"], own["blocks"]):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    assert tp["blocks"][0]["att.time_maa_w2"].shape == (5, tc.n_embed, 32)
    for k in ("emb", "head"):
        assert torch.equal(tp[k], own[k])


def _wkv6_operands(t, h, s, seed, static_w=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((t, h, s)).astype(np.float32) * 0.3 for _ in range(3))
    wshape = (h, s) if static_w else (t, h, s)
    w = np.exp(-np.exp(rng.standard_normal(wshape).astype(np.float32))).astype(np.float32)
    tf = rng.standard_normal((h, s)).astype(np.float32) * 0.3
    s0 = rng.standard_normal((h, s, s)).astype(np.float32) * 0.2
    return s0, r, k, v, w, tf


@pytest.mark.parametrize("static_w", [False, True])
def test_wkv6_scan_and_trace_match_jax(static_w):
    ops = _wkv6_operands(9, 3, 16, seed=1, static_w=static_w)
    jy, js = JG.wkv6_scan(*(jnp.asarray(x) for x in ops))
    ty, ts = TG.wkv6_scan(*(torch.from_numpy(x) for x in ops))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    jy, jall = JG.wkv6_scan_trace(*(jnp.asarray(x) for x in ops))
    ty, tall = TG.wkv6_scan_trace(*(torch.from_numpy(x) for x in ops))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tall.numpy(), np.asarray(jall), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tall[-1], ts, rtol=0, atol=0)


@pytest.mark.parametrize("n_tokens", [1, 16, 48])
def test_v6_f32_forward_matches_jax(model6, n_tokens):
    jc, tc, jp, tp = model6
    rng = np.random.default_rng(n_tokens)
    s0 = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in JS.init_state(jc).items()}
    toks = rng.integers(0, tc.n_vocab, n_tokens).astype(np.int32)
    jl, js = JG.forward(jp, {k: jnp.asarray(v) for k, v in s0.items()}, jnp.asarray(toks), jc)
    tl, ts = TG.forward(tp, {k: torch.from_numpy(v) for k, v in s0.items()},
                        torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_v6_att_trace_matches_jax(model6):
    """att_v6(trace=True): the per-position state equals JAX's."""
    jc, tc, jp, tp = model6
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, tc.n_embed)).astype(np.float32)
    xx = rng.standard_normal(tc.n_embed).astype(np.float32)
    heads = rng.standard_normal((tc.head_count, 64, 64)).astype(np.float32) * 0.1
    j_out = JG.att_v6(jp["blocks"][1], jnp.asarray(x), jnp.asarray(xx), jnp.asarray(heads), jc,
                      trace=True)
    t_out = TG.att_v6(tp["blocks"][1], torch.from_numpy(x), torch.from_numpy(xx),
                      torch.from_numpy(heads), tc, trace=True)
    for got, ref in zip(t_out[:3] + t_out[3], j_out[:3] + j_out[3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_forward_rejects_unported_versions():
    """What the port refuses: a graph version that no RWKV release has,
    in the graph and in the serving path. (A model file path goes to the
    loader, which reads the version from the file's names.)"""
    from rwkv_tpu_torch.models.config import ModelConfig
    from rwkv_tpu_torch.models.serve import ServingModel

    with pytest.raises(NotImplementedError):
        ServingModel((ModelConfig(64, 64, 1, 3, 0), {"blocks": [{}]}), precision="f32",
                     device="cpu")
    with pytest.raises(FileNotFoundError):
        ServingModel("model.bin", precision="f32", device="cpu")
    tc = synth_config("5.2", 1, 64, 64, 16)
    with pytest.raises(NotImplementedError):
        TG.forward(synth_params(tc, seed=0), {}, torch.tensor([1]),
                   ModelConfig(64, 64, 1, 3, 0))
