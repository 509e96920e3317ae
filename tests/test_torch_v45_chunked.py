"""The port's v4 prefill (wkv4_parallel, a log-depth scan in plain PyTorch,
and its wkv4_auto dispatch) against the JAX package's wkv4_parallel /
wkv4_auto and against the token scan wkv4_scan, from the blank state
(pp = -1e30) and from a random one; and the v5 prefill through wkv6_auto
with a static decay (v5.2's [H, S], v5.1's per-head scalars broadcast)
against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import chunked as JC
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models import graph as TG
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import chunked as TC
from test_torch_models import jax_tree_to_numpy

TOL = dict(rtol=1e-4, atol=1e-5)
# JAX's forms jitted: one XLA compilation a shape instead of one an op
j_wkv4_auto = jax.jit(JC.wkv4_auto)
j_wkv4_parallel = jax.jit(JC.wkv4_parallel)


def _operands(t, c, seed, lead=(), state="random", k_scale=1.0):
    """tf, td [C]; k, v [T, *lead, C]; aa, bb, pp [*lead, C]: the blank
    state (0, 0, -1e30) or a random one."""
    rng = np.random.default_rng(seed)
    tf = rng.standard_normal(c).astype(np.float32) * 0.3
    td = (-np.abs(rng.standard_normal(c)) - 0.1).astype(np.float32)
    k = (rng.standard_normal((t, *lead, c)) * k_scale).astype(np.float32)
    v = rng.standard_normal((t, *lead, c)).astype(np.float32)
    if state == "blank":
        aa = np.zeros((*lead, c), np.float32)
        bb = np.zeros((*lead, c), np.float32)
        pp = np.full((*lead, c), -1e30, np.float32)
    else:
        aa = rng.standard_normal((*lead, c)).astype(np.float32)
        bb = (np.abs(rng.standard_normal((*lead, c))) + 0.5).astype(np.float32)
        pp = rng.standard_normal((*lead, c)).astype(np.float32)
    return tf, td, k, v, aa, bb, pp


def _check(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("state", ["blank", "random"])
@pytest.mark.parametrize("t", [2, 16, 37, 256])
def test_wkv4_auto_matches_jax_and_the_scan(t, state):
    """wkv, aa, bb, pp of the log-depth scan against JAX's associative
    scan and against the token scan (1e-4)."""
    ops = _operands(t, 64, seed=t, state=state)
    got = TC.wkv4_auto(*(torch.from_numpy(x) for x in ops))
    _check(got, j_wkv4_auto(*(jnp.asarray(x) for x in ops)))
    _check(got, TG.wkv4_scan(*(torch.from_numpy(x) for x in ops)))


@pytest.mark.parametrize("state", ["blank", "random"])
def test_wkv4_parallel_batched_matches_jax(state):
    """Time-major batched operands [T, B, C] with a [B, C] state."""
    ops = _operands(48, 32, seed=5, lead=(3,), state=state)
    got = TC.wkv4_parallel(*(torch.from_numpy(x) for x in ops))
    _check(got, j_wkv4_parallel(*(jnp.asarray(x) for x in ops)))
    _check(got, TG.wkv4_scan(*(torch.from_numpy(x) for x in ops)))


def test_wkv4_parallel_keeps_the_max_trick_with_large_keys():
    """Keys of magnitude ~60 overflow exp() without the max-trick; the
    log-depth scan stays finite and equal to the token scan and JAX's.
    atol 1e-4: with weights e^(+-60) a few outputs are differences of
    nearly equal terms, ~2e-5 apart in another order of the sums."""
    ops = _operands(64, 32, seed=9, k_scale=20.0)
    got = TC.wkv4_parallel(*(torch.from_numpy(x) for x in ops))
    tol = dict(rtol=1e-4, atol=1e-4)
    _check(got, TG.wkv4_scan(*(torch.from_numpy(x) for x in ops)), tol)
    _check(got, j_wkv4_parallel(*(jnp.asarray(x) for x in ops)), tol)


def test_wkv4_auto_at_one_token_is_the_scan():
    ops = [torch.from_numpy(x) for x in _operands(1, 16, seed=2)]
    for g, r in zip(TC.wkv4_auto(*ops), TG.wkv4_scan(*ops)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("version", ["5.1", "5.2"])
def test_v5_prefill_through_wkv6_auto_with_static_decay(version):
    """att_v5 over 32 tokens with the prefill dispatch as its recurrence:
    the port's wkv6_auto (the chunked form on the CPU, K5 on the card) fed
    the static decay (v5.1's per-head scalars as an expanded [H, S] view)
    against JAX's att_v5 with its wkv6_auto (1e-4)."""
    jc, tc = j_synth_config(version, 2, 256, 256, 64), synth_config(version, 2, 256, 256, 64)
    jp = j_synth_params(jc, seed=6)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, tc.n_embed)).astype(np.float32)
    xx = rng.standard_normal(tc.n_embed).astype(np.float32)
    heads = rng.standard_normal((tc.head_count, 64, 64)).astype(np.float32) * 0.1
    ref = JG.att_v5(jp["blocks"][0], jnp.asarray(x), jnp.asarray(xx), jnp.asarray(heads), jc,
                    wkv_fn=JC.wkv6_auto)
    got = TG.att_v5(tp["blocks"][0], torch.from_numpy(x), torch.from_numpy(xx),
                    torch.from_numpy(heads), tc, wkv_fn=TC.wkv6_auto)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    scan = TG.att_v5(tp["blocks"][0], torch.from_numpy(x), torch.from_numpy(xx),
                     torch.from_numpy(heads), tc)
    for g, r in zip(got, scan):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)
