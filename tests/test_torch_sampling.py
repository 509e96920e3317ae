"""The port's sampler against the JAX package's ``utils/sampling.py``: the
numpy copies draw the same tokens from the same ``default_rng``, the
penalties are equal, and the torch ``device_sample`` picks JAX's tokens --
greedy, and sampled when it is fed the Gumbel noise that
``jax.random.categorical`` adds -- in the top-k and full-vocabulary paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.utils import sampling as JS
from rwkv_tpu_torch.utils import sampling as TS


def _logits(seed, shape, scale):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


@pytest.mark.parametrize("kw", [
    dict(temperature=1.0, top_p=0.8),
    dict(temperature=0.7, top_p=0.5, top_k=20),
    dict(temperature=1.3, top_p=0.0, logit_bias={3: 2.0, 40: -1.0}),
    dict(temperature=0.0, top_p=0.9),
])
def test_numpy_sampler_draws_jax_tokens_from_same_rng(kw):
    logits = _logits(0, (64,), 3.0)
    np.testing.assert_array_equal(TS.softmax(logits), JS.softmax(logits))
    r_j, r_t = np.random.default_rng(5), np.random.default_rng(5)
    got = [TS.sample_logits(logits, rng=r_t, **kw) for _ in range(20)]
    ref = [JS.sample_logits(logits, rng=r_j, **kw) for _ in range(20)]
    assert got == ref


def test_penalties_equal_jax():
    logits = _logits(1, (3, 50), 2.0)
    counts = {4: 2, 17: 1, 49: 5}
    np.testing.assert_array_equal(TS.apply_penalties(logits[0], counts, 0.4, 0.25),
                                  JS.apply_penalties(logits[0], counts, 0.4, 0.25))
    cnt = np.zeros((3, 50), np.float32)
    cnt[0, [4, 17, 49]] = [2, 1, 5]  # row 0 holds `counts`
    cnt[2, 3] = 5
    pres, freq = np.array([0.4, 0.0, 1.0], np.float32), np.array([0.25, 0.5, 0.1], np.float32)
    got = TS.device_penalized_logits(*(torch.from_numpy(a) for a in (logits, cnt, pres, freq)))
    ref = JS.device_penalized_logits(*(jnp.asarray(a) for a in (logits, cnt, pres, freq)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the batched form agrees with the host form row by row (float rounding)
    np.testing.assert_allclose(got.numpy()[0], TS.apply_penalties(logits[0], counts, 0.4, 0.25),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_k", [0, 16])
def test_device_sample_greedy_equal_jax(top_k):
    logits = _logits(2, (6, 96), 4.0)
    zt, p = np.zeros(6, np.float32), np.full(6, 0.7, np.float32)
    ref = JS.device_sample(jnp.asarray(logits), jnp.asarray(zt), jnp.asarray(p),
                           jax.random.PRNGKey(0), top_k=top_k)
    got = TS.device_sample(torch.from_numpy(logits), torch.from_numpy(zt), torch.from_numpy(p),
                           torch.Generator().manual_seed(0), top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("top_k", [0, 16])
def test_device_sample_token_equal_jax_given_its_gumbel_noise(top_k):
    """Fed the noise JAX's categorical draws from the same key, the port's
    sampler picks JAX's tokens. top_p 0.75 at this logit scale keeps every
    row's nucleus inside k = 16 (where JAX keeps the ADVICE fault out of
    play), temperatures 0 to 1.5 cover greedy and sampled rows."""
    b, v = 6, 96
    logits = _logits(3, (b, v), 4.0)
    temp = np.array([0.8, 1.0, 0.0, 1.5, 0.5, 1.0], np.float32)
    top_p = np.array([0.75, 0.75, 0.75, 0.0, 0.75, 1.0], np.float32)
    width = top_k if top_k else v
    for trial in range(6):
        key = jax.random.PRNGKey(trial)
        ref = JS.device_sample(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p), key,
                               top_k=top_k)
        gumbel = np.array(jax.random.gumbel(key, (b, width), jnp.float32))
        got = TS.device_sample(torch.from_numpy(logits), torch.from_numpy(temp),
                               torch.from_numpy(top_p), top_k=top_k,
                               gumbel=torch.from_numpy(gumbel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"trial {trial}")


@pytest.mark.parametrize("top_k", [0, 16])
def test_device_sample_stays_in_nucleus(top_k):
    logits = _logits(4, (5, 96), 4.0)
    top_p = 0.6
    probs = TS.softmax(logits)
    nuclei = []
    for r in range(5):
        sp = np.sort(probs[r])[::-1]
        cut = sp[int(np.argmax(np.cumsum(sp) > top_p))]
        nuclei.append(set(np.nonzero(probs[r] >= cut)[0].tolist()))
    assert all(len(n) <= 16 for n in nuclei), "test setup: the nucleus must fit k"
    gen = torch.Generator().manual_seed(1)
    t, p = torch.full((5,), 0.9), torch.full((5,), top_p)
    for _ in range(30):
        toks = TS.device_sample(torch.from_numpy(logits), t, p, gen, top_k=top_k)
        for r, tok in enumerate(toks.tolist()):
            assert tok in nuclei[r]


def test_device_sample_keeps_whole_top_k_when_its_mass_is_below_top_p():
    """Flat logits: the top 8 of 256 hold ~3% of the mass, far below top_p.
    JAX's k-domain path then keeps only the first token (greedy); the port
    keeps all k and samples among them."""
    logits = np.full((1, 256), -0.05, np.float32)
    logits[0, :8] = np.linspace(0.1, 0.0, 8, dtype=np.float32)  # the strict top 8
    args = (torch.ones(1), torch.full((1,), 0.9))
    gen = torch.Generator().manual_seed(0)
    seen = {int(TS.device_sample(torch.from_numpy(logits), *args, gen, top_k=8)) for _ in range(64)}
    assert seen <= set(range(8)) and len(seen) > 1
    j_seen = {int(JS.device_sample(jnp.asarray(logits), jnp.ones(1), jnp.full(1, 0.9),
                                   jax.random.PRNGKey(i), top_k=8)[0]) for i in range(8)}
    assert j_seen == {0}  # the JAX behaviour the port does not copy
