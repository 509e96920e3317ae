"""Token sampling: temperature / top-p / top-k / logit bias, and presence
and frequency penalties.

Ports ``rwkv_tpu.utils.sampling``. Two implementations of the same
semantics:

- numpy on the host (``softmax``, ``sample_logits``, ``sample_probs``,
  ``apply_penalties``), copies of the JAX package's functions, for the
  batcher's per-token ``step``;
- torch on the logits' device (``device_penalized_logits``,
  ``device_sample``) for the batcher's decode loop on the card, where the
  logits, counts and sampling controls never leave the device.

Temperature applies to PROBABILITIES after the nucleus filter
(``p ** (1/T)``), as the reference's sampler does, not to the logits.

One deliberate difference from the JAX package: when the top-k mass stays
below ``top_p``, JAX's ``device_sample`` takes the argmax of an all-False
mask and keeps only the most probable token (sampling turns greedy). Here
the whole top-k is kept.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def sample_logits(
    logits,
    temperature: float = 1.0,
    top_p: float = 0.8,
    top_k: int = 0,
    logit_bias: Optional[Dict[int, float]] = None,
    rng: Optional[np.random.Generator] = None,
) -> int:
    return sample_probs(
        softmax(np.asarray(logits, dtype=np.float32)),
        temperature=temperature,
        top_p=top_p,
        top_k=top_k,
        logit_bias=logit_bias,
        rng=rng,
    )


def sample_probs(
    probs: np.ndarray,
    temperature: float = 1.0,
    top_p: float = 0.8,
    top_k: int = 0,
    logit_bias: Optional[Dict[int, float]] = None,
    rng: Optional[np.random.Generator] = None,
) -> int:
    if temperature < 0.0:
        raise ValueError("temperature must be >= 0")
    if not (0.0 <= top_p <= 1.0):
        raise ValueError("top_p must be in [0, 1]")
    probs = np.asarray(probs, dtype=np.float32).copy()

    if top_p == 0.0:  # reference quirk: 0 disables nucleus filtering
        top_p = 1.0

    if logit_bias:
        with np.errstate(divide="ignore"):
            logits = np.log(probs)
        ids = np.fromiter(logit_bias.keys(), dtype=np.int64)
        vals = np.fromiter(logit_bias.values(), dtype=np.float32)
        logits[ids] += vals
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()

    if temperature == 0.0:
        return int(np.argmax(probs))

    if top_k > 0 and top_k < probs.size:
        kth = np.partition(probs, -top_k)[-top_k]
        probs[probs < kth] = 0.0

    if top_p < 1.0:
        sorted_probs = np.sort(probs)[::-1]
        cutoff_idx = int(np.argmax(np.cumsum(sorted_probs) > top_p))
        probs[probs < float(sorted_probs[cutoff_idx])] = 0.0

    if temperature != 1.0:
        probs = np.power(probs, 1.0 / temperature)

    probs /= probs.sum()
    rng = rng if rng is not None else np.random.default_rng()
    return int(rng.choice(probs.size, p=probs))


def apply_penalties(
    logits: np.ndarray,
    token_counts: Dict[int, int],
    presence_penalty: float = 0.0,
    frequency_penalty: float = 0.0,
) -> np.ndarray:
    """Presence/frequency penalties as used by the chat front-end."""
    out = np.asarray(logits, dtype=np.float32).copy()
    for tok, count in token_counts.items():
        out[tok] -= presence_penalty + count * frequency_penalty
    return out


def device_penalized_logits(logits, counts, presence, frequency):
    """Batched presence/frequency penalties on the logits' device.

    logits [B, V] f32; counts [B, V] (per-sequence emitted-token counts);
    presence/frequency [B]. Same math as apply_penalties."""
    return (
        logits
        - (counts > 0).to(torch.float32) * presence[:, None]
        - counts.to(torch.float32) * frequency[:, None]
    )


def _nucleus_cutoff(sorted_probs, top_p):
    """[B, 1] nucleus cutoff of probabilities sorted descending per row:
    the value at the first position whose running sum exceeds top_p (0
    means 1, no filter); -1, which keeps everything, where top_p >= 1 or
    the running sum never exceeds it."""
    top_p_eff = torch.where(top_p == 0.0, torch.ones_like(top_p), top_p)[:, None]
    exceeded = torch.cumsum(sorted_probs, dim=-1) > top_p_eff
    cut_idx = exceeded.to(torch.int32).argmax(dim=-1, keepdim=True)  # first True
    cutoff = torch.gather(sorted_probs, -1, cut_idx)
    keep_all = (top_p_eff >= 1.0) | ~exceeded.any(dim=-1, keepdim=True)
    return torch.where(keep_all, torch.full_like(cutoff, -1.0), cutoff)


def _log_kept(probs, cutoff):
    """log p for the probabilities at or above the cutoff, -inf below."""
    kept = probs >= cutoff
    return torch.where(kept & (probs > 0.0), torch.log(torch.clamp(probs, min=1e-38)),
                       torch.full_like(probs, -torch.inf))


def gumbel_noise(like: torch.Tensor, generator=None) -> torch.Tensor:
    """Standard Gumbel noise of `like`'s shape on its device, from
    `generator`: -log of an Exp(1) draw, clamped finite (as JAX's
    uniform(minval=tiny) is), so -inf logits stay -inf."""
    e = torch.empty(like.shape, dtype=torch.float32, device=like.device).exponential_(
        generator=generator)
    return -torch.log(torch.clamp(e, min=torch.finfo(torch.float32).tiny))


def _categorical(logp, temperature, generator, gumbel):
    """argmax(logp / T + Gumbel noise) per row: a draw from p^(1/T). The
    noise comes from `generator`, or is `gumbel` (same shape) when given
    (tests feed ``jax.random.gumbel``'s draws to match JAX bit for bit)."""
    safe_t = torch.clamp(temperature, min=1e-6)[:, None]
    if gumbel is None:
        gumbel = gumbel_noise(logp, generator)
    return torch.argmax(gumbel.to(logp.device) + logp / safe_t, dim=-1)


def device_sample(logits, temperature, top_p, generator=None, top_k: int = 0, gumbel=None):
    """Batched sampler with sample_probs' semantics, on the logits' device.

    logits [B, V]; temperature / top_p [B] (top_p 0 disables nucleus
    filtering, temperature 0 = argmax, both per row); generator a
    ``torch.Generator`` on that device. top_k 0: exact full-vocabulary
    nucleus sort; k > 0: the nucleus is taken within the k most probable
    tokens (``torch.topk``; their probabilities over the full vocabulary
    from one logsumexp), exact whenever the nucleus fits in k -- and when
    it does not, all k are kept. gumbel: optional noise, [B, k] or [B, V]
    to match the path. Returns int64 tokens [B]."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    temperature = temperature.to(logits.device, torch.float32)
    top_p = top_p.to(logits.device, torch.float32)

    if top_k and top_k < v:
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        vals, idx = torch.topk(logits, top_k, dim=-1)  # descending
        probs = torch.exp(vals - lse)  # true probabilities, descending
        greedy = idx[:, 0]
        logp = _log_kept(probs, _nucleus_cutoff(probs, top_p))
        s = _categorical(logp, temperature, generator, gumbel)
        sampled = torch.gather(idx, -1, s[:, None])[:, 0]
        return torch.where(temperature <= 0.0, greedy, sampled)

    probs = torch.softmax(logits, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    sorted_desc = torch.sort(probs, dim=-1, descending=True).values
    logp = _log_kept(probs, _nucleus_cutoff(sorted_desc, top_p))
    sampled = _categorical(logp, temperature, generator, gumbel)
    return torch.where(temperature <= 0.0, greedy, sampled)
