"""Speculative decoding: a small draft model proposes k tokens and the
target checks them in one sequence pass.

Ports ``rwkv_tpu.models.speculative``:

- ``speculative_generate``: the host loop. Each round the draft proposes
  k tokens with ``decode`` (its decode kernel under ``megakernel=True``),
  the target scores them with one ``score`` pass on a throwaway state,
  and both models commit the accepted prefix with ``prefill``.
- ``speculative_generate_device``: the round loop with every step's data
  on the model's device. The draft runs k+1 steps of ``forward_stacked``
  at T=1 (per-op, as JAX's ``dstep``), the target one
  ``forward_stacked_trace`` pass whose per-position states make the commit
  a gather ``trace[:, j]``; the accepted length j, the replacement token,
  the draft-state gather ``d_states[j]`` and the write of the round's
  window into a fixed ``[n_tokens + k + 2]`` buffer at the offset
  ``count`` all stay on the device. The rounds are a Python loop whose end
  test reads ``count`` from the device once a round: that is the loop's
  only host read (JAX's ``lax.while_loop`` makes one host read a
  generation).
- ``_spec_accept`` and ``speculative_sample_generate_device``: speculative
  sampling at temperature > 0 (Leviathan et al., arXiv:2211.17192), whose
  stream is distributed as the target's own sampling. Noise comes from a
  ``torch.Generator`` on the model's device seeded from `seed`;
  ``_spec_accept`` also takes the uniforms and the Gumbel row, so that a
  test can feed it JAX's draws.

Greedy output equals the target's own greedy stream whatever the draft,
on the card too: the verification passes give each position the bits the
one-token decode chain gives it (``models.serve._wkv_auto``,
``ops.parity.ROW_INVARIANT_ROWS``). On the card v4's host loop is the
exception: its score and commit passes run the log-depth wkv4 scan.
Return values and ``stats`` (rounds, drafted, accepted, acceptance_rate)
are counted as each JAX function counts them: the host loop does not count
the round that only emits the last token, the device loops count every
round. JAX's ``_model_sig`` only keys its jit cache and has no counterpart
here. The target and the draft must be on one device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rwkv_tpu_torch.models.serve import ServingModel, forward_stacked, forward_stacked_trace
from rwkv_tpu_torch.utils.sampling import gumbel_noise


def _check_devices(target: ServingModel, draft: ServingModel) -> torch.device:
    if target.device != draft.device:
        raise ValueError(f"target on {target.device} and draft on {draft.device}: "
                         "speculative decoding needs both on one device")
    return target.device


def _stats(rounds: int, drafted: int, accepted: int) -> dict:
    return {
        "rounds": rounds,
        "drafted": drafted,
        "accepted": accepted,
        "acceptance_rate": (accepted / drafted) if drafted else 1.0,
    }


def speculative_generate(
    target: ServingModel,
    draft: ServingModel,
    prompt_tokens: Sequence[int],
    n_tokens: int,
    k: int = 4,
) -> Tuple[np.ndarray, dict]:
    """Greedy speculative generation on the host (JAX's
    ``speculative_generate``). Returns (tokens int32 [n_tokens], stats);
    the tokens are `target`'s greedy stream."""
    _check_devices(target, draft)
    logits_t, state_t = target.prefill(list(prompt_tokens))
    _, state_d = draft.prefill(list(prompt_tokens))

    out: List[int] = []
    n_rounds = n_drafted = n_accepted = 0
    pred_t = int(torch.argmax(logits_t))  # the target's next token

    while len(out) < n_tokens:
        # the target's own next token is known (greedy): emit it, then let
        # the draft continue k tokens from it
        out.append(pred_t)
        if len(out) >= n_tokens:
            break
        n_rounds += 1

        draft_toks = []
        d_state, tok = state_d, pred_t
        for _ in range(k):
            d_logits, d_state = draft.decode([tok], d_state)
            tok = int(torch.argmax(d_logits[0]))
            draft_toks.append(tok)
        n_drafted += k

        # the target scores [pred_t, draft_toks[:-1]] on a throwaway state:
        # position i's logits predict position i+1
        logits_seq, _ = target.score([[pred_t] + draft_toks[:-1]], state_t)
        greedy = torch.argmax(logits_seq[0], dim=-1).tolist()

        # the longest accepted prefix; the first mismatch is replaced by the
        # target's own choice
        j = 0
        while j < k and draft_toks[j] == greedy[j]:
            j += 1
        accepted = draft_toks[:j]
        n_accepted += j
        next_pred = greedy[j] if j < k else None

        # commit: both models roll their states over pred_t + accepted
        committed = [pred_t] + accepted
        logits_t, state_t = target.prefill(committed, state=state_t)
        _, state_d = draft.prefill(committed, state=state_d)

        out.extend(accepted[: n_tokens - len(out)])
        if len(out) >= n_tokens:
            break
        pred_t = next_pred if next_pred is not None else int(torch.argmax(logits_t))

    return np.asarray(out[:n_tokens], np.int32), _stats(n_rounds, n_drafted, n_accepted)


def _draft_steps(draft: ServingModel, state: dict, pred: torch.Tensor, k: int, pick):
    """k+1 draft steps at T=1 from `pred` ([1]). `pick(logits [V])` gives
    the next token [1] and what to keep of the step. Returns (tokens [k+1],
    kept per step, the states after each step stacked [k+1, L, ...])."""
    toks, kept, states = [], [], []
    st, tok = state, pred
    for _ in range(k + 1):
        logits, st = forward_stacked(draft.params, st, tok, draft.config)
        tok, keep = pick(logits)
        toks.append(tok)
        kept.append(keep)
        states.append(st)
    return torch.cat(toks), kept, {key: torch.stack([s[key] for s in states]) for key in st}


def _commit(trace: dict, d_states: dict, j: torch.Tensor) -> tuple:
    """The target's state after position j (``trace[:, j]``) and the
    draft's after its step j (``d_states[j]``), gathered on the device."""
    idx = j.reshape(1)
    return ({key: a.index_select(1, idx)[:, 0] for key, a in trace.items()},
            {key: a.index_select(0, idx)[0] for key, a in d_states.items()})


def _device_loop(state_t, state_d, pred, n_tokens: int, k: int, round_fn):
    """The rounds of the device loops: `round_fn(state_t, state_d, pred)`
    returns (seq [k+1], j, next pred [1], target state, draft state), all
    on the device. Returns (tokens int32 [n_tokens], stats)."""
    dev = pred.device
    st_t = {key: v[0] for key, v in state_t.items()}
    st_d = {key: v[0] for key, v in state_d.items()}
    buf = torch.zeros(n_tokens + k + 2, dtype=torch.int64, device=dev)
    window = torch.arange(k + 1, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    rounds = 0
    while int(count) < n_tokens:  # the loop's one host read a round
        seq, j, pred, st_t, st_d = round_fn(st_t, st_d, pred)
        buf.index_copy_(0, count + window, seq)
        count = count + j + 1
        acc = acc + j
        rounds += 1
    toks = buf[:n_tokens].to(torch.int32).cpu().numpy()
    return toks, _stats(rounds, rounds * k, int(acc))


def speculative_generate_device(
    target: ServingModel,
    draft: ServingModel,
    prompt_tokens: Sequence[int],
    n_tokens: int,
    k: int = 4,
    force_accept: bool = False,
) -> Tuple[np.ndarray, dict]:
    """Greedy speculative generation with each round's data on the device
    (JAX's ``speculative_generate_device``; see the module doc). Returns
    (tokens int32 [n_tokens], stats); the tokens are `target`'s greedy
    stream.

    force_accept: a benchmark knob that takes all k proposals as accepted
    every round. The output is then NOT the target's greedy stream; it
    measures the round machinery at acceptance 1 with a real, cheap draft."""
    _check_devices(target, draft)
    logits_t, state_t = target.prefill(list(prompt_tokens))
    _, state_d = draft.prefill(list(prompt_tokens))
    pred0 = torch.argmax(logits_t).reshape(1)
    full = torch.tensor(k, device=pred0.device)

    def greedy_pick(logits):
        return torch.argmax(logits).reshape(1), None

    def round_fn(st_t, st_d, pred):
        draft_toks, _, d_states = _draft_steps(draft, st_d, pred, k, greedy_pick)
        seq = torch.cat([pred, draft_toks[:k]])
        logits_all, trace = forward_stacked_trace(target.params, st_t, seq, target.config)
        greedy = torch.argmax(logits_all, dim=-1)
        j = full if force_accept else torch.cumprod((greedy[:k] == draft_toks[:k]).long(), 0).sum()
        st_t, st_d = _commit(trace, d_states, j)
        return seq, j, greedy.index_select(0, j.reshape(1)), st_t, st_d

    return _device_loop(state_t, state_d, pred0, n_tokens, k, round_fn)


def _spec_accept(probs_t, probs_d, draft_toks, generator=None, uniforms=None, gumbel=None):
    """One round of speculative rejection sampling, on the device (JAX's
    ``_spec_accept``).

    probs_t [k+1, V]: the target's probabilities at positions 0..k
    (position i: the next token after the committed prefix + d_1..d_i);
    probs_d [k, V]: the draft's, from which the k proposals draft_toks [k]
    were drawn. Returns (j, next_token), 0-d int64 tensors: j proposals
    accepted, and next_token drawn from the residual max(0, p_t - p_d) at
    the rejection position, or from probs_t[k] when all k were accepted.
    The uniforms [k] and the Gumbel row [V] come from `generator`, or are
    `uniforms` / `gumbel` when given (JAX draws them with
    ``jax.random.uniform`` and ``jax.random.categorical``)."""
    k = draft_toks.shape[0]
    if uniforms is None:
        uniforms = torch.rand(k, generator=generator, device=probs_t.device)
    pt_tok = probs_t[:k].gather(-1, draft_toks[:, None])[:, 0]
    pd_tok = probs_d.gather(-1, draft_toks[:, None])[:, 0]
    ratio = pt_tok / torch.clamp(pd_tok, min=1e-30)
    accept = (uniforms.to(probs_t.device) < ratio).long()
    j = torch.cumprod(accept, 0).sum()

    # the residual at the rejection position (row j; with all k accepted,
    # j == k and the residual is probs_t[k] itself)
    p_t_j = probs_t.index_select(0, j.reshape(1))[0]
    p_d_j = probs_d.index_select(0, torch.clamp(j, max=k - 1).reshape(1))[0]
    p_d_j = torch.where(j < k, p_d_j, torch.zeros_like(p_t_j))
    resid = torch.clamp(p_t_j - p_d_j, min=0.0)
    resid = resid / torch.clamp(resid.sum(), min=1e-30)
    if gumbel is None:
        gumbel = gumbel_noise(resid, generator)
    next_tok = torch.argmax(torch.log(resid + 1e-38) + gumbel.to(resid.device))
    return j, next_tok


def speculative_sample_generate_device(
    target: ServingModel,
    draft: ServingModel,
    prompt_tokens: Sequence[int],
    n_tokens: int,
    k: int = 4,
    temperature: float = 1.0,
    seed: int = 0,
) -> Tuple[np.ndarray, dict]:
    """Speculative sampling at temperature > 0 with the round loop of
    ``speculative_generate_device`` (JAX's
    ``speculative_sample_generate_device``): the emitted stream follows the
    target's sampling distribution at `temperature` (rejection sampling of
    the draft's proposals, ``_spec_accept``). Noise from a
    ``torch.Generator`` on the device seeded from `seed`. Returns (tokens
    int32 [n_tokens], stats)."""
    if temperature <= 0.0:
        raise ValueError("use speculative_generate_device for greedy")
    dev = _check_devices(target, draft)
    logits_t, state_t = target.prefill(list(prompt_tokens))
    _, state_d = draft.prefill(list(prompt_tokens))
    inv_t = 1.0 / float(temperature)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(logits):
        return torch.argmax(logits * inv_t + gumbel_noise(logits, gen), dim=-1)

    pred0 = draw(logits_t).reshape(1)

    def sample_pick(logits):
        return draw(logits).reshape(1), torch.softmax(logits * inv_t, dim=-1)

    def round_fn(st_t, st_d, pred):
        draft_toks, probs_d, d_states = _draft_steps(draft, st_d, pred, k, sample_pick)
        seq = torch.cat([pred, draft_toks[:k]])
        logits_all, trace = forward_stacked_trace(target.params, st_t, seq, target.config)
        probs_t = torch.softmax(logits_all * inv_t, dim=-1)
        j, nxt = _spec_accept(probs_t, torch.stack(probs_d[:k]), draft_toks[:k], gen)
        st_t, st_d = _commit(trace, d_states, j)
        return seq, j, nxt.reshape(1), st_t, st_d

    return _device_loop(state_t, state_d, pred0, n_tokens, k, round_fn)
