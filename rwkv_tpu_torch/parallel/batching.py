"""Continuous batching: a pool of per-sequence recurrent state slots on the
device and a scheduler that admits and retires sequences between batched
decode steps.

Ports ``rwkv_tpu.parallel.batching``. RWKV's state is the same fixed size
for every sequence, so all sequences' states live in one stacked dict
``[B, ...]`` (the serving layout), decode is one batched step for every
slot (``ServingModel.decode``: kernel K4 and the head on K1 under
``megakernel=True``), and admission is a row write. Admission prefill is
batched across queued prompts: prompts walk the shared power-of-two chunk
buckets, and the prompts that need the same chunk size in a round run in
one call, padded to a power of two.

``run(on_device=True)`` keeps the decode loop on the card: sampling
(temperature, nucleus within the top ``DEVICE_TOP_K``, presence and
frequency penalties, per slot) and the stop and length bookkeeping run on
device tensors, and the host reads one ``[B, sync_every]`` token buffer per
round of ``sync_every`` steps. Without a queue a drain runs up to
``DRAIN_ROUNDS_CAP`` rounds before it looks at the queue again. ``step()``
is the per-token host path (numpy sampling) for external schedulers.

Unlike the JAX package, the next-token logits of every slot live in one
device tensor that both paths read and write, so there is no host copy
that can go stale between ``run`` calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from rwkv_tpu_torch.models.serve import PREFILL_BUCKETS, ServingModel
from rwkv_tpu_torch.utils.sampling import (
    apply_penalties,
    device_penalized_logits,
    device_sample,
    sample_logits,
)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def write_slot(batched_state: dict, slot: int, state: dict) -> dict:
    """Write a single-sequence state (leading dim 1) into slot `slot` of the
    batched state, in place; returns the batched state."""
    for k, pool in batched_state.items():
        pool[slot] = state[k][0]
    return batched_state


def take_rows(tree: dict, idx) -> dict:
    """Rows `idx` of every array of `tree` (new tensors)."""
    return {k: v.index_select(0, _index(idx, v.device)) for k, v in tree.items()}


def scatter_rows(pool: dict, tree: dict, idx) -> dict:
    """Write the rows of `tree` into rows `idx` of `pool`, in place;
    returns `pool`."""
    for k, p in pool.items():
        p[_index(idx, p.device)] = tree[k]
    return pool


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 1.0
    top_p: float = 0.8
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    stop_tokens: tuple = ()
    # -- filled during processing --
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching over a ServingModel.

    Usage:
        batcher = ContinuousBatcher(model, max_batch=8)
        rid = batcher.submit(prompt_tokens, max_new_tokens=64)
        results = batcher.run()          # drain everything
    """

    # top-k bound of the device sampler's nucleus (see device_sample); exact
    # for any nucleus that fits in this many tokens
    DEVICE_TOP_K = 512
    # rounds a drain runs before it returns to the scheduler
    DRAIN_ROUNDS_CAP = 32

    def __init__(self, model: ServingModel, max_batch: int = 8, seed: int = 0,
                 sync_every: int = 8):
        self.model = model
        self.max_batch = max_batch
        self.sync_every = sync_every
        self.state = model.init_state(max_batch)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_id = 0
        dev = model.device
        # every slot's next-token logits, on the device for both paths
        self._logits = torch.zeros((max_batch, model.config.n_vocab), dtype=torch.float32,
                                   device=dev)
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        self.rounds = 0  # rounds of sync_every steps run on the device

    # -- submission -------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int, **sampling) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens, **sampling))
        return rid

    # -- admission --------------------------------------------------------
    def _admit(self) -> List[int]:
        """Move queued requests into free slots with batched prefill and
        write their last-token logits into ``_logits``. Returns the
        admitted slot indices."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        admit = []
        while free and self.queue:
            admit.append((free.pop(0), self.queue.pop(0)))
        if not admit:
            return []

        dev = self.model.device
        kn = len(admit)
        pool = self.model.init_state(kn)
        logits_rows: List[Optional[torch.Tensor]] = [None] * kn
        offs = [0] * kn
        lens = [len(req.prompt) for _, req in admit]

        while True:
            pending = [i for i in range(kn) if offs[i] < lens[i]]
            if not pending:
                break
            sizes: Dict[int, List[int]] = {}
            for i in pending:
                size = next(b for b in PREFILL_BUCKETS if b <= lens[i] - offs[i])
                sizes.setdefault(size, []).append(i)
            for size, group in sizes.items():
                toks = np.stack(
                    [admit[i][1].prompt[offs[i] : offs[i] + size] for i in group]
                ).astype(np.int64)
                last = [offs[i] + size >= lens[i] for i in group]
                # pad the group to a power of two: O(log max_batch) shapes
                g = len(group)
                g_pad = 1 << (g - 1).bit_length()
                idx = group + [group[0]] * (g_pad - g)
                if g_pad != g:
                    toks = np.concatenate([toks, np.zeros((g_pad - g, size), np.int64)])
                st = take_rows(pool, idx)
                logits, st = self.model._batched(st, torch.as_tensor(toks, device=dev), any(last))
                pool = scatter_rows(pool, take_rows(st, range(g)), group)
                for gi, i in enumerate(group):
                    offs[i] += size
                    if last[gi]:
                        logits_rows[i] = logits[gi]

        admitted = []
        for i, (slot, req) in enumerate(admit):
            write_slot(self.state, slot, take_rows(pool, [i]))
            self._logits[slot] = logits_rows[i]
            self.slots[slot] = req
            admitted.append(slot)
        return admitted

    # -- per-token host path ----------------------------------------------
    def _sample(self, req: Request, logits: np.ndarray) -> int:
        counts: Dict[int, int] = {}
        for t in req.generated:
            counts[t] = counts.get(t, 0) + 1
        logits = apply_penalties(logits, counts, req.presence_penalty, req.frequency_penalty)
        return sample_logits(logits, temperature=req.temperature, top_p=req.top_p, rng=self._rng)

    def _retire(self, i: int) -> None:
        req = self.slots[i]
        req.done = True
        self.finished[req.request_id] = req
        self.slots[i] = None

    def step(self) -> List[Request]:
        """One scheduler iteration: admit, sample on the host, one batched
        decode, retire. Returns the requests that finished this step."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        logits_h = self._logits.cpu().numpy()
        tokens = np.zeros(self.max_batch, np.int64)
        for i in active:
            tokens[i] = self._sample(self.slots[i], logits_h[i])
            self.slots[i].generated.append(int(tokens[i]))

        self._logits, self.state = self.model.decode(tokens, self.state)

        done_now: List[Request] = []
        for i in active:
            req = self.slots[i]
            if len(req.generated) >= req.max_new_tokens or req.generated[-1] in req.stop_tokens:
                done_now.append(req)
                self._retire(i)
        return done_now

    # -- decode loop on the device ------------------------------------------
    def _controls(self) -> dict:
        """Per-slot sampling controls as device tensors, and the loop's
        specializations (every live slot greedy; any slot penalized)."""
        dev = self.model.device
        reqs = self.slots
        live = [r for r in reqs if r is not None]
        n_stop = max([len(r.stop_tokens) for r in live] + [1])
        stops = np.full((self.max_batch, n_stop), -1, np.int64)
        for i, r in enumerate(reqs):
            if r is not None and r.stop_tokens:
                stops[i, : len(r.stop_tokens)] = list(r.stop_tokens)

        def per_slot(fn, default):
            return torch.tensor([fn(r) if r else default for r in reqs], dtype=torch.float32,
                                device=dev)

        return {
            "temperature": per_slot(lambda r: r.temperature, 1.0),
            "top_p": per_slot(lambda r: r.top_p, 1.0),
            "presence": per_slot(lambda r: r.presence_penalty, 0.0),
            "frequency": per_slot(lambda r: r.frequency_penalty, 0.0),
            "stops": torch.as_tensor(stops, device=dev),
            "all_greedy": all(r.temperature == 0.0 for r in live),
            "use_penalties": any(
                r.presence_penalty != 0.0 or r.frequency_penalty != 0.0 for r in live),
        }

    def _device_step(self, ctl: dict, counts, remaining, active) -> torch.Tensor:
        """Sample every slot's next token from ``_logits`` and decode it,
        all on the device; updates counts / remaining / active in place.
        Returns the emitted tokens [B] (-1 where the slot was inactive)."""
        pen = self._logits
        if ctl["use_penalties"]:
            pen = device_penalized_logits(pen, counts, ctl["presence"], ctl["frequency"])
        if ctl["all_greedy"]:
            tok = torch.argmax(pen, dim=-1)
        else:
            top_k = min(self.DEVICE_TOP_K, self.model.config.n_vocab)
            tok = device_sample(pen, ctl["temperature"], ctl["top_p"], self._gen, top_k)
        tok = torch.where(active, tok, torch.zeros_like(tok))
        rows = torch.arange(self.max_batch, device=tok.device)
        if ctl["use_penalties"]:
            counts[rows, tok] += active.to(counts.dtype)
        remaining -= active.to(remaining.dtype)
        hit = (tok[:, None] == ctl["stops"]).any(dim=-1)
        emitted = torch.where(active, tok, torch.full_like(tok, -1))
        active &= ~(hit | (remaining <= 0))
        self._logits, self.state = self.model.decode(tok, self.state)
        return emitted

    def _consume_round(self, reqs, toks_h: np.ndarray) -> None:
        """Fold one round's emitted tokens ([B, n], -1 = slot inactive at
        that step) into the requests and retire finished slots."""
        for i, req in enumerate(reqs):
            if req is None:
                continue
            for t in toks_h[i]:
                if t < 0:
                    break
                req.generated.append(int(t))
            if (len(req.generated) >= req.max_new_tokens
                    or (req.generated and req.generated[-1] in req.stop_tokens)):
                self._retire(i)

    def _run_device(self) -> None:
        b, dev = self.max_batch, self.model.device
        counts = torch.zeros((b, self.model.config.n_vocab), dtype=torch.float32, device=dev)
        for i, r in enumerate(self.slots):  # slots that step() already advanced
            for t in (r.generated if r else ()):
                counts[i, t] += 1.0
        remaining = torch.tensor(
            [r.max_new_tokens - len(r.generated) if r else 0 for r in self.slots],
            dtype=torch.int32, device=dev)
        active = torch.tensor([r is not None for r in self.slots], dtype=torch.bool, device=dev)
        ctl = None
        while self.queue or any(s is not None for s in self.slots):
            if self.queue and any(s is None for s in self.slots):
                admitted = self._admit()
                if admitted:
                    idx = _index(admitted, dev)
                    counts[idx] = 0.0
                    remaining[idx] = torch.tensor(
                        [self.slots[i].max_new_tokens for i in admitted], dtype=torch.int32,
                        device=dev)
                    active[idx] = True
                    ctl = None
            if ctl is None:
                ctl = self._controls()
            # with a queue, one round before the next admission; else a drain
            for _ in range(1 if self.queue else self.DRAIN_ROUNDS_CAP):
                reqs = list(self.slots)
                buf = torch.stack(
                    [self._device_step(ctl, counts, remaining, active)
                     for _ in range(self.sync_every)], dim=1)
                self._consume_round(reqs, buf.cpu().numpy())  # the round's one host read
                self.rounds += 1
                if not any(s is not None for s in self.slots):
                    break

    def run(self, on_device: bool = True) -> Dict[int, Request]:
        """Drain the queue and all active slots; returns finished requests.
        on_device=True runs the decode loop on the device (one host read per
        `sync_every` tokens); False runs per-token ``step()``."""
        if on_device:
            self._run_device()
        else:
            while self.queue or any(s is not None for s in self.slots):
                self.step()
        return self.finished

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)
