"""Helpers for measurements on the card: device time of queued launches,
host-clock time, the card's name and power limit, seeded decode states and
per-sequence errors against a plain version.

Used by ``chip_smoke.py`` and the probes in this package. ``device_ms``,
``wall_ms`` and ``seeded_states`` need a CUDA device.
"""

from __future__ import annotations

import subprocess
import time


def card_line() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_SPIN: list = []


def _spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    if not _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN.append(10_000_000 / start.elapsed_time(end))
    return _SPIN[0]


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() in ms. The timed calls are queued behind a
    spin kernel that outlasts their enqueue, so the device runs them back
    to back and the CUDA events between them hold no host time. fn must not
    synchronise with the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 2) * _spin_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 20) -> float:
    """Mean host-clock time of fn() in ms, synchronised at both ends."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def seeded_states(model, cfg, b: int, t: int, seed: int):
    """States of b sequences after one batched per-op prefill of t seeded
    tokens each, and each sequence's last token."""
    import torch

    toks = torch.randint(0, cfg.n_vocab, (b, t), generator=torch.Generator().manual_seed(seed))
    toks = toks.to(model.device)
    _, state = model._batched(model.init_state(b), toks, compute_logits=False)
    return state, toks[:, -1].contiguous()


def seq_errors(outs, refs):
    """Per sequence (leading dim) of equal-shaped tensor lists: (max abs
    err over every tensor, the same over max(1, max |ref|), all elements
    within rtol = atol = 2e-2)."""
    import torch

    b = outs[0].shape[0]
    err = torch.zeros(b, device=outs[0].device)
    rel = torch.zeros(b, device=outs[0].device)
    ok = torch.ones(b, dtype=torch.bool, device=outs[0].device)
    for a, r in zip(outs, refs):
        d = (a - r).abs().reshape(b, -1).amax(dim=1)
        err = torch.maximum(err, d)
        rel = torch.maximum(rel, d / r.abs().reshape(b, -1).amax(dim=1).clamp(min=1.0))
        ok &= torch.isclose(a, r, rtol=2e-2, atol=2e-2).reshape(b, -1).all(dim=1)
    return err, rel, ok
