"""Helpers for measurements on the card: device time of queued launches,
host-clock time, the card's name and power limit, seeded decode states,
per-sequence errors against a plain version, the RWKV-6, RWKV-5 and RWKV-4
models at the published widths the port serves (``v6_models``,
``v5_models``, ``v4_models``; int8, int4 and bf16 packs) and the B=1
decode kernels K3 and K6-K8 against their plain versions on a pack cut in
depth (``decode_vs_plain``).

Used by ``chip_smoke.py`` and the probes in this package. ``device_ms``,
``wall_ms``, ``seeded_states``, the ``*_models`` and ``decode_vs_plain``
need a CUDA device.
"""

from __future__ import annotations

import math
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


# Published widths (version, layers, C, vocabulary, head size): RWKV-6 World
# 1.6B (the JAX package's v6 scripts use the same shape), RWKV-5 World 1.5B
# (v5.2) and RWKV-4 World 0.1B; synth's FFN is 4C (the published v6 and v5
# models' is 3.5C, v4's 4C).
V6_WIDTH = ("6.0", 24, 2048, 65536, 64)
V5_WIDTH = ("5.2", 24, 2048, 65536, 64)
V4_WIDTH = ("4.0", 12, 768, 65536, 64)


def width_models(width, seed: int = 0, precisions=("w8a8", "w4a8", "bf16"),
                 with_params: bool = False):
    """(cfg, {"w8a8": model, "w4a8": model, "bf16": model}): ServingModels
    with ``megakernel=True`` of one seeded f32 synth tree at `width`, built
    once for every precision (the int8, int4 and bf16 packs); with_params:
    the tree too, (cfg, models, params)."""
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    cfg = synth_config(*width)
    params = synth_params(cfg, seed=seed)
    models = {p: ServingModel((cfg, params), precision=p, megakernel=True)
              for p in precisions}
    return (cfg, models, params) if with_params else (cfg, models)


def v6_models(seed: int = 0):
    """The RWKV-6 models at the 1.6B width (``width_models``)."""
    return width_models(V6_WIDTH, seed)


def v5_models(seed: int = 0):
    """The RWKV-5 (v5.2) models at the World 1.5B width."""
    return width_models(V5_WIDTH, seed)


def v4_models(seed: int = 0):
    """The RWKV-4 models at the World 0.1B width."""
    return width_models(V4_WIDTH, seed)


def rel_err(a, ref) -> float:
    """max |a - ref| over max(1, max |ref|)."""
    return float((a - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _v7_layers_ref(pack, state, token, cfg):
    """K3's plain version without the head: (x [C], new state)."""
    from rwkv_tpu_torch.ops import megakernel as M

    x, new = M.v7_decode_batched_ref(pack, {k: v[None] for k, v in state.items()},
                                     token.reshape(-1)[:1], cfg)
    return x[0], {k: v[0] for k, v in new.items()}


def decode_launcher(pack):
    """(launch, plain layers, argument counts) of the B=1 decode kernel of
    a v7 (K3), v6, v5 or v4 pack: ``launch(fn, pack, state, token, cfg,
    scratch_extra=0)`` returns (logits, new state, scratch), x at the
    scratch's start."""
    from rwkv_tpu_torch.ops import megakernel as M

    if "version" not in pack:
        return M.decode_launch, _v7_layers_ref, M.DECODE_ARGS
    if pack["version"] == 6:
        return M.v6_decode_launch, M.v6_decode_layers_ref, M.V6_DECODE_ARGS
    if pack["version"] == 5:
        return M.v45_decode_launch, M.v5_decode_layers_ref, M.V5_DECODE_ARGS
    return M.v45_decode_launch, M.v4_decode_layers_ref, M.V4_DECODE_ARGS


def decode_entry(pack, src=None, flags: tuple = ()):
    """The C launch entry of K3, K6, K7 or K8 for `pack` (its version and
    form), from ``csrc`` or another source `src`."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel as M

    version = pack.get("version", 7)
    name = {7: M._k3_entry, 6: M._k6_entry}.get(version, M._v45_entry)(pack)
    args = M._args(decode_launcher(pack)[2], pack)
    if src is None and not flags:
        return _cuda.function(f"v{version}_decode", name, *args)
    src = src or _cuda.CSRC / f"v{version}_decode.cu"
    return _cuda.function(f"v{version}_decode_probe", name, *args, src=src, flags=flags)


def decode_vs_plain(pack, cfg, state: dict, token, depth: int) -> dict:
    """K3, K6, K7 or K8 (by the pack's version) on `pack` cut to its first
    `depth` layers (a shallower config over the same buffers, the state's
    first layers) against its plain version: rel_err of x (before ln_out),
    of the state (the worst of its arrays) and of the logits. Launches
    through the C entry, so the launch counter does not move."""
    import dataclasses

    from rwkv_tpu_torch.ops.megakernel import lm_head_ref

    launch, layers_ref, _ = decode_launcher(pack)
    cd = dataclasses.replace(cfg, n_layer=depth)
    st = {k: v[:depth].contiguous() for k, v in state.items()}
    logits, new, scratch = launch(decode_entry(pack), pack, st, token, cd)
    x_ref, new_ref = layers_ref(pack, st, token, cd)
    return {
        "x": rel_err(scratch[: cfg.n_embed], x_ref),
        "state": max(rel_err(new[k], new_ref[k]) for k in new_ref),
        "logits": rel_err(logits, lm_head_ref(pack, x_ref)),
    }


def tp_vs_plain(packs, cfg, state: dict, x0, depth: int) -> dict:
    """The TP decode step (K10 / K11, K12 / K13, K15 or K14 / K13's MIX45
    form by the packs' version) on its first `depth` layers against the
    same step on the shard kernels' plain versions: rel_err of x and of the
    state (the worst of its arrays), and the largest absolute difference."""
    import dataclasses

    from rwkv_tpu_torch.ops import megakernel_tp as TP

    step = {7: TP.tp_decode_step, 6: TP.tp_decode_step_v6, 5: TP.tp_decode_step_v5,
            4: TP.tp_decode_step_v4}[packs[0]["version"]]
    cd = dataclasses.replace(cfg, n_layer=depth)
    st = {k: v[:depth].contiguous() for k, v in state.items()}
    x, new = step(packs, st, x0, cd)
    x_ref, new_ref = step(packs, st, x0, cd, plain=True)
    return {"x": rel_err(x, x_ref), "state": max(rel_err(new[k], new_ref[k]) for k in new_ref),
            "max_abs_err": max([float((x - x_ref).abs().max())]
                               + [float((new[k] - new_ref[k]).abs().max()) for k in new])}


def single_device_x(model, state: dict, token) -> "torch.Tensor":
    """x [C] before ln_out of the single-device decode kernel `model`
    (``megakernel=True``, no mesh) routes B=1 to -- K3, K6, K7 or K8 through
    its C entry, or K4 where K3 refuses the width -- on `state` (one
    sequence, [1, L, ...]); launch counters do not move."""
    from rwkv_tpu_torch.ops import megakernel as M

    pack, cfg = model._mega, model.config
    if cfg.version_major == 7 and not model._mega_k3:
        x, _, _ = M.batched_launch(M.k4_function(pack), pack, state, token, cfg,
                                   pack["_grid_batched"])
        return x[0]
    launch = decode_launcher(pack)[0]
    _, _, scratch = launch(decode_entry(pack), pack, {k: v[0] for k, v in state.items()}, token,
                           cfg)
    return scratch[: cfg.n_embed]


def wkv7_operands(t: int, bh: int, s: int, dev, seed: int = 2):
    """Realistic v7 operands: bounded decay, a = -kk, b = kk * gate."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    r, k, v = rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3)
    w = torch.exp(torch.sigmoid(rnd(t, bh, s)) * -0.606531)
    kk = rnd(t, bh, s)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    gate = torch.sigmoid(rnd(t, bh, s))
    s0 = rnd(bh, s, s, scale=0.3)
    return s0, r, w, k, v, -kk, kk * gate


def wkv6_operands(t: int, bh: int, s: int, dev, seed: int = 3, extreme: bool = False):
    """v6 operands: the decay exp(-exp(N(0, 1))), or with extreme=True half
    the channels at exp(-20) a token and the rest exp(-exp(3 N(0, 1))),
    some of which underflow to 0."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    r, k, v = rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3)
    if extreme:
        w = torch.where(torch.rand((t, bh, s), device=dev, generator=gen) < 0.5,
                        torch.full((t, bh, s), math.exp(-20.0), device=dev),
                        torch.exp(-torch.exp(rnd(t, bh, s, scale=3.0))))
    else:
        w = torch.exp(-torch.exp(rnd(t, bh, s)))
    return rnd(bh, s, s, scale=0.3), r, k, v, w, rnd(bh, s, scale=0.2)
