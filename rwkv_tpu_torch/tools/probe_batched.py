"""The decode kernels' time on the card (K4 at several B, K3 at B=1),
against an earlier version of their sources, and the v6, v5 and v4
kernels K6, K7 and K8.

    python3 -m rwkv_tpu_torch.tools.probe_batched [--baseline DIR] [--phases | --flips | --k3] [--bf16]
    python3 -m rwkv_tpu_torch.tools.probe_batched --v6 | --v5 | --v4 [--baseline DIR] [--phases] [--flips] [--bf16]
    python3 -m rwkv_tpu_torch.tools.probe_batched --tp6 | --tp7 | --tp5 | --tp4 [--baseline DIR [DIR ...]] [--phases] [--bf16]

Times one launch of ``rwkv_tpu_torch.ops.megakernel.v7_decode_batched``
(K4; device time, launches queued behind a spin kernel so no host time is
counted) for the 169M v7 shape (C=768, synth seed 0) at B = 1, 3, 8, 9,
17, 64, 128 and 256 under w8a8 and w4a8 and B = 1, 8, 64, 128 and 256
under bf16, from the states of a seeded batched prefill, and
``v7_decode_step`` (K3) at B=1 under all three; then every form at B =
1-64 in each placement of its activation preparation (``batched_plan``:
(a) every block, (b) one warp a sequence); then the same at the 1.5B
width (C=2048, 2 layers): B = 1, 3, 8, 9, 17 and 64 (bf16: 1 and 3), and
the placements at B = 1-8.

With ``--baseline DIR`` it also builds ``DIR/v7_decode.cu`` and
``DIR/v7_decode_batched.cu``, where present (an earlier version of a
kernel, its headers beside it), prints the largest difference between the
two versions' outputs (x and state; for bf16 also over each tensor's
scale, against K4_BF16_BAND, as a change of the sums' order moves the
last bits) and times both on the same inputs in the order baseline,
current, current, baseline (for the forms the earlier version has an
entry for).

With ``--k3`` it stops after K3 (B=1, against ``DIR/v7_decode.cu`` with
``--baseline``).

With ``--phases`` it instead builds the kernels with
``-DRWKV_PHASE_TIMES`` (thread 0 of block 0 stamps ``%globaltimer``
before and after every grid barrier) and prints the mean time of each of
the five phases of a layer and of each barrier (nine in K4's placement
(b)): K4 at B = 1, 8 and 64 (w8a8 and bf16, the current sources in
both placements; skipped with ``--k3``), K3 at B=1 (each precision, and the
head phase; each source's stamps read at its own scratch offset,
``k3_stamps_at``), for the current sources and, with ``--baseline``, for
the earlier ones.

With ``--flips`` it instead holds K4 against its plain version on the
169M packs cut to their first 1, 2 and 12 layers (a shallower config over
the same buffers), w8a8, w4a8 and bf16, for 12 seeded batches of 64: per
batch and depth, the sequences outside the element-wise 2e-2 band (int8
code flips), their worst error over the sequence's largest value and in
absolute terms, and the sequences within 1e-4, then the worst over the
seeds by form and depth; and K3 on each batch's first sequence at the
same depths (logits and state over their scale).

With ``--v6`` it measures K6 (``v6_decode_step``) instead, on the RWKV-6
models at the 1.6B width (C=2048, 24 layers, synth seed 0; w8a8, w4a8 and
bf16): its time per launch from a seeded state (against an earlier
``DIR/v6_decode.cu`` with ``--baseline``, as above), with ``--phases`` also the
mean time of each of the seven phases of a layer (A, M, B, C, D, E, F)
and of each barrier from the timing build (each source's stamps read at
that source's own scratch offset, ``stamps_at``), and with ``--flips``
also its distance from its plain version (x, state and logits, each over its
largest value) on the packs cut to their first 1 and 2 layers and at full
depth, for 12 seeded states: the readings that set ``chip_smoke.py``'s
limits for K6. ``--v5`` does the same for K7 on the RWKV-5 (v5.2) models
at the World 1.5B width (C=2048, 24 layers; phases A, C, D, E, F), its
flips also on a 2-layer v5.1 pair at that width; ``--v4`` for K8 on the
RWKV-4 models at the World 0.1B width (C=768, 12 layers; phases A, B, E,
F), its flips also on a 2-layer pair at the 1.5B width (C=2048).

With ``--tp6`` it measures the v6 tensor-parallel shard kernels K12
(``tp_att_layer_v6``) and K13 (``tp_ffn_layer_v6``) on shard 0 of a tp=2
mesh on this card at the 1.6B width (C=2048, F=8192, two layers, layer 1),
and K13's MIX45 form (``tp_ffn_layer_v45``) at the v5.2 World 1.5B width;
``--tp7`` K10 (``tp_att_layer``) at the v7 World 1.5B width (d_lora 96),
reading v_first and, as layer 0 does, writing it ("K10 first"), and K11
(``tp_ffn_layer``); ``--tp5`` K15 (``tp_att_layer_v5``) on v5.2 and v5.1
at the World 1.5B width; ``--tp4`` K14 (``tp_att_layer_v4``) and K13's
MIX45 form at the v4 World 1.5B width: time per launch, against the
sources of an earlier csrc with ``--baseline DIR`` (``DIR/tp_v6.cu``,
``DIR/tp_v7.cu``, ``DIR/tp_v45.cu``; K15 from ``DIR/tp_v45.cu`` where
``DIR/tp_v6.cu`` has no v5 entry, K11 from ``DIR/tp_v7.cu`` where
``DIR/tp_v6.cu`` has no v7 entry; outputs compared at tp=2 and at tp=4,
the current kernel on grids of 132, 64, 33 and 7 blocks: "outputs differ
by at most ..."; times in the order baseline, current, current, baseline,
also with the L2 cache emptied before each launch, as a step of many
layers meets the weights). Further DIRs after the first (edited copies of
``csrc``) are timed in the same turns (their outputs against the first
DIR's). With ``--phases`` also the time of each phase from the timing
build (P, the prologue from the kernel's entry; K12: A, M, B, C and their
barriers, then D; K13 and K11: A and its barrier, then B; K10: A, B, then
C; K15: A, C, then D; K14: A and its barrier, then B) for every source
that stamps (K11 and K14 from before they ran on the stream do not); an
earlier source without stamps needs them added in a copy, and
``DIR#K12=NAMES#K13=NAMES`` names the phases of a copy that stamps more
often (one letter a pair).

``--bf16`` restricts every measurement to the bf16 packs (the readings
that set ``chip_smoke.py``'s bf16 limits), their seeded states from the
bf16 model's own prefill.

Prints one line per measurement and the card (nvidia-smi name and power
limit). Needs a CUDA device; builds the kernels on first use.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

PHASES = "ACDEF"
# K4's int forms in placement (b): each phase but C after its own
# preparation and barrier (pA: ln1 and the mixes; pD, pE, pF likewise)
K4_PHASES_B = ("pA", "A", "C", "pD", "D", "pE", "E", "pF", "F")
V6_PHASES = "AMBCDEF"


def k3_entry(src_dir, pack, flags: tuple = ()):
    """K3's launch entry for `pack`'s form from ``src_dir/v7_decode.cu``
    (None: csrc), or None when that version has no entry for the form."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel as M

    src = (_cuda.CSRC if src_dir is None else Path(src_dir)) / "v7_decode.cu"
    name = M._k3_entry(pack)
    if not hasattr(_cuda.library("v7_decode_probe", src, flags), name):
        return None
    return _cuda.function("v7_decode_probe", name, *M._args(M.DECODE_ARGS, pack), src=src,
                          flags=flags)


def k4_entry(src_dir, pack, flags: tuple = ()):
    """(launch entry, grid entry, legacy) of K4 for `pack`'s form from
    ``src_dir/v7_decode_batched.cu`` (None: csrc), or None when that version
    has no entry for the form; `legacy`: an entry from before the form ran
    on the tensor cores (an int entry without the static-smem entry, a
    bf16 entry without the smem entry: no plan ints, no input buffer in its
    scratch)."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel as M

    src = (_cuda.CSRC if src_dir is None else Path(src_dir)) / "v7_decode_batched.cu"
    lib = _cuda.library("v7_decode_batched_probe", src, flags)
    name = M._k4_entry(pack)
    if not hasattr(lib, name):
        return None
    marker = ("rwkv_v7_decode_batched_smem" if pack["form"] == "bf16"
              else "rwkv_v7_decode_batched_static_smem")
    legacy = not hasattr(lib, marker)
    fn = M.k4_function(pack, src, flags, legacy)
    grid = getattr(lib, name + "_grid")
    grid.argtypes = [ctypes.c_int] * (4 if pack["form"] == "bf16" else 5)
    grid.restype = ctypes.c_int
    return fn, grid, legacy


def k4_places(pack, cfg, b: int, legacy: bool, grid: int) -> tuple:
    """The placements to measure K4 in at batch b: both that have a plan
    for the current sources, none to choose for an earlier source
    (None)."""
    from rwkv_tpu_torch.ops.megakernel import batched_plan

    if legacy:
        return (None,)
    out = []
    for place in ("a", "b"):
        try:
            batched_plan(pack["form"], b, cfg.n_embed, pack["f_dim"], pack["d_lora"],
                         head_size=cfg.head_size, blocks=grid, place=place)
        except ValueError:
            continue
        out.append(place)
    return tuple(out)


def phase_times(launch, base: int, n_layer: int, n_phases: int = 5, reps: int = 5):
    """From the timing build: (us of work and of the barrier after it for
    each of the n_phases phases of a layer, mean over layers and runs; us
    after the last barrier). launch() returns the kernel's scratch, whose
    tail from float `base` holds the stamps."""
    import numpy as np
    import torch

    runs = []
    for _ in range(reps + 1):  # the first run warms up
        scratch = launch()
        torch.cuda.synchronize()
        marks = scratch[base:].cpu().numpy().view(np.uint64).astype(np.int64)
        runs.append(np.diff(marks[: int(np.count_nonzero(marks))]) / 1e3)
    d = np.mean(runs[1:], axis=0)
    n = 2 * n_phases * n_layer
    per_layer = d[:n].reshape(n_layer, n_phases, 2).mean(axis=0)
    return per_layer, float(d[n:].sum()), float(d.sum())


def print_phases(label: str, times, names: str = PHASES, tail_name: str = "head") -> None:
    per_layer, tail, total = times
    print(f"{label} per layer (timing build, block 0): " + ", ".join(
        f"{name} {work:.2f} us + barrier {sync:.2f}"
        for name, (work, sync) in zip(names, per_layer))
        + (f"; {tail_name} {tail:.2f} us" if tail else "") + f"; total {total:.1f} us")


def k3_stamps_at(pack, cfg, src_dir, flags: tuple) -> int:
    """Float offset of the timing build's stamps in K3's scratch for the
    source in `src_dir` (None: csrc): behind the per-layer amax slots where
    that source streams its inputs (it has the ``rwkv_v7_decode_plan``
    entry), else behind the activations alone."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.megakernel import decode_scratch_floats

    src = (_cuda.CSRC if src_dir is None else Path(src_dir)) / "v7_decode.cu"
    streamed = hasattr(_cuda.library("v7_decode_probe", src, flags), "rwkv_v7_decode_plan")
    return decode_scratch_floats(cfg.n_embed, pack["d_lora"], pack["f_dim"],
                                 cfg.n_layer if streamed else 0)


def phase_split(models, cfg, states, tokens, src_dir, label: str, k4: bool = True) -> None:
    """Per-phase device times of K4 (B = 1, 8, 64; the current sources in
    both placements; w8a8 and bf16, or with ``--bf16`` bf16 alone; not
    with `k4` False) and K3 (B=1, every precision of `models`), where
    `src_dir`'s version has the form's entry."""
    from rwkv_tpu_torch.ops.megakernel import batched_launch, batched_scratch_floats, decode_launch

    flags = ("-DRWKV_PHASE_TIMES",)
    extra = 2 * (2 + 2 * len(K4_PHASES_B) * cfg.n_layer)
    for prec in ("w8a8", "bf16") if k4 else ():
        if prec not in models or not (src_dir is None
                                      or (Path(src_dir) / "v7_decode_batched.cu").exists()):
            continue
        pack = models[prec]._mega
        c, d_l, f = cfg.n_embed, pack["d_lora"], pack["f_dim"]
        entry = k4_entry(src_dir, pack, flags)
        if entry is None:
            continue
        fn, grid_fn, legacy = entry
        bf16 = pack["form"] == "bf16"
        grid = grid_fn(c, cfg.head_size, d_l, f, *(() if bf16 else (0,)))
        for b in (1, 8, 64):
            st = {k: v[:b].contiguous() for k, v in states.items()}
            for place in k4_places(pack, cfg, b, legacy, grid):
                names = K4_PHASES_B if place == "b" else PHASES
                times = phase_times(
                    lambda: batched_launch(fn, pack, st, tokens[:b], cfg, grid,
                                           scratch_extra=extra, place=place, legacy=legacy)[2],
                    batched_scratch_floats(c, d_l, f, b, codes=not legacy, bf16=bf16),
                    cfg.n_layer, len(names))
                print_phases(f"{label} K4 {prec} B={b}" + (f" ({place})" if place else ""),
                             times, names)
    one = {k: v[0] for k, v in states.items()}
    for prec, model in models.items():
        pack = model._mega
        fn = k3_entry(src_dir, pack, flags)
        if fn is None:
            continue
        times = phase_times(
            lambda: decode_launch(fn, pack, one, tokens[:1], cfg, scratch_extra=extra)[2],
            k3_stamps_at(pack, cfg, src_dir, flags), cfg.n_layer)
        print_phases(f"{label} K3 {prec} B=1", times)


def flips(models, cfg, n_seeds: int = 12) -> None:
    """K4 against its plain version by depth over seeded batches of 64, and
    K3 on each batch's first sequence."""
    from rwkv_tpu_torch.models.synth import synth_config
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.ops.megakernel import v7_decode_batched, v7_decode_batched_ref
    from rwkv_tpu_torch.tools.card import rel_err, seeded_states, seq_errors

    worst = {}
    for seed in range(1, n_seeds + 1):
        states, tokens = seeded_states(next(iter(models.values())), cfg, 64, 32, seed=seed)
        for prec, model in models.items():
            for depth in (1, 2, cfg.n_layer):
                cd = synth_config("7.0", depth, cfg.n_embed, cfg.n_vocab, cfg.head_size)
                st = {k: v[:, :depth].contiguous() for k, v in states.items()}
                x, new = v7_decode_batched(model._mega, st, tokens, cd)
                x_ref, new_ref = v7_decode_batched_ref(model._mega, st, tokens, cd)
                keys = sorted(new)
                err, rel, ok = seq_errors([x] + [new[k] for k in keys],
                                          [x_ref] + [new_ref[k] for k in keys])
                out = (~ok).nonzero().flatten().tolist()
                worst[(prec, depth)] = max(worst.get((prec, depth), 0.0), float(rel.max()))
                per8 = int((~ok).reshape(8, 8).sum(dim=1).max())
                print(f"K4 {prec} seed {seed} depth {depth}: {len(out)} of 64 outside 2e-2 "
                      f"{out} (at most {per8} of 8), worst {float(rel.max()):.3e} of its scale, "
                      f"{float(err.max()):.3e} abs; {int((err <= 1e-4).sum())} within 1e-4")
                one = {k: v[0] for k, v in st.items()}
                fn = _cuda.function("v7_decode", M._k3_entry(model._mega),
                                    *M._args(M.DECODE_ARGS, model._mega))
                logits, new3, _ = M.decode_launch(fn, model._mega, one, tokens[:1], cd)
                logits_ref, new3_ref = M.v7_decode_step_ref(model._mega, one, tokens[:1], cd)
                k3 = max([rel_err(logits, logits_ref)]
                         + [rel_err(new3[k], new3_ref[k]) for k in new3])
                print(f"K3 {prec} seed {seed} depth {depth}: {k3:.3e} of the scale, argmax "
                      f"{int(logits.argmax())} vs {int(logits_ref.argmax())}")
    for (prec, depth), w in sorted(worst.items()):
        print(f"K4 {prec} depth {depth}: worst {w:.3e} of a sequence's scale over {n_seeds} "
              f"seeded batches of 64")


def _flat(out):
    """A step's outputs as one list of tensors: a tensor, or (x, state)."""
    if isinstance(out, tuple):
        x, new = out
        return [x] + [new[k] for k in sorted(new)]
    return [out]


def compare(label, cur, old, band=None) -> None:
    """Times of cur() (and old(), in the order old, cur, cur, old); both
    return a tensor, or (x, state dict), to compare: the largest
    difference over all of them is printed, and with `band` (two versions
    whose sums take another order) also the largest over each tensor's
    scale, max(1, max |old|), which must stay within it."""
    from rwkv_tpu_torch.tools.card import device_ms

    if old is None:
        print(f"{label}: {device_ms(cur):.4f} ms")
        return
    pairs = list(zip(_flat(old()), _flat(cur())))
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    note = ""
    if band is not None:
        rel = max(float((a - b).abs().max()) / max(1.0, float(a.abs().max())) for a, b in pairs)
        note = f", {rel:.3e} of the scale; band {band:g}" + ("" if rel <= band else ": OUTSIDE")
    times = [device_ms(f) for f in (old, cur, cur, old)]
    print(f"{label}: baseline {times[0]:.4f} / {times[3]:.4f} ms, current "
          f"{times[1]:.4f} / {times[2]:.4f} ms (outputs differ by at most {diff:.3e}{note})")


def has_entry(lib_name: str, src, name: str) -> bool:
    """Whether the library built from `src` has the C entry `name` (an
    earlier version may lack a form's entry)."""
    from rwkv_tpu_torch.ops import _cuda

    return hasattr(_cuda.library(lib_name, src), name)


def decode_entry_name(pack) -> str:
    """The C entry name of K6, K7 or K8 for `pack`'s version and form."""
    from rwkv_tpu_torch.ops import megakernel as M

    return M._k6_entry(pack) if pack["version"] == 6 else M._v45_entry(pack)


# K4's timed (precision, B): w8a8 and w4a8 at B = 1 to 256 (MEGA_MAX_BATCH;
# 3, 9 and 17 leave a ragged n-tile), bf16 at 1, 8, 64, 128 and 256; at
# the 1.5B width (2 layers) the int forms at B = 1 to 64, bf16 at 1 and 3
K4_TIMED = tuple((p, b) for p in ("w8a8", "w4a8") for b in (1, 3, 8, 9, 17, 64, 128, 256)) + tuple(
    ("bf16", b) for b in (1, 8, 64, 128, 256))
K4_TIMED_WIDE = tuple((p, b) for p in ("w8a8", "w4a8") for b in (1, 3, 8, 9, 17, 64)) + (
    ("bf16", 1), ("bf16", 3))
# the band K4's bf16 form is held to against an earlier source whose f32
# sums take another order (of each tensor's scale, as its plain version)
K4_BF16_BAND = 1e-4

# per version: the phases of a layer of the B=1 decode kernel, the width
# it is measured at and, for the flips, extra (label, width) packs cut to 1
# and 2 layers
B1_PHASES = {6: V6_PHASES, 5: PHASES, 4: "ABEF"}
B1_EXTRA = {6: (), 5: (("v5.1", ("5.1", 2, 2048, 65536, 64)),),
            4: (("C=2048", ("4.0", 2, 2048, 65536, 64)),)}


def b1_flips(models, cfg, label: str, n_seeds: int = 12, depths=None) -> dict:
    """K6, K7 or K8 against its plain version by depth, one seeded state
    per seed: prints each reading; returns the worst per (format, depth)."""
    from rwkv_tpu_torch.tools.card import decode_vs_plain, seeded_states

    depths = depths or (1, 2, cfg.n_layer)
    worst = {}
    for seed in range(1, n_seeds + 1):
        states, tokens = seeded_states(next(iter(models.values())), cfg, 1, 16, seed=seed)
        one, tok = {k: v[0] for k, v in states.items()}, tokens[:1]
        for prec, model in models.items():
            for depth in depths:
                e = decode_vs_plain(model._mega, cfg, one, tok, depth)
                key = (prec, depth)
                worst[key] = max(worst.get(key, 0.0), *e.values())
                print(f"{label} {prec} seed {seed} depth {depth}: x {e['x']:.3e}, state "
                      f"{e['state']:.3e}, logits {e['logits']:.3e} of their scale")
    for (prec, depth), w in sorted(worst.items()):
        print(f"{label} {prec} depth {depth}: worst {w:.3e} of the scale over {n_seeds} seeds")
    return worst


def stamps_at(pack, cfg, version: int, src_path, flags: tuple) -> int:
    """Float offset of the timing build's stamps in the scratch of K6, K7
    or K8 (`version`) for the source `src_path` (None: csrc): behind the
    per-layer amax slots where that source streams its inputs and publishes
    its amax (it has the ``rwkv_v<version>_decode_plan`` entry), else
    behind the activations alone."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.megakernel import v6_scratch_floats, v45_scratch_floats

    name = f"v{version}_decode"
    src = _cuda.CSRC / f"{name}.cu" if src_path is None else src_path
    streamed = hasattr(_cuda.library(name + "_probe", src, flags), f"rwkv_{name}_plan")
    layers = cfg.n_layer if streamed else 0
    if version == 6:
        return v6_scratch_floats(cfg.n_embed, pack["d_maa"], pack["d_dec"], pack["f_dim"], layers)
    return v45_scratch_floats(version, cfg.n_embed, pack["f_dim"], layers)


def b1_main(args, base_dir, version: int) -> int:
    """--v6 / --v5 / --v4: the B=1 decode kernel's time per launch at its
    published width (against ``base_dir/v<version>_decode.cu`` where given),
    and per phase (--phases) and its drift from the plain version by depth
    (--flips)."""
    from rwkv_tpu_torch.tools.card import (
        V4_WIDTH, V5_WIDTH, V6_WIDTH, card_line, decode_entry, decode_launcher, seeded_states,
        width_models,
    )

    width = {6: V6_WIDTH, 5: V5_WIDTH, 4: V4_WIDTH}[version]
    name = {6: "K6", 5: "K7", 4: "K8"}[version]
    precisions = _precisions(args)
    cfg, models = width_models(width, precisions=precisions)
    states, tokens = seeded_states(next(iter(models.values())), cfg, 1, 16, seed=1)
    one, tok = {k: v[0] for k, v in states.items()}, tokens[:1]
    src = f"v{version}_decode.cu"
    srcs = {"current": None}
    if base_dir is not None and (base_dir / src).exists():
        srcs["baseline"] = base_dir / src
    for prec, model in models.items():
        pack = model._mega
        launch, _, _ = decode_launcher(pack)

        def run(src_path, flags=(), extra=0):
            fn = decode_entry(pack, src_path, flags)
            return launch(fn, pack, one, tok, cfg, scratch_extra=extra)

        old = None
        if "baseline" in srcs and has_entry(f"v{version}_decode_probe", srcs["baseline"],
                                            decode_entry_name(pack)):
            old = lambda: run(srcs["baseline"])[0]  # noqa: E731
        compare(f"{name} {prec} B=1", lambda: run(None)[0], old)
        names = B1_PHASES[version]
        for label, src_path in srcs.items() if "--phases" in args else ():
            extra = 2 * (2 + 2 * len(names) * cfg.n_layer)
            flags = ("-DRWKV_PHASE_TIMES",)
            times = phase_times(lambda: run(src_path, flags, extra)[2],
                                stamps_at(pack, cfg, version, src_path, flags), cfg.n_layer,
                                len(names))
            print_phases(f"{label} {name} {prec} B=1", times, names)
    if "--flips" in args:
        b1_flips(models, cfg, name)
        del models
        for label, extra_width in B1_EXTRA[version]:
            cfg_x, models_x = width_models(extra_width, precisions=precisions)
            b1_flips(models_x, cfg_x, f"{name} {label}", depths=(1, 2))
            del models_x
    print(card_line())
    return 0


# -- --tp6 / --tp7 / --tp5 / --tp4: the stream TP kernels (one shard's layer) ------

# (version, the shard kernels timed) at tp=2 and 4 by flag: K12 / K13 at
# the v6 1.6B width and K13 MIX45 at the v5.2 World 1.5B width (--tp6),
# K10 at the v7 World 1.5B width (d_lora 96) reading v_first and writing
# it ("K10 first") and K11 (--tp7), K15 on v5.2 and v5.1 at the World 1.5B
# width (--tp5), K14 and K13 MIX45 at the v4 World 1.5B width (--tp4)
TP_CASES = {"--tp6": (("6.0", ("K12", "K13")), ("5.2", ("K13 mix45",))),
            "--tp7": (("7.0", ("K10", "K10 first", "K11")),),
            "--tp5": (("5.2", ("K15",)), ("5.1", ("K15",))),
            "--tp4": (("4.0", ("K14", "K13 mix45")),)}
# phases of the timing build (P: the prologue before the first phase), then the tail
TP_PHASES = {"K12": ("PAMBC", "D"), "K13": ("PA", "B"), "K13 mix45": ("PA", "B"),
             "K10": ("PAB", "C"), "K10 first": ("PAB", "C"), "K15": ("PAC", "D"),
             "K11": ("PA", "B"), "K14": ("PA", "B")}
_FFN_NAMES = ("K11", "K13", "K13 mix45")
TP6_STAMP_FLOATS = 64  # room for the timing build's stamps behind the scratch
V7_TP_LORA = 96  # the v7 World 1.5B LoRA width (chip_smoke.py's)


def tp_width_packs(version: str, precision: str, tp: int, c: int = 2048):
    """(cfg, shard packs on this card) of a seeded 2-layer synth model of
    `version` at width c (F = 4c, V=256; v7 with LoRAs of V7_TP_LORA) in
    `precision`, over tp shards."""
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.ops import megakernel_tp as TP
    from rwkv_tpu_torch.parallel.sharding import make_mesh

    cfg = synth_config(version, 2, c, 256, 64)
    v = cfg.version_major
    params = synth_params(cfg, seed=0, **({"lora_dim": V7_TP_LORA} if v == 7 else {}))
    build = {7: M.build_mega_pack, 6: M.build_mega_pack_v6, 5: M.build_mega_pack_v5,
             4: M.build_mega_pack_v4}[v]
    build_tp = {7: TP.build_mega_pack_tp, 6: TP.build_mega_pack_tp_v6,
                5: TP.build_mega_pack_tp_v5, 4: TP.build_mega_pack_tp_v4}[v]
    base = build(params, cfg, w4=precision == "w4a8", quant=precision != "bf16")
    return cfg, build_tp(base, cfg, make_mesh(1, tp, devices=["cuda:0"] * tp))


def tp_inputs(pk, cfg, seed: int = 1) -> tuple:
    """x, att_xx, ffn_xx, the shard's part of the state (a tuple: its heads;
    v4: its aa, bb, pp) and a v_first of its channels, seeded."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c, s, c_loc = cfg.n_embed, cfg.head_size, pk["c_loc"]
    x, xx, fxx = (torch.randn((c,), device="cuda", generator=gen) * a for a in (0.5, 0.3, 0.3))
    if cfg.version_major == 4:
        own = (torch.randn((c_loc,), device="cuda", generator=gen) * 0.3,
               torch.randn((c_loc,), device="cuda", generator=gen).abs() + 1.0,
               torch.randn((c_loc,), device="cuda", generator=gen) * 0.5)
    else:
        own = (torch.randn((c_loc // s, s, s), device="cuda", generator=gen) * 0.1,)
    vf = torch.randn((c_loc,), device="cuda", generator=gen) * 0.3
    return x, xx, fxx, own, vf


def tp_sources(args) -> dict:
    """{label: (csrc directory, or None for csrc's; {kernel: phase names})}
    in timing order: "baseline" (the first DIR after ``--baseline``), then
    "current", then each further DIR by its directory's name. A DIR may end
    in ``#K12=NAMES#K13=NAMES``: the phases of a copy that stamps more often
    (one letter a pair of stamps)."""
    dirs = []
    if "--baseline" in args:
        for arg in args[args.index("--baseline") + 1:]:
            if arg.startswith("--"):
                break
            d, *extra = arg.split("#")
            dirs.append((Path(d), dict(e.split("=", 1) for e in extra)))
    srcs = {}
    for k, (d, names) in enumerate(dirs):
        srcs["baseline" if k == 0 else d.name] = (d, names)
        if k == 0:
            srcs["current"] = (None, {})
    return srcs or {"current": (None, {})}


def tp_kernel_src(name: str, src_dir):
    """The source file of TP kernel `name` in `src_dir` (None: csrc): K10's
    tp_v7.cu; K12's and K13's tp_v6.cu; K14's tp_v45.cu; K15's tp_v6.cu, or
    tp_v45.cu in a tree from before K15 moved there; K11's tp_v6.cu, or
    tp_v7.cu in a tree from before K11 moved there."""
    from rwkv_tpu_torch.ops import _cuda

    d = _cuda.CSRC if src_dir is None else Path(src_dir)
    if name.startswith("K10") or name == "K14":
        return d / ("tp_v7.cu" if name.startswith("K10") else "tp_v45.cu")
    entry = {"K15": "rwkv_tp_v5_att", "K11": "rwkv_tp_v7_ffn"}.get(name)
    if entry and entry not in (d / "tp_v6.cu").read_text():
        return d / ("tp_v45.cu" if name == "K15" else "tp_v7.cu")
    return d / "tp_v6.cu"


def tp6_stamps_at(pk, cfg, name: str, src, flags: tuple):
    """Float offset of the timing build's stamps in the scratch of kernel
    `name` built from the file `src`: behind the amax slots of a streamed
    source (it has a plan entry), else behind the activations alone; None
    for K11 and K14 from before they ran on the stream (no stamps)."""
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    c, c_loc, f_loc, _, dm, dd, _ = TP._tp6_dims(pk, cfg)
    if name.startswith("K13"):
        return f_loc
    if name == "K11":
        return f_loc if src.name == "tp_v6.cu" else None
    lib = _cuda.library(src.stem + "_probe", src, flags)
    if name == "K14":
        return 3 * c_loc if hasattr(lib, "rwkv_tp_v4_plan") else None
    if name.startswith("K10"):
        streamed = hasattr(lib, "rwkv_tp_v7_plan")
        return 4 * c_loc + 4 * pk["d_lora"] + (TP.TP7_ATT_AMAX if streamed else 0)
    slots = TP.TP6_ATT_AMAX if hasattr(lib, "rwkv_tp_v6_plan") else 0
    if name == "K15":
        return 5 * c_loc + (slots if src.name == "tp_v6.cu" else 0)
    return 5 * dm + 5 * c + 5 * c_loc + dd + slots


def tp6_runner(pk, cfg, name: str, src_dir=None, flags: tuple = (), grid=None,
               stamps: bool = False):
    """run() of one launch of TP kernel `name` (K10, "K10 first", K11, K12,
    K13, "K13 mix45", K14, K15) on shard pack pk, layer 1, from csrc or the
    sources in
    `src_dir` with nvcc `flags`, over `grid` blocks (None: the current
    kernel's grid, one block an SM, which an earlier version takes too).
    run() returns the outputs as one tensor or, with `stamps`, the scratch
    (zeroed, with room for the timing build's stamps)."""
    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    kind = "ffn" if name in _FFN_NAMES else "att"
    if src_dir is None and not flags:
        fn = TP.tp6_function(pk, kind)
    else:
        src = tp_kernel_src(name, src_dir)
        fn = _cuda.function(src.stem + "_probe", TP._lib_entry(kind, pk)[1],
                            *TP.TP_ARGS[TP._plan_kind(pk, kind)], src=src, flags=flags)
    grid = grid or TP.tp6_grid(pk, kind, cfg)
    x, xx, fxx, own, vf = tp_inputs(pk, cfg)
    launch, ins = {
        "K12": (TP.tp6_att_launch, (x, xx, *own)), "K13": (TP.tp6_ffn_launch, (x, fxx)),
        "K13 mix45": (TP.tp6_ffn_launch, (x, fxx)), "K15": (TP.tp5_att_launch, (x, xx, *own)),
        "K10": (TP.tp7_att_launch, (x, xx, *own, vf, False)),
        "K10 first": (TP.tp7_att_launch, (x, xx, *own, vf, True)),
        "K11": (TP.tp7_ffn_launch, (x, fxx)), "K14": (TP.tp4_att_launch, (x, xx, *own))}[name]
    n_scratch = (tp6_stamps_at(pk, cfg, name, tp_kernel_src(name, src_dir), flags)
                 + TP6_STAMP_FLOATS if stamps else 0)

    def run():
        out = {"scratch": torch.zeros((n_scratch,), device="cuda")} if stamps else {}
        outs = launch(fn, pk, 1, *ins, cfg, grid, out)
        return out["scratch"] if stamps else torch.cat([t.reshape(-1) for t in outs])

    return run


def flushed_ms(fn, buf) -> float:
    """Device time of fn() as a step of many layers meets it: with the L2
    cache emptied before each launch (a fill of `buf`, larger than the L2,
    then fn()), less the fill's own time."""
    from rwkv_tpu_torch.tools.card import device_ms

    def fill_then():
        buf.zero_()
        fn()

    return device_ms(fill_then) - device_ms(buf.zero_)


def in_turns(runs: dict, timer) -> str:
    """Each of `runs` timed twice, in their order and then back."""
    times = {}
    for k in list(runs) + list(runs)[::-1]:
        times.setdefault(k, []).append(timer(runs[k]))
    return ", ".join(f"{k} {t[0]:.4f} / {t[1]:.4f} ms" for k, t in times.items())


def tp_main(args, flag: str) -> int:
    """--tp6 / --tp7 / --tp5 / --tp4: the stream TP kernels of ``TP_CASES[flag]``
    from csrc against the sources of ``tp_sources`` (outputs at tp = 2 and
    4, csrc's on four grids; times at tp=2, also with the L2 emptied;
    phases)."""
    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.tools.card import card_line, device_ms

    print(card_line())
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")  # over the 50 MB L2
    srcs = tp_sources(args)
    flags = ("-DRWKV_PHASE_TIMES",)
    names = {n for _, ns in TP_CASES[flag] for n in ns}
    _cuda.build_all()  # then every other build at once
    jobs = {(f.stem + "_probe", f, fl) for d, _ in srcs.values() for n in names
            for f in (tp_kernel_src(n, d),) for fl in ((), flags)
            if (d is not None or fl) and (not fl or "--phases" in args)}
    _cuda._build(sorted(jobs, key=str))
    for version, kernels in TP_CASES[flag]:
        for prec in _precisions(args):
            for tp in (2, 4):
                cfg, packs = tp_width_packs(version, prec, tp)
                pk = packs[0]
                for name in kernels:
                    label = f"{name} v{version} {prec} tp={tp} nf={pk['nf']}"
                    runs = {k: tp6_runner(pk, cfg, name, d) for k, (d, _) in srcs.items()}
                    if "baseline" not in runs:
                        if tp == 2:
                            print(f"{label}: {device_ms(runs['current']):.4f} ms")
                        continue
                    want = runs["baseline"]()
                    diff = max(float((tp6_runner(pk, cfg, name, grid=g)() - want).abs().max())
                               for g in (132, 64, 33, 7))
                    note = (f"outputs differ by at most {diff:.3e} on grids 132 / 64 / 33 / 7"
                            + "".join(f"; {k} by {float((r() - want).abs().max()):.3e}"
                                      for k, r in runs.items() if k not in ("baseline", "current")))
                    if tp != 2:
                        print(f"{label}: {note}")
                        continue
                    print(f"{label}: {in_turns(runs, device_ms)} ({note})")
                    print(f"{label}, L2 emptied before each launch: "
                          + in_turns(runs, lambda f: flushed_ms(f, flush)))
                    if "--phases" not in args:
                        continue
                    for k, (d, named) in srcs.items():
                        phases, tail = TP_PHASES[name]
                        phases = named.get(name.split()[0], phases)
                        at = tp6_stamps_at(pk, cfg, name, tp_kernel_src(name, d), flags)
                        if at is None:
                            continue
                        times = phase_times(tp6_runner(pk, cfg, name, d, flags, stamps=True), at,
                                            1, len(phases))
                        print_phases(f"{k} {label}", times, phases, tail)
                del packs
                torch.cuda.empty_cache()
    print(card_line())
    return 0


def _precisions(args) -> tuple:
    return ("bf16",) if "--bf16" in args else ("w8a8", "w4a8", "bf16")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_batched: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    base_dir = Path(args[args.index("--baseline") + 1]) if "--baseline" in args else None
    for version in (6, 5, 4):
        if f"--v{version}" in args:
            return b1_main(args, base_dir, version)
    for flag in TP_CASES:
        if flag in args:
            return tp_main(args, flag)
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import megakernel as TM
    from rwkv_tpu_torch.tools.card import card_line, seeded_states

    print(card_line())
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    params = synth_params(cfg, seed=0)
    models = {p: ServingModel((cfg, params), precision=p, megakernel=True)
              for p in _precisions(args)}
    states, tokens = seeded_states(next(iter(models.values())), cfg, 256, 32, seed=1)
    if "--flips" in args:
        flips(models, cfg)
        print(card_line())
        return 0
    if "--phases" in args:
        k4 = "--k3" not in args
        phase_split(models, cfg, states, tokens, None, "current", k4)
        if base_dir is not None:
            phase_split(models, cfg, states, tokens, base_dir, "baseline", k4)
        print(card_line())
        return 0

    one = {k: v[0] for k, v in states.items()}
    for prec, model in models.items():
        pack = model._mega
        fn = None
        if base_dir is not None and (base_dir / "v7_decode.cu").exists():
            fn = k3_entry(base_dir, pack)
        cur = lambda: TM.v7_decode_step(pack, one, tokens[:1], cfg)[0]  # noqa: E731
        old = None if fn is None else (
            lambda: TM.decode_launch(fn, pack, one, tokens[:1], cfg)[0])  # noqa: E731
        compare(f"K3 {prec} B=1", cur, old)
    if "--k3" in args:
        print(card_line())
        return 0
    k4_against(models, cfg, states, tokens, base_dir, K4_TIMED)
    crossover_places(models, cfg, states, tokens)
    del models, states
    # the 1.5B width (2 layers), where ServingModel takes K4 at B=1
    wide = synth_config("7.0", 2, 2048, 65536, 64)
    wide_params = synth_params(wide, seed=0)
    models = {p: ServingModel((wide, wide_params), precision=p, megakernel=True)
              for p in _precisions(args)}
    if models:
        states, tokens = seeded_states(next(iter(models.values())), wide, 64, 16, seed=6)
        k4_against(models, wide, states, tokens, base_dir, K4_TIMED_WIDE, " C=2048 L=2")
        crossover_places(models, wide, states, tokens, (1, 2, 4, 8), " C=2048 L=2")
    print(card_line())
    return 0


def k4_against(models, cfg, states, tokens, base_dir, cases, label: str = "") -> None:
    """K4 at each (precision, B) of `cases` (where `models` has the
    precision), against ``base_dir``'s source where given: outputs and
    times (``compare``)."""
    from rwkv_tpu_torch.ops import megakernel as TM

    for prec, b in cases:
        if prec not in models:
            continue
        pack = models[prec]._mega
        st = {k: v[:b].contiguous() for k, v in states.items()}
        tok = tokens[:b].contiguous()
        cur = lambda: TM.v7_decode_batched(pack, st, tok, cfg)  # noqa: E731
        old = None
        entry = None
        if base_dir is not None and (base_dir / "v7_decode_batched.cu").exists():
            entry = k4_entry(base_dir, pack)
        if entry is not None:
            fn, grid_fn, legacy = entry
            dims = (cfg.n_embed, cfg.head_size, pack["d_lora"], pack["f_dim"])
            grid = grid_fn(*dims, *(() if pack["form"] == "bf16" else (int(pack["w4"]),)))
            old = lambda: TM.batched_launch(fn, pack, st, tok, cfg, grid,  # noqa: E731
                                            legacy=legacy)[:2]
        compare(f"K4 {prec}{label} B={b}", cur, old,
                K4_BF16_BAND if pack["form"] == "bf16" else None)


def crossover_places(models, cfg, states, tokens, batches=(1, 8, 9, 12, 16, 24, 32, 48, 64),
                     label: str = "") -> None:
    """K4 at each B of `batches` in each placement that has a plan: the
    readings that set K4_PLACE_A_MAX_B (ops/megakernel.py)."""
    from rwkv_tpu_torch.ops import megakernel as TM
    from rwkv_tpu_torch.tools.card import device_ms

    for prec in ("w8a8", "w4a8", "bf16"):
        if prec not in models:
            continue
        pack = models[prec]._mega
        TM.v7_decode_batched(pack, {k: v[:1] for k, v in states.items()}, tokens[:1], cfg)
        grid, fn = pack["_grid_batched"], TM.k4_function(pack)
        for b in batches:
            st = {k: v[:b].contiguous() for k, v in states.items()}
            tok = tokens[:b].contiguous()
            times = {place: device_ms(lambda: TM.batched_launch(fn, pack, st, tok, cfg, grid,
                                                                place=place))
                     for place in k4_places(pack, cfg, b, False, grid)}
            print(f"K4 {prec}{label} B={b} by placement: " + ", ".join(
                f"({p}) {t:.4f} ms" for p, t in times.items())
                + f"; the plan takes ({TM.k4_plan(pack, b, cfg, grid).place})")


if __name__ == "__main__":
    sys.exit(main())
