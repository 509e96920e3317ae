#!/usr/bin/env python3
"""Kernel K3 built from several copies of its sources, on the card.

    python3 scripts/probe_torch_k3_variants.py [--sass] DIR [DIR ...]
    python3 scripts/probe_torch_k3_variants.py --stamps DIR

Each DIR is a copy of ``rwkv_tpu_torch/csrc`` (an edited copy, or the
parent's from ``git archive``; ``tree`` names the checkout's own). On the
169M v7 models (synth seed 0, w8a8, w4a8 and bf16) from a seeded state,
it prints, per form, each version's device time a launch -- in the order
first .. last, last .. first, so each is timed twice in one call -- and
the largest difference of its outputs (logits and state) from the first
version's, then each version's ptxas report (registers, spills). With
``--sass`` it also counts each version's SASS instructions a kernel
(``cuobjdump``) and, of them, the integer divisions and remainders by a
runtime value (one IABS each).

With ``--stamps DIR`` it builds DIR's copy with ``-DRWKV_PHASE_TIMES``
instead -- an instrumented copy may stamp anywhere, a fixed number of
times a layer -- and prints, per form, the mean microseconds between
consecutive stamps of a layer (block 0, layers 1 to L-1, five runs) and
after the last layer.

Prints the card (nvidia-smi name and power limit). Needs a CUDA device;
builds the kernels on first use.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORMS = ("w8a8", "w4a8", "bf16")


def source(d: str) -> Path:
    """The v7_decode.cu of a csrc copy (``tree``: the checkout's)."""
    from rwkv_tpu_torch.ops import _cuda

    return (_cuda.CSRC if d == "tree" else Path(d)) / "v7_decode.cu"


def build_log(src, flags=()) -> list:
    """The ptxas lines of the library built from `src`."""
    from rwkv_tpu_torch.ops import _cuda

    log = _cuda._lib_path("v7_decode_probe", src, flags).with_suffix(".log")
    return [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "spill" in ln] if log.exists() else []


def sass_counts(src) -> list:
    """(instructions, IABS) of each kernel of the library built from `src`."""
    from rwkv_tpu_torch.ops import _cuda

    lib = _cuda._lib_path("v7_decode_probe", src)
    out = subprocess.run([str(Path(_cuda.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                         check=True, capture_output=True, text=True).stdout
    counts = []
    for fn in out.split("Function : ")[1:]:
        ins = [ln for ln in fn.splitlines() if ln.strip().startswith("/*") and ";" in ln]
        counts.append((len(ins), sum(" IABS " in ln for ln in ins)))
    return counts


def models():
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.tools.card import seeded_states

    cfg = synth_config("7.0", 12, 768, 65536, 64)
    params = synth_params(cfg, seed=0)
    for prec in FORMS:
        model = ServingModel((cfg, params), precision=prec, megakernel=True)
        states, tokens = seeded_states(model, cfg, 2, 32, seed=1)
        yield prec, cfg, model._mega, {k: v[0] for k, v in states.items()}, tokens[:1]
        del model


def compare(dirs, sass: bool) -> None:
    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.tools.card import device_ms
    from rwkv_tpu_torch.tools.probe_batched import _flat, k3_entry

    for prec, cfg, pack, state, token in models():
        M.v7_decode_step(pack, state, token, cfg)  # the grid
        fns = [k3_entry(None if d == "tree" else Path(d), pack) for d in dirs]
        runs = [lambda fn=fn: M.decode_launch(fn, pack, state, token, cfg)[:2] for fn in fns]
        outs = [_flat(run()) for run in runs]
        diffs = [max(float((a - b).abs().max()) for a, b in zip(o, outs[0])) for o in outs]
        times = {i: [] for i in range(len(dirs))}
        for i in list(range(len(dirs))) + list(reversed(range(len(dirs)))):
            times[i].append(device_ms(runs[i], reps=30))
        print(f"K3 {prec}: " + "; ".join(
            f"{d} {times[i][0]:.4f} / {times[i][1]:.4f} ms (outputs differ by {diffs[i]:.1e})"
            for i, d in enumerate(dirs)))
    for d in dirs:
        print(f"{d}: " + " | ".join(build_log(source(d))))
        if sass:
            print(f"{d}: SASS instructions, IABS a kernel: {sass_counts(source(d))}")


def stamps(d: str, reps: int = 5) -> None:
    import numpy as np
    import torch

    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.tools.probe_batched import k3_entry, k3_stamps_at

    flags = ("-DRWKV_PHASE_TIMES",)
    for prec, cfg, pack, state, token in models():
        fn = k3_entry(Path(d), pack, flags)
        base = k3_stamps_at(pack, cfg, Path(d), flags)
        runs = []
        for _ in range(reps + 1):  # the first run warms up
            scratch = M.decode_launch(fn, pack, state, token, cfg, scratch_extra=2 * 4096)[2]
            torch.cuda.synchronize()
            marks = scratch[base:].cpu().numpy().view(np.uint64).astype(np.int64)
            runs.append(np.diff(marks[: int(np.count_nonzero(marks))]) / 1e3)
        d_us = np.mean(runs[1:], axis=0)
        per = (len(d_us) - 1) // cfg.n_layer  # stamps a layer
        layers = d_us[: per * cfg.n_layer].reshape(cfg.n_layer, per)[1:].mean(axis=0)
        print(f"K3 {prec}: {per} intervals a layer, us: "
              + ", ".join(f"{t:.2f}" for t in layers)
              + f"; after the last layer {d_us[per * cfg.n_layer:].sum():.2f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_k3_variants: no CUDA device", file=sys.stderr)
        return 1
    from rwkv_tpu_torch.tools.card import card_line

    args = sys.argv[1:]
    print(card_line())
    if "--stamps" in args:
        stamps(args[args.index("--stamps") + 1])
    else:
        compare([a for a in args if not a.startswith("--")], "--sass" in args)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
