#!/usr/bin/env python3
"""Where kernel K3's decode step spends its time, on the card.

    python3 scripts/probe_torch_decode.py

Times one launch of ``rwkv_tpu_torch.ops.megakernel.v7_decode_step`` (device
time, launches queued behind a spin kernel so no host time is counted) for
the 169M v7 shape (C=768, H=12, V=65536, synth seed 0, w8a8):

- at depth L = 2, 4, 8 and 12 (the per-layer cost is the slope, the fixed
  cost -- embedding, ln_out, the 50 MB head -- the intercept);
- at the full depth with the cooperative grid at 33, 66 and 132 blocks
  and at its default, one block per SM (the kernel's shared-memory ring
  takes a whole SM, so a grid of more blocks than SMs cannot launch).

With ``--phases`` it instead builds ``csrc/v7_decode.cu`` with
``-DRWKV_PHASE_TIMES`` (thread 0 of block 0 stamps ``%globaltimer``
before and after every grid barrier) and prints, at L=12, the mean time of
each phase of a layer and of each barrier, the head phase and the total.

Prints one line per measurement and the card (nvidia-smi name and power
limit). Needs a CUDA device; builds the kernels on first use.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def phase_split(model, state, cfg, tok, reps: int = 5) -> None:
    """Per-phase device times from the timing build of the decode kernel."""
    import ctypes
    import subprocess

    import numpy as np
    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.megakernel import decode_launch, decode_scratch_floats

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _cuda.BUILD_DIR / "v7_decode_phase_times.so"
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-DRWKV_PHASE_TIMES", "-o",
                    str(lib_path), str(_cuda.CSRC / "v7_decode.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).rwkv_v7_decode
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pack = model._mega
    base = decode_scratch_floats(cfg.n_embed, pack["d_lora"], pack["f_dim"], cfg.n_layer)
    max_marks = 2 + 2 * 8 * cfg.n_layer
    runs = []
    for _ in range(reps + 1):  # the first run warms up
        _, _, scratch = decode_launch(fn, pack, state, tok, cfg, scratch_extra=2 * max_marks)
        torch.cuda.synchronize()
        marks = scratch[base:].cpu().numpy().view(np.uint64).astype(np.int64)
        n = int(np.count_nonzero(marks))
        runs.append(np.diff(marks[:n]) / 1e3)
    d = np.mean(runs[1:], axis=0)  # us between consecutive marks
    n_phase = (len(d) - 1) // (2 * cfg.n_layer)
    per_layer = d[: 2 * n_phase * cfg.n_layer].reshape(cfg.n_layer, n_phase, 2).mean(axis=0)
    for i, (work, sync) in enumerate(per_layer):
        print(f"phase {i + 1} of {n_phase}: {work:.2f} us, then barrier {sync:.2f} us (mean per layer)")
    print(f"head phase: {d[-1]:.2f} us; total {d.sum():.1f} us per step "
          f"(timing build, block 0, mean of {reps})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_decode: no CUDA device", file=sys.stderr)
        return 1
    from rwkv_tpu_torch.tools.card import card_line, device_ms
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops.megakernel import v7_decode_step

    print(card_line())
    tok = torch.tensor([5], device="cuda")
    if "--phases" in sys.argv[1:]:
        cfg = synth_config("7.0", 12, 768, 65536, 64)
        model = ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8", megakernel=True)
        phase_split(model, {k: v[0] for k, v in model.init_state(1).items()}, cfg, tok)
        return 0
    full = None
    for n_layer in (2, 4, 8, 12):
        cfg = synth_config("7.0", n_layer, 768, 65536, 64)
        model = ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8", megakernel=True)
        state = {k: v[0] for k, v in model.init_state(1).items()}
        ms = device_ms(lambda: v7_decode_step(model._mega, state, tok, cfg), reps=50)
        print(f"L={n_layer}: {ms * 1e3:.1f} us per step (grid {model._mega['_grid']} blocks)")
        full = (model, state, cfg)
    model, state, cfg = full
    default = model._mega["_grid"]
    for grid in sorted({g for g in (33, 66, 132) if g <= default} | {default}):
        model._mega["_grid"] = grid
        ms = device_ms(lambda: v7_decode_step(model._mega, state, tok, cfg), reps=50)
        print(f"L=12 grid {grid} blocks: {ms * 1e3:.1f} us per step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
