#!/usr/bin/env python3
"""The tensor-parallel B=1 decode's tok/s on one card, to compare two trees.

    python3 scripts/time_torch_tp_step.py [VERSION ...]

For each VERSION (7.0, 6.0, 5.2, 4.0; by default all four) it builds the
model at its tensor-parallel width as ``chip_smoke.py`` does (synth seed 0,
24 layers, w8a8, ``megakernel=True``, a tp=2 mesh on this card: K10 / K11,
K12 / K13, K15 / K13 mix45 or K14 / K13 mix45), prefills a 16-token
prompt, runs 8 greedy B=1 decode steps to warm up, then times 5 runs of 32
greedy steps on the host clock, each ended by a synchronisation, and prints
their median tok/s with all five, and the card (name and power limit).

It imports the package of the tree it lies in: to compare two trees, copy
it into the other tree's ``scripts/`` and run both copies in turns (A, B,
B, A) in one call. Needs a CUDA device; builds the kernels on first use.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS, RUNS = 32, 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_torch_tp_step: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import V4_TP_WIDTH, V7_TP_LORA, V7_TP_WIDTH
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.parallel.sharding import make_mesh
    from rwkv_tpu_torch.tools.card import V5_WIDTH, V6_WIDTH, card_line

    widths = {"7.0": V7_TP_WIDTH, "6.0": V6_WIDTH, "5.2": V5_WIDTH, "4.0": V4_TP_WIDTH}
    print(card_line())
    for version in sys.argv[1:] or list(widths):
        cfg = synth_config(*widths[version])
        kw = {"lora_dim": V7_TP_LORA} if cfg.version_major == 7 else {}
        model = ServingModel((cfg, synth_params(cfg, seed=0, **kw)), precision="w8a8",
                             megakernel=True, mesh=make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
        prompt = torch.randint(0, cfg.n_vocab, (16,),
                               generator=torch.Generator().manual_seed(0)).numpy()
        logits, state = model.prefill(prompt)

        def steps(n: int):
            nonlocal logits, state
            for _ in range(n):
                lg, state = model.decode(logits.argmax().reshape(1), state)
                logits = lg[0]
            torch.cuda.synchronize()

        steps(8)
        rates = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            steps(STEPS)
            rates.append(STEPS / (time.perf_counter() - t0))
        print(f"v{version} C={cfg.n_embed} L={cfg.n_layer} tp=2 w8a8: median "
              f"{statistics.median(rates):.1f} tok/s ({', '.join(f'{r:.1f}' for r in rates)})",
              flush=True)
        del model, logits, state
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
