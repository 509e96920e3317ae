#!/usr/bin/env python3
"""The card-vs-CPU readings of ``chip_smoke.py``'s ``phase_reservoir`` over
several task seeds, with its readout limits lifted, to set them from.

    python3 scripts/reservoir_card_readings.py [SEED ...]   (default 23 24 25 26)

Needs a CUDA device. Builds the kernels, the 169M w8a8 ServingModel (K3 for
the profiling part) and the 169M FP32 and Q5_1 files (synth seed 0) in a
temporary directory, loads them as RWKVModel on the card and the CPU, then
runs the phase once a seed. The phase prints every reading; a trace that
records no device activity is reported and counted instead of raising.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("reservoir_card_readings: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from rwkv_tpu_torch.io.quantize import quantize_model_file
    from rwkv_tpu_torch.models.model import RWKVModel
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.tools.card import card_line
    from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

    seeds = [int(a) for a in sys.argv[1:]] or [23, 24, 25, 26]
    CS.RES_RIDGE_REL = {k: float("inf") for k in CS.RES_RIDGE_REL}
    CS.RES_READOUT_REL = {k: float("inf") for k in CS.RES_READOUT_REL}
    check, failures = CS.trace_check, []

    def lenient_check(tr, label, card, kernel=None):
        try:
            check(tr, label, card, kernel)
        except AssertionError as e:
            failures.append(str(e))
            print("trace failure:", e)

    CS.trace_check = lenient_check
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    params = synth_params(cfg, seed=0)
    model = ServingModel((cfg, params), precision="w8a8", megakernel=True)
    prompt = torch.randint(0, cfg.n_vocab, (256,),
                           generator=torch.Generator().manual_seed(0)).numpy()
    logits, state = model.prefill(prompt)
    token = logits.argmax().reshape(1).to(torch.int32)
    with tempfile.TemporaryDirectory(prefix="rwkv_res_") as tmp:
        src = os.path.join(tmp, "v7-169m-FP32.bin")
        write_synth_ggmf(cfg, params, src)
        t0 = time.perf_counter()
        quantize_model_file(src, os.path.join(tmp, "v7-169m-Q5_1.bin"), "Q5_1", verbose=False)
        seconds = {"Q5_1": time.perf_counter() - t0}
        models = {f: (RWKVModel(os.path.join(tmp, f"v7-169m-{f}.bin")),
                      RWKVModel(os.path.join(tmp, f"v7-169m-{f}.bin"), device="cpu"))
                  for f in ("FP32", "Q5_1")}
        for seed in seeds:
            CS.RES_SEED = seed
            print(f"== task seed {seed}")
            CS.phase_reservoir(models, model, state, token, card, tmp, dict(seconds))
    print(f"traces without device activity: {len(failures)} of {2 * len(seeds)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
