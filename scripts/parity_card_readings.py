#!/usr/bin/env python3
"""The parity engine's card-against-CPU readings, with no limit.

    python3 scripts/parity_card_readings.py

Runs on one CUDA card, from the root of the repo. Prints, for each
quantized file that ``chip_smoke.py`` holds the parity engine to, the
distance between ``RWKVModel`` on the card and ``RWKVModel(path,
device="cpu")`` as a share of the CPU's scale, on the prompt and at every
greedy step: the small files of ``small_parity_check`` (v7, v6, v5.2,
v5.1, v4 at L=2, C=256 in Q4_1, Q5_0, Q8_0 and Q5_K) and the 169M files of
``phase_parity`` (Q4_0, Q5_1, Q4_K, the same prompt and steps). The
smoke's PARITY_QUANT_REL and PARITY_SMALL_QUANT_REL are set from these
readings. Needs no kernel build (the parity engine is plain PyTorch).
"""
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from rwkv_tpu_torch.io.quantize import quantize_model_file  # noqa: E402
from rwkv_tpu_torch.models.model import RWKVModel  # noqa: E402
from rwkv_tpu_torch.models.synth import synth_config, synth_params  # noqa: E402
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    S.PARITY_SMALL_QUANT_REL = math.inf
    t_all = time.perf_counter()
    for version in ("7.0", "6.0", "5.2", "5.1", "4.0"):
        for fmt in ("Q4_1", "Q5_0", "Q8_0", "Q5_K"):
            S.small_parity_check("cuda", version, fmt)
    print(f"small files done in {time.perf_counter() - t_all:.1f} s", flush=True)
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    params = synth_params(cfg, seed=0)
    prompt = np.random.default_rng(11).integers(0, cfg.n_vocab, S.PARITY_PROMPT).tolist()
    with tempfile.TemporaryDirectory() as tmp:
        f32 = os.path.join(tmp, "f32.bin")
        write_synth_ggmf(cfg, params, f32)
        for fmt in ("Q4_0", "Q5_1", "Q4_K"):
            path = os.path.join(tmp, f"{fmt}.bin")
            quantize_model_file(f32, path, fmt, verbose=False)
            gpu, cpu = RWKVModel(path), RWKVModel(path, device="cpu")
            r = S.parity_run(gpu, cpu, prompt, S.PARITY_CHUNK, S.PARITY_GREEDY, math.inf, fmt)
            print(f"parity 169M {fmt}: {S.parity_line(r)}; picks equal at {r['agree']} of "
                  f"{S.PARITY_GREEDY}; {r['ms_token']:.2f} ms a token", flush=True)
            del gpu, cpu
            torch.cuda.empty_cache()
    print(f"all done in {time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
