#!/usr/bin/env python3
"""Where the port's main path spends its time, from a torch.profiler trace.

    python3 scripts/profile_torch_main_path.py [--tp[=7.0|6.0|5.2|4.0]]
    python3 scripts/profile_torch_main_path.py [--v6] --baseline DIR

Builds the 169M v7 model as ``chip_smoke.py`` does (synth seed 0, w8a8,
``megakernel=True``; with --tp a model at its tensor-parallel width --
v7 World 1.5B, LoRA 96 (the default), v6 1.6B, v5.2 World 1.5B or v4
World 1.5B -- over a tp=2 mesh on this card, its B=1 decode on K10 / K11,
K12 / K13, K15 / K13 mix45 or K14 / K13 mix45), warms every path up,
then traces one 256-token
prefill and 8 greedy B=1 decode steps. For each it prints the wall time
(host clock around synchronised work), the device busy time (the sum of
the kernels' and copies' durations in the CUDA trace), the number of
launches the host issued, and the kernels with the most device time.
Needs a CUDA device; builds the kernels on first use.

With ``--baseline DIR`` it traces only the prefill (the v7 169M model, or
with ``--v6`` the v6 1.6B width, w8a8), four times in turns: with the
prefill wkv kernels K2 / K5 built from ``DIR/wkv7.cu`` and ``DIR/wkv6.cu``
(an earlier version: the parent's ``rwkv_tpu_torch/csrc`` from ``git
archive``) in place of the current ones, then the current, the current,
the earlier (``tools/probe_wkv.py::wkv_swapped``).
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def traced(fn, label: str) -> None:
    import torch

    from rwkv_tpu_torch.utils.profiling import trace

    with trace(None) as tr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = tr.profiler.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    launches = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel")))
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.self_device_time_total
        by_name[e.name][1] += 1
    busy = sum(t for t, _ in by_name.values())
    print(f"{label}: wall {wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, "
          f"{launches} launches")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import V4_TP_WIDTH, V7_TP_LORA, V7_TP_WIDTH
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.parallel.sharding import make_mesh
    from rwkv_tpu_torch.tools.card import V5_WIDTH, V6_WIDTH, card_line

    print(card_line())
    tp = [a for a in sys.argv[1:] if a.split("=")[0] == "--tp"]
    if "--baseline" in sys.argv:
        from rwkv_tpu_torch.tools.probe_wkv import baseline_kernels, wkv_swapped

        src = Path(sys.argv[sys.argv.index("--baseline") + 1])
        cfg = synth_config(*(V6_WIDTH if "--v6" in sys.argv else ("7.0", 12, 768, 65536, 64)))
        model = ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8",
                             megakernel=True)
        prompt = torch.randint(0, cfg.n_vocab, (256,),
                               generator=torch.Generator().manual_seed(0)).numpy()
        wkv7, wkv6 = baseline_kernels(src)
        for turn in ("baseline", "current", "current", "baseline"):
            swap = wkv_swapped(wkv7, wkv6) if turn == "baseline" else wkv_swapped()
            with swap:
                model.prefill(prompt)
                traced(lambda: model.prefill(prompt),
                       f"v{cfg.version_major} prefill 256 tokens, {turn} K2 / K5")
        return 0
    if tp:
        widths = {"7.0": V7_TP_WIDTH, "6.0": V6_WIDTH, "5.2": V5_WIDTH, "4.0": V4_TP_WIDTH}
        cfg = synth_config(*widths[tp[0].partition("=")[2] or "7.0"])
        kw = {"lora_dim": V7_TP_LORA} if cfg.version_major == 7 else {}
        model = ServingModel((cfg, synth_params(cfg, seed=0, **kw)),
                             precision="w8a8", megakernel=True,
                             mesh=make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
        print(f"RWKV v{cfg.version_major} C={cfg.n_embed} L={cfg.n_layer}, tp=2 on one card")
    else:
        cfg = synth_config("7.0", 12, 768, 65536, 64)
        model = ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8",
                             megakernel=True)
    prompt = torch.randint(0, cfg.n_vocab, (256,), generator=torch.Generator().manual_seed(0)).numpy()
    logits, state = model.prefill(prompt)
    for _ in range(3):
        lg, state = model.decode(logits.argmax().reshape(1), state)
        logits = lg[0]
    traced(lambda: model.prefill(prompt), "prefill 256 tokens")
    box = {"logits": logits, "state": state}

    def decode8():
        for _ in range(8):
            lg, box["state"] = model.decode(box["logits"].argmax().reshape(1), box["state"])
            box["logits"] = lg[0]

    traced(decode8, "decode 8 tokens at B=1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
