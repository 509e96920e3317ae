#!/usr/bin/env python3
"""Which ``torch.profiler`` sessions of one process record a single K3
decode step (169M w8a8, ``utils.profiling.trace``).

    python3 scripts/probe_torch_trace_sessions.py

Needs a CUDA device. Three sessions back to back (one with 0.2 s of host
sleep on both sides), then, after 60 s, one, one padded by 1 s, one of 50
steps and three more single steps; each line gives the session's CPU and
device event counts.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_trace_sessions: no CUDA device", file=sys.stderr)
        return 1
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.tools.card import card_line
    from rwkv_tpu_torch.utils.profiling import trace

    print(card_line(), torch.__version__)
    _cuda.build_all()
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    model = ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8", megakernel=True)
    prompt = torch.randint(0, cfg.n_vocab, (64,),
                           generator=torch.Generator().manual_seed(0)).numpy()
    logits, state = model.prefill(prompt)
    token = logits.argmax().reshape(1).to(torch.int32)
    model.decode(token, state)
    torch.cuda.synchronize()

    def session(label, pad=0.0, steps=1):
        with trace(None) as tr:
            time.sleep(pad)
            for _ in range(steps):
                model.decode(token, state)
            torch.cuda.synchronize()
            time.sleep(pad)
        ev = tr.profiler.events()
        dev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
        k3 = [e for e in dev if "v7_decode_kernel" in e.name]
        print(f"{label}: pad {pad} s, {steps} step(s): {len(ev) - len(dev)} cpu events, "
              f"{len(dev)} device events, K3 {len(k3)}", flush=True)

    session("s1")
    session("s2")
    session("s3", pad=0.2)
    time.sleep(60)
    session("s4 after 60 s")
    session("s5", pad=1.0)
    session("s6", steps=50)
    for i in range(3):
        session(f"s{7 + i}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
