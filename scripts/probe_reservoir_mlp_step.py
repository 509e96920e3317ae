#!/usr/bin/env python3
"""What ``chip_smoke.py``'s first-step check of the reservoir's MLP readout
(``chip_smoke.mlp_first_step``) reads, and what it would read on a wrong
card path.

    python3 scripts/probe_reservoir_mlp_step.py [SEED ...]   (default 23 24 25 26)

Needs a CUDA device. First, on fake activations of the phase's shapes
(248 rows of 768, one output), a tanh MLP's first gradients and first Adam
step, card against CPU: as shipped, with the card's learning rate 1% off,
with TF32 products on the card, and with bf16 products on the card (the
last two switched on for this process only). Then
``scripts/reservoir_card_readings.py`` over the task seeds, with the check
wrapped so that each seed also prints its relu gate flips (hidden
pre-activations whose sign differs between the card and the CPU in the
first forward) and the first step of the phase's own relu MLP.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_reservoir_mlp_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    import reservoir_card_readings
    from rwkv_tpu_torch.reservoir import MultiLayerReadout

    first_step = CS.mlp_first_step

    def with_gate_flips(start, make, x, y, cpu_dev, card_dev):
        relu = lambda dev: MultiLayerReadout(x.shape[1], device=dev)  # noqa: E731
        zs = {}
        for where, dev in (("cpu", cpu_dev), ("card", card_dev)):
            m = relu(dev)
            m.load_state_dict(start)
            h, out = m._tensor(x), []
            with torch.no_grad():
                for layer in m.layers[:-1]:
                    z = layer(h)
                    out.append(z.cpu().numpy())
                    h = torch.relu(z)
            zs[where] = out
        flips = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(zs["cpu"], zs["card"])]
        near = [float((np.abs(a) / np.abs(a).max()).min()) for a in zs["cpu"]]
        print(f"DIAG relu gate flips per hidden layer {flips}, min |z| / max |z| {near}; "
              f"relu first step {first_step(start, relu, x, y, cpu_dev, card_dev)}")
        out = first_step(start, make, x, y, cpu_dev, card_dev)
        print(f"DIAG tanh first step {out}")
        return out

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((248, 768)) * 0.3).astype(np.float32)
    y = (rng.random((248, 1)) * 0.5).astype(np.float32)
    start = {k: v.clone() for k, v in MultiLayerReadout(768, device="cpu").state_dict().items()}
    linear = torch.nn.functional.linear

    def bf16_linear(a, w, b=None):
        if not a.is_cuda:
            return linear(a, w, b)
        return linear(a.bfloat16(), w.bfloat16(), None if b is None else b.bfloat16()).float()

    for label, lr, tf32, bf16 in (("as shipped", 1.0, False, False),
                                  ("rate x 1.01", 1.01, False, False),
                                  ("TF32", 1.0, True, False), ("bf16", 1.0, False, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.nn.functional.linear = bf16_linear if bf16 else linear

        def make(dev, lr=lr):
            rate = 1e-3 * (lr if torch.device(dev).type == "cuda" else 1.0)
            return MultiLayerReadout(768, activation="tanh", device=dev, learning_rate=rate)

        grad, step = first_step(start, make, x, y, "cpu", "cuda")
        print(f"MUT tanh {label}: first gradients {grad:.3e}, first step {step:.3e}")
    torch.nn.functional.linear = linear
    torch.backends.cuda.matmul.allow_tf32 = False

    CS.mlp_first_step = with_gate_flips
    sys.argv = [sys.argv[0]] + (sys.argv[1:] or ["23", "24", "25", "26"])
    return reservoir_card_readings.main()


if __name__ == "__main__":
    sys.exit(main())
