#!/usr/bin/env python3
"""Where the speculative loops' verification passes part from the decode
chain, on the card.

    python3 scripts/probe_torch_speculative.py [w8a8] [bf16]

For the v7 169M target (``synth_config("7.0", 12, 768, 65536, 64)``, seed
0) after a 16-token prefill, five tokens go through

- the decode chain: five per-op steps at T=1 (what ``generate`` runs);
- ``score``: one pass at T=5 (K2 for the wkv on the card);
- ``score`` with the wkv through the plain token scan instead of K2;
- ``score_trace``: one pass at T=5, the wkv token by token.

For each pass it prints, per position, the largest |difference| of the
logits from the chain's (0 means the same bits) and whether the argmax
agrees; then whether each op of the per-op path (the norms, a projection,
the head, K2's and K5's launches) gives a [5, ...] input's rows the bits it gives
each row alone; then, for the 4-layer C=256 draft (seed 1)
and 128 tokens with k = 4, the first position where each greedy loop's
stream leaves ``generate``'s (None: none). Prints the card (nvidia-smi name
and power limit). Needs a CUDA device.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEQ = [11, 22, 33, 44, 55]


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def report(name: str, logits, chain) -> None:
    diffs = [float((logits[i] - chain[i]).abs().max()) for i in range(len(SEQ))]
    same = [int(logits[i].argmax()) == int(chain[i].argmax()) for i in range(len(SEQ))]
    print(f"  {name}: max |logits - chain| by position {['%.3e' % d for d in diffs]}, "
          f"argmax equal {same}")


def row_invariance(target, cfg) -> None:
    """Whether each op of the per-op path gives the rows of a [5, ...] input
    the bits it gives each row alone (K2: five tokens in one launch against
    five one-token launches)."""
    import torch

    from rwkv_tpu_torch.models.serve import _layer
    from rwkv_tpu_torch.ops import chunked
    from rwkv_tpu_torch.ops.parity import group_norm, l2_normalize, layer_norm, mm

    dev = target.device
    gen = torch.Generator().manual_seed(0)
    c, h, s = cfg.n_embed, cfg.head_count, cfg.head_size
    x = torch.randn(5, c, generator=gen).to(dev)
    layer = _layer(target.params["blocks"], 1)
    ops = {
        "layer_norm": lambda t: layer_norm(t, layer["ln1.weight"], layer["ln1.bias"]),
        "group_norm": lambda t: group_norm(t, layer["att.ln_x.weight"], layer["att.ln_x.bias"],
                                           h, eps=64e-5),
        "l2_normalize": lambda t: l2_normalize(t.reshape(-1, h, s)).reshape(-1, c),
        "output projection": lambda t: mm(t, layer["att.output.weight"]),
        "head": lambda t: mm(t, target.params["head"]),
    }
    if "att.rkv.weight" in layer:
        from rwkv_tpu_torch.ops.parity import bmm

        ops["fused r/k/v"] = lambda t: bmm(torch.stack([t, t, t]), layer["att.rkv.weight"])[1]
    for name, fn in ops.items():
        rows = torch.cat([fn(x[i : i + 1]) for i in range(5)])
        print(f"  {name}: rows alone against [5, ...]: max |difference| "
              f"{float((rows - fn(x)).abs().max()):.3e}")
    if dev.type == "cuda":
        st = torch.randn(h, s, s, generator=gen).to(dev) * 0.1
        r, k, v, b = (torch.randn(5, h, s, generator=gen).to(dev) * 0.1 for _ in range(4))
        w = torch.rand(5, h, s, generator=gen).to(dev) * 0.3 + 0.6
        a = -torch.nn.functional.normalize(torch.randn(5, h, s, generator=gen), dim=-1).to(dev)
        y5, s5 = chunked.wkv7_recurrence(st, r, w, k, v, a, b)
        ys, s1 = [], st
        for t in range(5):
            y, s1 = chunked.wkv7_recurrence(s1, r[t:t + 1], w[t:t + 1], k[t:t + 1], v[t:t + 1],
                                            a[t:t + 1], b[t:t + 1])
            ys.append(y)
        from rwkv_tpu_torch.models.graph import wkv7_scan

        yp, sp = wkv7_scan(st, r, w, k, v, a, b)
        print(f"  K2 T=5 against five T=1 launches: y "
              f"{float((torch.cat(ys) - y5).abs().max()):.3e}, "
              f"state {float((s1 - s5).abs().max()):.3e}; against the torch scan: y "
              f"{float((yp - y5).abs().max()):.3e}, state {float((sp - s5).abs().max()):.3e}")
        tf = torch.randn(h, s, generator=gen).to(dev) * 0.1
        y5, s5 = chunked.wkv6_recurrence(st, r, k, v, w, tf)
        ys, s1 = [], st
        for t in range(5):
            y, s1 = chunked.wkv6_recurrence(s1, r[t:t + 1], k[t:t + 1], v[t:t + 1], w[t:t + 1], tf)
            ys.append(y)
        print(f"  K5 T=5 against five T=1 launches: y "
              f"{float((torch.cat(ys) - y5).abs().max()):.3e}, "
              f"state {float((s1 - s5).abs().max()):.3e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from rwkv_tpu_torch.models import graph as G
    from rwkv_tpu_torch.models import serve as SV
    from rwkv_tpu_torch.models import speculative as S
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import chunked
    from rwkv_tpu_torch.tools.card import card_line

    print(card_line())
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    params = synth_params(cfg, seed=0)
    dcfg = synth_config("7.0", 4, 256, 65536, 64)
    dparams = synth_params(dcfg, seed=1)
    prompt = list(range(16))
    for precision in sys.argv[1:] or ["w8a8", "bf16"]:
        target = SV.ServingModel((cfg, params), precision=precision)
        print(f"{precision}:")
        _, st0 = target.prefill(prompt)
        chain, st = [], st0
        for tok in SEQ:
            lg, st = target.decode([tok], st)
            chain.append(lg[0])
        report("score (K2)", target.score([SEQ], st0)[0][0], chain)
        auto = chunked.wkv7_auto
        chunked.wkv7_auto = G.wkv7_scan  # the T>1 passes' wkv through the token scan
        try:
            report("score (token scan)", target.score([SEQ], st0)[0][0], chain)
        finally:
            chunked.wkv7_auto = auto
        report("score_trace", target.score_trace(SEQ, st0)[0], chain)
        row_invariance(target, cfg)
        draft = SV.ServingModel((dcfg, dparams), precision=precision)
        want = target.generate(prompt, 128, temperature=0.0)[0].tolist()
        for name, fn in (("host", S.speculative_generate),
                         ("device", S.speculative_generate_device)):
            got, stats = fn(target, draft, prompt, 128, k=4)
            print(f"  {name} loop, weak draft: first token apart from generate's "
                  f"{first_difference(got.tolist(), want)} ({stats['rounds']} rounds)")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
