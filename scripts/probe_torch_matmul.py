#!/usr/bin/env python3
"""K1 / K9 launch plans on the card: time ``matmul_plan``'s choice beside
every other plan the kernels take, at the main paths' shapes.

    python3 scripts/probe_torch_matmul.py [--forms w8a8,plain,rowwise]

For each form (``w8a8`` is K1; ``plain``, ``min``, ``pack4``,
``pack4_min``, ``rowwise`` are K9, on q8, Q5_1, Q4_0, Q4_1 and q8r weights)
and each shape of the 169M and 1.5B-width prefills (M = 256) and the M <= 8
routes (the head, 3072 -> 768, 768 -> 768, 768 -> 3072, M = 8), calls the C
entry directly under every tile and K split (GEMM route) or lane count
(GEMV route), checks each result against the plain version (K1 bit for
bit, K9 within 1e-5 of sum |x||W|), and prints the device time of the
plan ``matmul_plan`` picks and of the fastest few. The rules and
constants of ``matmul_plan`` (GEMM_MIN_BLOCKS, GEMM_UNSPLIT_STEPS,
GEMV_CHUNKS, GEMV_MIN_LANES, GEMV_MIN_BLOCKS) were set from its output.
Needs a CUDA device; builds the two kernels on first use.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GEMM_SHAPES = [(256, 768, 768), (256, 768, 64), (256, 64, 768), (256, 768, 3072),
               (256, 3072, 768), (256, 2048, 2048), (256, 2048, 8192), (256, 8192, 2048)]
GEMV_SHAPES = [(1, 768, 65536), (1, 3072, 768), (1, 768, 768), (1, 768, 3072), (8, 768, 768)]
CASES = {"w8a8": None, "plain": "q8", "min": "Q5_1", "pack4": "Q4_0", "pack4_min": "Q4_1",
         "rowwise": "q8r"}


def weight(form: str, n: int, k: int, dev, gen):
    import numpy as np
    import torch

    from rwkv_tpu_torch.io import quant as TQ
    from rwkv_tpu_torch.ops import kernels as TK
    from rwkv_tpu_torch.ops.parity import Weight

    if form == "w8a8":
        return TK.PackedQuantWeight(
            q=torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen),
            d=torch.rand((n,), device=dev, generator=gen) * 1e-2)
    case = CASES[form]
    w = (np.random.default_rng(n + k).standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    if case in ("q8", "q8r"):
        return TK.quantize_q8_serving(w, rowwise=case == "q8r", int8_act=False).to(dev)
    dt = TQ.dtype_from_name(case)
    return TK.PackedQuantWeight.from_weight(
        Weight.from_packed(TQ.quantize_rows(w, dt).tobytes(), dt, (n, k))).to(dev)


def candidates(form: str, m: int, k: int, n: int):
    from rwkv_tpu_torch.ops import kernels as TK

    kind = "w8a8" if form == "w8a8" else "block"
    if m > TK.GEMV_MAX_M:
        steps = -(-k // TK.GEMM_BK[kind])
        return [TK.MatmulPlan("gemm", bm, bn, s, blocks=-(-m // bm) * -(-n // bn) * s)
                for bm, bn in TK.GEMM_TILES for s in range(1, min(TK.MAX_SPLIT, steps) + 1)]
    out = []
    for lanes in (1, 2, 4, 8, 16, 32):
        blocks = -(-n // (TK.GEMV_WARPS[kind] * (32 // lanes)))
        if kind == "w8a8":
            blocks = min(blocks, TK.K1_GEMV_MAX_BLOCKS)
        out.append(TK.MatmulPlan("gemv", lanes=lanes, blocks=blocks))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_torch_matmul: no CUDA device", file=sys.stderr)
        return 1
    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops import kernels as TK
    from rwkv_tpu_torch.tools.card import card_line, device_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--forms", default="w8a8,plain,min,rowwise")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = _cuda.stream_ptr(dev)
    for form in args.forms.split(","):
        for m, k, n in GEMM_SHAPES + GEMV_SHAPES:
            if form != "w8a8" and 64 in (k, n) and CASES[form] not in ("q8", "q8r"):
                continue  # a file quantizes r, k, v, out, fk, fv; q8 / q8r also the LoRAs
            if n == 65536 and CASES[form] not in (None, "q8", "q8r"):
                continue  # the head is w8a8, q8 or q8r
            w = weight(form, n, k, dev, gen)
            x = torch.randn((m, k), device=dev, generator=gen)
            y = torch.empty((m, n), dtype=torch.float32, device=dev)
            if form == "w8a8":
                ref = TK.quant_matmul_plain(x, w)
                x8 = torch.empty((m, k), dtype=torch.int8, device=dev)
                dx = torch.empty((m,), dtype=torch.float32, device=dev)
                fn = _cuda.function("quant_matmul", "rwkv_w8a8_matmul", 6, 8)

                def call(p):
                    return fn(x.data_ptr(), x8.data_ptr(), dx.data_ptr(), w.q.data_ptr(),
                              w.d.data_ptr(), y.data_ptr(), m, k, n, p.bm, p.bn, p.split,
                              p.lanes, p.blocks, stream)

                def ok():
                    return torch.equal(y, ref)
            else:
                ref = TK.block_matmul_plain(x, w)
                band = x.abs() @ TK.dequant_weight(w).abs().T
                fn = _cuda.function("block_matmul", "rwkv_block_matmul", 5, 9)

                def call(p):
                    return fn(x.data_ptr(), w.q.data_ptr(), w.d.data_ptr(),
                              None if w.m is None else w.m.data_ptr(), y.data_ptr(), m, k, n,
                              TK.K9_FORMS.index(form), p.bm, p.bn, p.split, p.lanes, p.blocks,
                              stream)

                def ok():
                    return bool(((y - ref).abs() <= 1e-5 * band + 1e-30).all())
            times = []
            for p in candidates(form, m, k, n):
                _cuda.check("probe", "matmul", call(p))
                torch.cuda.synchronize()
                if not ok():
                    raise AssertionError(f"{form} {m}x{k}x{n} {p}: disagrees with the plain version")
                times.append((device_ms(lambda p=p: call(p)), p))
            times.sort(key=lambda t: t[0])
            pick = TK.matmul_plan(form, m, k, n)
            t_pick = next(t for t, p in times if (p.route, p.bm, p.bn, p.split, p.lanes)
                          == (pick.route, pick.bm, pick.bn, pick.split, pick.lanes))

            def fmt(p):
                return (f"lanes {p.lanes} ({p.blocks} blocks)" if p.route == "gemv" else
                        f"{p.bm}x{p.bn} split {p.split} ({p.blocks} blocks)")

            print(f"{form} M={m} K={k} N={n}: plan {fmt(pick)} {t_pick:.4f} ms | fastest: "
                  + ", ".join(f"{fmt(p)} {t:.4f}" for t, p in times[:3]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
