#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rwkv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), builds the three
   hand-written kernels from ``rwkv_tpu_torch/csrc`` and prints build times.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and times kernel, plain version, the card's bound
   and (K1 only) ``torch._int_mm`` as a yardstick:
   - K1 ``quant_matmul`` (w8a8): M in {1, 256} x the 169M (K, N) set;
     every element equal or at most one float32 ulp apart.
   - K2 ``wkv7_recurrence``: T=256, H=12, S=64; rtol 1e-4 / atol 1e-5
     against the token recurrence, rtol 3e-4 / atol 3e-5 against the
     chunked form.
   - K3 ``v7_decode_step``: the 169M pack after a 256-token prefill;
     logits and state within 2e-2, equal argmax.
3. Drives the main path: RWKV v7 169M (synth, seed 0) under w8a8 with
   ``megakernel=True``: prefill of a 256-token prompt, then 64 greedy
   decode steps at B=1. Launch counters are zeroed just before and read
   just after; every kernel must have launched.
4. Holds the card's serving path against the CPU's plain path on a small
   model (prefill 20 tokens, 4 decode steps): logits within 2e-2, equal
   argmax.
5. Prints the ``{"kernels": [...]}`` JSON line (times per launch, in ms;
   K1's are the mean over the main path's 169 launches per prefill), the
   card line again, and last ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks (dense): HBM bandwidth, int8 tensor-core rate,
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() in ms. The timed calls are queued behind a
    spin kernel that outlasts their enqueue, so the device runs them back
    to back and the CUDA events between them hold no host time. fn must not
    synchronise with the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * host_ms + 2) * _spin_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_SPIN: list = []


def _spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card."""
    import torch

    if not _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN.append(10_000_000 / start.elapsed_time(end))
    return _SPIN[0]


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_diff(a, b) -> int:
    """Largest distance in float32 ulps between equal-shaped tensors."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # map the sign-magnitude float order onto a monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


# 169M main path: (M, K, N, calls per 256-token prefill). Per layer the
# per-op w8a8 path makes 14 projections: r, k, v, out (768 -> 768), the four
# LoRA downs (768 -> 64), the four LoRA ups (64 -> 768), fk (768 -> 3072),
# fv (3072 -> 768); the head (768 -> 65536) runs once, on the last token.
def k1_calls(n_layer: int, c: int, d: int, f: int, v: int, t: int):
    return [
        (t, c, c, 4 * n_layer),
        (t, c, d, 4 * n_layer),
        (t, d, c, 4 * n_layer),
        (t, c, f, n_layer),
        (t, f, c, n_layer),
        (1, c, v, 1),
    ]


def phase_k1(cfg, d_lora: int, f_dim: int, t: int, dev):
    import torch

    from rwkv_tpu_torch.ops.kernels import (
        PackedQuantWeight, quant_matmul, quant_matmul_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(1)
    calls = k1_calls(cfg.n_layer, cfg.n_embed, d_lora, f_dim, cfg.n_vocab, t)
    shapes = sorted({(k, n) for _, k, n, _ in calls})
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0}
    max_err, max_ulp = 0.0, 0
    for k, n in shapes:
        q = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen)
        d = torch.rand((n,), device=dev, generator=gen) * 1e-2
        w = PackedQuantWeight(q=q, d=d)
        for m in (1, 256):
            x = torch.randn((m, k), device=dev, generator=gen)
            y = quant_matmul(x, w)
            y_ref = quant_matmul_plain(x, w)
            torch.cuda.synchronize()
            u = ulp_diff(y, y_ref)
            err = float((y - y_ref).abs().max())
            print(f"K1 M={m} K={k} N={n}: max ulp {u}, max abs err {err:.3e}")
            if u > 1:
                raise AssertionError(f"K1 disagrees with its plain version at M={m} K={k} N={n}: {u} ulp")
            max_err, max_ulp = max(max_err, err), max(max_ulp, u)
    for m, k, n, count in calls:
        q = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen)
        d = torch.rand((n,), device=dev, generator=gen) * 1e-2
        w = PackedQuantWeight(q=q, d=d)
        x = torch.randn((m, k), device=dev, generator=gen)
        kern = device_ms(lambda: quant_matmul(x, w))
        plain = device_ms(lambda: quant_matmul_plain(x, w), reps=5)
        # yardstick: the int8 GEMM alone (cuBLASLt), rows padded to the 17
        # it requires
        mp = max(m, 32)
        x8 = torch.randint(-127, 128, (mp, k), dtype=torch.int8, device=dev, generator=gen)
        qt = q.t()
        lib = device_ms(lambda: torch._int_mm(x8, qt))
        b, kind = bound_ms(m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * k * n, INT8_OPS_PER_S)
        print(f"K1 M={m} K={k} N={n} x{count}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
              f"_int_mm {lib:.4f} ms, bound {b:.5f} ms ({kind})")
        tot["ms"] += count * kern
        tot["plain_ms"] += count * plain
        tot["library_ms"] += count * lib
        tot["bound_ms"] += count * b
        tot["t_bytes" if kind == "bytes" else "t_ops"] += count * b
    n_calls = sum(count for *_, count in calls)
    print(f"K1 per 256-token prefill ({n_calls} calls): kernel {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.4f} ms, _int_mm {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    # the kernels line gives times per launch: the mean over the main path's mix of shapes
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        tot[key] /= n_calls
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    tot["max_abs_err"] = max_err
    tot["max_ulp"] = max_ulp
    return tot


def wkv7_operands(t: int, bh: int, s: int, dev, seed: int = 2):
    """Realistic v7 operands: bounded decay, a = -kk, b = kk * gate."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    r, k, v = rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3), rnd(t, bh, s, scale=0.3)
    w = torch.exp(torch.sigmoid(rnd(t, bh, s)) * -0.606531)
    kk = rnd(t, bh, s)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    gate = torch.sigmoid(rnd(t, bh, s))
    s0 = rnd(bh, s, s, scale=0.3)
    return s0, r, w, k, v, -kk, kk * gate


def phase_k2(t: int, bh: int, s: int, dev):
    import torch

    from rwkv_tpu_torch.ops.chunked import (
        wkv7_chunked, wkv7_recurrence, wkv7_recurrence_plain,
    )

    ops = wkv7_operands(t, bh, s, dev)
    y, s_t = wkv7_recurrence(*ops)
    y_scan, s_scan = wkv7_recurrence_plain(*ops)
    s0, *rest = ops
    y_chk, s_chk = wkv7_chunked(s0[None], *(x[:, None] for x in rest))
    y_chk, s_chk = y_chk[:, 0], s_chk[0]
    torch.cuda.synchronize()
    err = max(float((y - y_scan).abs().max()), float((s_t - s_scan).abs().max()))
    err_chk = max(float((y - y_chk).abs().max()), float((s_t - s_chk).abs().max()))
    print(f"K2 T={t} BH={bh} S={s}: max abs err {err:.3e} vs scan, {err_chk:.3e} vs chunked")
    for a, b, rtol, atol, what in (
        (y, y_scan, 1e-4, 1e-5, "y vs scan"), (s_t, s_scan, 1e-4, 1e-5, "state vs scan"),
        (y, y_chk, 3e-4, 3e-5, "y vs chunked"), (s_t, s_chk, 3e-4, 3e-5, "state vs chunked"),
    ):
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"K2 {what} outside rtol {rtol} / atol {atol}: "
                                 f"max abs err {float((a - b).abs().max()):.3e}")
    kern = device_ms(lambda: wkv7_recurrence(*ops))
    plain = device_ms(lambda: wkv7_chunked(s0[None], *(x[:, None] for x in rest)), reps=5)
    n_bytes = (7 * t * bh * s + 2 * bh * s * s) * 4
    b, kind = bound_ms(n_bytes, 8 * t * bh * s * s, F32_FLOPS_PER_S)
    print(f"K2: kernel {kern:.4f} ms, plain (chunked) {plain:.4f} ms, bound {b:.5f} ms ({kind})")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": kind, "max_abs_err": err}


def pack_bytes(pack: dict, cfg) -> int:
    """Bytes one decode step must move: every weight, scale and vector once,
    the embedding row, the state read and written, the logits written."""
    n = sum(pack[k].numel() * pack[k].element_size()
            for k in ("mats", "scales", "vecs", "head8", "head_d", "ln_out", "ln0"))
    c, l = cfg.n_embed, cfg.n_layer
    state = (2 * l * c + l * cfg.head_count * cfg.head_size ** 2) * 4
    return n + c * 2 + 2 * state + cfg.n_vocab * 4


def phase_k3(model, state, token, cfg):
    import torch

    from rwkv_tpu_torch.ops.megakernel import v7_decode_step, v7_decode_step_ref

    pack = model._mega
    one = {k: v[0] for k, v in state.items()}
    logits, new = v7_decode_step(pack, one, token, cfg)
    logits_ref, new_ref = v7_decode_step_ref(pack, one, token, cfg)
    torch.cuda.synchronize()
    err = float((logits - logits_ref).abs().max())
    for k in new:
        err = max(err, float((new[k] - new_ref[k]).abs().max()))
    print(f"K3: max abs err {err:.3e}, argmax {int(logits.argmax())} vs {int(logits_ref.argmax())}")
    for a, b, what in [(logits, logits_ref, "logits")] + [(new[k], new_ref[k], k) for k in new]:
        if not torch.allclose(a, b, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"K3 {what} outside 2e-2: max abs err {float((a - b).abs().max()):.3e}")
    if int(logits.argmax()) != int(logits_ref.argmax()):
        raise AssertionError("K3 argmax differs from its plain version")
    kern = device_ms(lambda: v7_decode_step(pack, one, token, cfg), reps=50)
    plain = device_ms(lambda: v7_decode_step_ref(pack, one, token, cfg), reps=3, warmup=1)
    nb = pack_bytes(pack, cfg)
    n_weights = pack["mats"].numel() + pack["head8"].numel()
    b, kind = bound_ms(nb, 2 * n_weights, INT8_OPS_PER_S)
    print(f"K3: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound {b:.5f} ms ({kind}, "
          f"{nb / 1e6:.1f} MB), grid {pack['_grid']} blocks")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": kind, "max_abs_err": err}


def small_model_check(dev):
    """The card's serving path against the CPU's plain path on a small v7."""
    import numpy as np
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    cfg = synth_config("7.0", 2, 128, 256, 32)
    params = synth_params(cfg, seed=3, lora_dim=32)
    gpu = ServingModel((cfg, params), precision="w8a8", megakernel=True, device=dev)
    cpu = ServingModel((cfg, params), precision="w8a8", megakernel=True, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.n_vocab, 20)
    lg, sg = gpu.prefill(toks)
    lc, sc = cpu.prefill(toks)
    worst = 0.0
    for step in range(5):
        if step:
            tok = np.array([int(lc.argmax())])
            lg, sg = gpu.decode(tok, sg)
            lc, sc = cpu.decode(tok, sc)
            lg, lc = lg[0], lc[0]
        pairs = [(lg, lc)] + [(sg[k], sc[k]) for k in sc]
        for a, b in pairs:
            a = a.cpu()
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=2e-2, atol=2e-2):
                raise AssertionError(f"small model step {step}: card vs CPU outside 2e-2")
        if int(lg.argmax()) != int(lc.argmax()):
            raise AssertionError(f"small model step {step}: argmax differs between card and CPU")
    print(f"small model (L=2, C=128, V=256): card vs CPU max abs err {worst:.3e}, argmax equal")


def run_main_path(model, prompt, n_decode: int):
    """Prefill `prompt`, then `n_decode` greedy decode steps at B=1.
    Returns (prefill seconds, decode seconds, tokens, last logits, state),
    host clock around work that ends in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = model.prefill(prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks = []
    t0 = time.perf_counter()
    for _ in range(n_decode):
        tok = logits.argmax().reshape(1)
        toks.append(tok)
        lg, state = model.decode(tok, state)
        logits = lg[0]
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return t_prefill, t_decode, toks, logits, state


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "rwkv_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: rwkv_tpu_torch/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.chunked import wkv7_recurrence
    from rwkv_tpu_torch.ops.kernels import quant_matmul
    from rwkv_tpu_torch.ops.megakernel import v7_decode_step
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    t0 = time.perf_counter()
    paths = _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in _cuda.build_seconds.items()))
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- the 169M model: prefill for a real decode state ---------------------
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    t0 = time.perf_counter()
    params = synth_params(cfg, seed=0)
    model = ServingModel((cfg, params), precision="w8a8", megakernel=True)
    d_lora, f_dim = model._mega["d_lora"], model._mega["f_dim"]
    print(f"169M model built in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.n_vocab, (256,),
                           generator=torch.Generator().manual_seed(0)).numpy()
    logits, state = model.prefill(prompt)  # warm-up of every path
    token = logits.argmax().reshape(1).to(torch.int32)

    # -- kernel against plain version ----------------------------------------
    res = {}
    res["K1"] = phase_k1(cfg, d_lora, f_dim, 256, dev)
    res["K2"] = phase_k2(256, cfg.head_count, cfg.head_size, dev)
    res["K3"] = phase_k3(model, state, token, cfg)
    for _ in range(2):
        logits, state = model.decode(logits.argmax().reshape(1), state)
    torch.cuda.synchronize()

    # -- the main path: timing runs, then the counted run ---------------------
    n_decode = 64
    samples = [run_main_path(model, prompt, n_decode)[:2] for _ in range(5)]
    quant_matmul.launches = 0
    wkv7_recurrence.launches = 0
    v7_decode_step.launches = 0
    t_prefill, t_decode, toks, logits, state = run_main_path(model, prompt, n_decode)
    launches = {"K1": quant_matmul.launches, "K2": wkv7_recurrence.launches,
                "K3": v7_decode_step.launches}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    samples.append((t_prefill, t_decode))
    toks = torch.cat(toks).cpu()
    if logits.shape != (cfg.n_vocab,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("main path logits are not finite [V]")
    for k, v in state.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"main path state {k} is not finite")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.n_vocab:
        raise AssertionError("decoded token out of range")
    pre = sorted(t for t, _ in samples)
    dec = sorted(t for _, t in samples)
    print(f"main path on {card}, {len(samples)} runs: prefill 256 tokens median "
          f"{pre[len(pre) // 2] * 1e3:.2f} ms ({256 / pre[len(pre) // 2]:.0f} tok/s; "
          f"all ms {[round(t * 1e3, 2) for t in pre]}), decode {n_decode} tokens at B=1 median "
          f"{dec[len(dec) // 2] * 1e3:.2f} ms ({n_decode / dec[len(dec) // 2]:.0f} tok/s; "
          f"all ms {[round(t * 1e3, 2) for t in dec]}); first tokens {toks[:8].tolist()}")

    small_model_check(dev)

    meta = {
        "K1": ("quant_matmul_w8a8", "rwkv_tpu_torch/csrc/quant_matmul.cu",
               "rwkv_tpu/ops/kernels.py:296"),
        "K2": ("wkv7_recurrence", "rwkv_tpu_torch/csrc/wkv7.cu",
               "rwkv_tpu/ops/chunked.py:388"),
        "K3": ("v7_decode_step_w8a8_head", "rwkv_tpu_torch/csrc/v7_decode.cu",
               "rwkv_tpu/ops/megakernel.py:744"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        r = res[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_counterpart": replaces, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
