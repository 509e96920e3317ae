#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rwkv_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), builds the
   hand-written kernels from ``rwkv_tpu_torch/csrc`` (twelve sources, one
   nvcc each, all at once) and prints build times and ptxas registers.
2. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and times kernel, plain version, the card's bound
   and (K1 only) ``torch._int_mm`` as a yardstick:
   - K1 ``quant_matmul`` (w8a8): M in {1, 256} x the 169M (K, N) set;
     bit-equal to its plain version (0 ulp); each shape's launch plan
     (``matmul_plan``: GEMV or tensor-core GEMM, tile, K split, blocks)
     and, on the GEMM route, the time of its quantization launch alone.
   - K2 ``wkv7_recurrence`` (the chunked two-pass form; the token
     recurrence below its crossover T): T in {3, 4, 16, 64, 256} x BH in
     {12, 96} (the 169M heads; a batched B=8 prefill), S=64, each with its
     launch plan; rtol 1e-4 / atol 1e-5 against the token recurrence, rtol
     3e-4 / atol 3e-5 against the plain two-pass and (T a multiple of 16)
     chunked forms; timed at T=256, BH=12.
   - K3 ``v7_decode_step``: the 169M w8a8 and w4a8 packs after a 256-token
     prefill; logits and state within 2e-2, equal argmax; its stream plan
     (stages, stage bytes, pieces a layer) printed beside its time. K3
     deals each phase's rows over the grid, so both packs (and the bf16
     one) cut to 2 layers must give bit-equal logits, x and state on the
     full grid and on half of it (``grid_invariance``).
   - K4 ``v7_decode_batched``: the 169M w8a8 and w4a8 packs at B = 1, 8,
     17 (a ragged last n-tile) and 64, from states of a seeded batched
     prefill, and
     B=1 at the 1.5B width (C=2048, F=8192; depth cut from 24 to 2);
     x and state within 2e-2 but for a few sequences whose int8 codes
     flipped (``check_k4``), and both packs cut to their first layer at
     B=64 under tighter limits; two launches, a sequence in a batch of 64
     and of 8, and eight lanes fed identical inputs agree bit for bit.
     Also at B = 128 and 256 (both packs), where ``decode`` sends it
     (``MEGA_MAX_BATCH``), from 256 states of a seeded prefill, at the full
     depth's limits.
     Beside it, the w8a8 decode step at B = 8 and 64 through K4 and the
     head, and through the per-op path (the card's crossover).
   - K5 ``wkv6_recurrence``: the same T x BH in {32, 96} (the 1.6B v6 and
     World 1.5B v5.2 width), BH=32 also with extreme decays; the same
     tolerances; timed at T=256, BH=32.
   - K6 ``v6_decode_step``, K7 ``v5_decode_step`` and K8
     ``v4_decode_step`` (``phase_b1``): the w8a8 and w4a8 packs of RWKV-6
     at the 1.6B width (C=2048, F=8192, 24 layers), RWKV-5.2 at the World
     1.5B width (C=2048, F=8192, 24 layers) and RWKV-4 at the World 0.1B
     width (C=768, F=3072, 12 layers), synth seed 0, from 8 states of a
     seeded prefill: cut to their first 1 and 2 layers, x, state and
     logits within 2e-2 of their scale; at full depth two launches agree
     bit for bit, outputs are finite and within B1_FULL_DEPTH_REL of their
     scale (twice the worst reading of ``probe_batched --v6 / --v5 / --v4
     --flips``). K7 also on a v5.1 pair and K8 on a pair at C=2048, both
     of 2 layers at the 1.5B width, within 2e-2 (``phase_cut_width``).
     K6, K7 and K8 deal each phase's rows over the grid, so their w8a8,
     w4a8 and bf16 packs cut to 2 layers must give bit-equal logits, x and
     state on the full grid and on half of it (``grid_invariance``).
   - The bf16 forms of K3, K4, K6, K7 and K8 (``precision="bf16"``, the
     ``quant=False`` packs of the same trees): K3 at the 169M width and
     K6-K8 at theirs through ``phase_b1``, K4 (on the bf16 tensor cores,
     x in three bf16 parts) at B = 1, 8, 64, 128 and 256 on the 169M pack,
     at B=64 cut to one layer and at B = 1 and 3 on the C=2048 v7 width (2
     layers); within 1e-4 of the scale on packs cut to 1 and 2 layers, at
     full depth two launches bit-identical, equal argmax and the drift
     within BF16_FULL_DEPTH_REL / B1_FULL_DEPTH_REL (twice the worst
     reading of ``probe_batched --flips --bf16``); K4's bf16 sums take an
     order fixed by K alone, so each of its checks also holds x and state
     bit-equal on grids of 132, 64, 33 and 7 blocks, a sequence of a batch
     of 64 bit-equal to its run in a batch of 8, and identical lanes
     identical.
   - The tensor-parallel shard kernels (``phase_tp_kernels``): K10 / K11
     (``tp_att_layer`` / ``tp_ffn_layer``, v7), K12 / K13 (``_v6``), K15
     (``tp_att_layer_v5``, v5.2 and v5.1) and K14 (``tp_att_layer_v4``)
     with K13's MIX45 form (``tp_ffn_layer_v45``): the TP step on packs
     cut to the first 2 layers of the v7 World 1.5B width (C=2048, F=8192,
     LoRA 96), the v6 1.6B width, the v5.2 World 1.5B width, a v5.1 tree
     and the v4 World 1.5B width (C=2048, F=8192), at depths 1 and 2, tp =
     2 and 4 on this card, w8a8, w4a8 and bf16, from 4 seeded states (v4:
     and the blank one, pp = -1e30), x and state within TP_SHALLOW_REL of
     the scale of the step on their plain versions; two launches
     bit-identical; every TP kernel (K10-K15, all on the shared stream)
     bit-equal on the full grid and on half of it
     (``tp6_same_on_half_grid``).
   - K9 ``quant_matmul`` on the block formats (``phase_k9``): each form
     (plain Q8_0 and q8, min Q5_1, pack4 Q4_0, pack4_min Q4_1, rowwise
     q8r) at M in {1, 256} x the 169M (K, N) set and the q8 / q8r head
     (768, 65536) at M=1; every output within 1e-5 of sum |x| |W|. Timed
     against its plain version, the bound (the f32 forms' operations over
     the TF32 tensor-core peak, rowwise's over bf16's) and ``torch.matmul``
     on a dequantized f32 copy (rowwise: bf16 x against a bf16 copy of the
     codes), TF32 off; each shape's launch plan.
3. Drives the main paths, each with the launch counters zeroed just before
   and read just after; every kernel of a path must have launched:
   - RWKV v7 169M (synth, seed 0) under w8a8 and under w4a8 with
     ``megakernel=True``: prefill of a 256-token prompt, then 64 greedy
     decode steps at B=1 (K1, K2, K3); the w8a8 and f32 prefills (and v6
     1.6B's f32 one) also against the same prefill with the plain token
     recurrence in K2's / K5's place (``prefill_vs_plain``: f32 within
     2e-4 of the scale, w8a8 1.2e-1 and the same top token);
   - ``ContinuousBatcher(max_batch=8, sync_every=8).run(on_device=True)``
     over the 169M w8a8 model: 16 requests, prompts of 8 to 256 tokens
     (seeded), greedy and sampled (temperature 1, top_p 0.8), two with
     penalties and two with stop tokens (K1, K2, K4); then a shorter one
     over the w4a8 model (8 requests);
   - the 169M model under bf16 (and f32, on the same bf16 pack) with
     ``megakernel=True``: the 256-token prompt per-op (K2), 64 greedy
     decode steps on K3's bf16 form; the batcher over it (8 requests, K4's
     bf16 form);
   - speculative decoding (``phase_speculative``) with the 169M w8a8 and
     bf16 models as targets and a 4-layer C=256 draft (seed 1), prompt
     range(16), 128 tokens, k=4: the target's plain greedy, the host loop
     (K1, K2), the device loop with the weak draft, with force_accept and
     with the target as its own draft (K1, K2), ms a token, acceptance and
     rounds; the greedy streams must equal the target's own, the perfect
     draft accept everything; under w8a8 the sampling loop at temperature
     0.9 too; then a pack-cache round trip (``pack_cache_round_trip``):
     the 169M w8a8 pack written to a temporary directory and read back
     gives K3's logits of the freshly built pack bit for bit;
   - RWKV-6 at the 1.6B width, RWKV-5.2 at the World 1.5B width and
     RWKV-4 at the World 0.1B width (the models above) under w8a8, w4a8
     and bf16 with ``megakernel=True``: prefill of a 256-token prompt (one
     bucket: the projections of every layer and the head on K1, the
     recurrence on K5 for v6 and v5, plain PyTorch's log-depth scan for
     v4), then 64 greedy decode steps at B=1 (K6, K7, K8);
   - the model files (``phase_files``): v7 169M (synth, seed 0) written as
     an FP32 ggmf into a temporary directory, quantized by the port's
     ``quantize_model_file`` to Q5_1, Q4_0 and Q4_1; each served by
     ``ServingModel(path, precision="quant")``: a 256-token prompt, then
     64 greedy decode steps at B=1 on the per-op path (K2, K9 in its form
     of the file); Q5_1 again with ``megakernel=True`` (K9 in prefill, K3
     in decode); ``q8`` and ``q8r`` on the synth tree, prefill and 16
     decode steps (K9 plain, K9 rowwise);
   - the ggml-parity engine and the tools (``phase_parity``) on the same
     169M files, an FP16 one and a Q4_K one: ``RWKVModel`` on the card
     (plain PyTorch: the JAX package computes it in XLA, with no Pallas
     kernel) against ``RWKVModel(path, device="cpu")`` on FP32, FP16,
     Q4_0 (q8_0 activations), Q5_1 (q8_1) and Q4_K (q8_K): a 64-token
     prompt in chunks of 16, then 16 greedy steps fed to both, the
     prompt's and each step's logits and state, FP32 / FP16 within
     PARITY_DENSE_REL of the scale, the quantized files within
     PARITY_QUANT_REL with equal argmax on the prompt's logits, ms a chunk
     and a token; then the tools' loops as functions with the World
     tokenizer and seeded rngs: generation on the parity engine and on
     ``--serve w4a8 --megakernel`` (K1, K2, K3), perplexity over a fixed
     text on Q5_1 through the parity engine and ``--serve quant`` (K2, K9
     min), two turns of ``ChatSession`` and a replay from its snapshot;
     the phase's time;
   - the reservoir layer, ``utils.profiling`` and the native library
     (``phase_reservoir``) on the parity phase's 169M FP32 and Q5_1
     ``RWKVModel``s, card against CPU (no kernel: the JAX package runs the
     reservoir in XLA): ``ReservoirRWKV`` (768 units) fits 8 seeded
     sequences of 64 tokens (warmup 2), predicts and scores, activations
     within PARITY_DENSE_REL / PARITY_QUANT_REL and predictions within
     RES_RIDGE_REL; on FP32 the enhanced reservoir's MLP ([256, 128], the
     CPU's start and activations carried to the card), online SGD / RLS
     and hierarchical readouts within RES_READOUT_REL, and
     ``ESNChatbot.respond`` for 16
     tokens with the card's tokens equal to the CPU's; ms a token of the
     activations in one pass and in a token-by-token ``eval`` loop, the fit
     and MLP seconds; ``profiling.trace`` around a reservoir run and one K3
     decode step (the trace must hold device activity and K3's kernel),
     ``StepTimer`` over 64 K3 steps beside ``device_ms``; the native library
     built with g++, the FP32 file quantized to Q5_1 and Q8_0 byte-equal to
     the Python quantizer, both times;
   - the tensor-parallel B=1 path (``tp_serving_path``, ``tp_paths``):
     ``ServingModel(mesh=make_mesh(1, 2, devices=[cuda:0, cuda:0]),
     megakernel=True)`` on the v7 World 1.5B width, the v6 1.6B width, the
     v5.2 World 1.5B width and the v4 World 1.5B width, w8a8 at 24 layers
     and w4a8 and bf16 on the models cut to TP_CUT_DEPTH layers: the
     256-token prompt per-op, 64 greedy decode steps through K10 / K11,
     K12 / K13, K15 / K13 mix45 or K14 / K13 mix45 (tok/s, launches per
     token, each kernel's time per launch against its plain version and
     bound), then 16 steps held to the same model without a mesh (K4 and
     the head, K6, K7, K8) from the same state and token (x and logits;
     TP_VS_SINGLE_*);
   and checks their outputs: finite logits and state, tokens in range,
   every request finished within its limits.
4. Holds the card against the CPU on small models: v7 (L=2, C=128) and
   v6, v5.2, v5.1 and v4 (L=2, C=256), w8a8 and bf16, the serving path's
   logits and state (prefill 20 tokens, 4 decode steps); the same from
   Q5_1 and Q4_0 files
   of v7, v6, v5.2, v5.1 and v4 (L=2, C=256) under ``precision="quant"``,
   within QUANT_SMALL_REL of the scale (bf16 head and LoRAs); the parity
   engine (``RWKVModel``) on FP16, Q4_1, Q5_0, Q8_0 and Q5_K files of the
   same five versions (``small_parity_check``: 20 tokens in chunks of 8, 4
   greedy steps, the quantized files within PARITY_SMALL_QUANT_REL); and the
   batcher's token streams on the card, its device loop against its host
   loop (greedy with penalties).
5. Prints the total time, the ``{"kernels": [...]}`` JSON line (times per
   launch, in ms; K1's are the mean over the v7 w8a8 path's 169 launches
   per prefill, K4's at B=8, K9's the mean over its file path's mix of
   decode and prefill shapes, K10-K15's one shard's layer at tp=2 in every
   form; their launches those of a 64-token decode on that form's TP
   path, K13 mix45's v5.2's), the card line again, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# H100 SXM data-sheet peaks (dense): HBM bandwidth, int8 tensor-core rate,
# float32 rate outside the tensor cores, bf16 and TF32 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12


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
# Layer 0 skips its value-residual LoRA (selected away), two projections fewer.
def k1_calls(n_layer: int, c: int, d: int, f: int, v: int, t: int):
    return [
        (t, c, c, 4 * n_layer),
        (t, c, d, 4 * n_layer - 1),
        (t, d, c, 4 * n_layer - 1),
        (t, c, f, n_layer),
        (t, f, c, n_layer),
        (1, c, v, 1),
    ]


def plan_str(plan) -> str:
    """A K1 / K9 launch plan (ops/kernels.py::matmul_plan) in one phrase."""
    if plan.route == "gemv":
        return f"gemv, {plan.lanes} lanes a row, {plan.blocks} blocks"
    return f"gemm {plan.bm}x{plan.bn}, split {plan.split}, {plan.blocks} blocks"


def k1_quantize_ms(x) -> float:
    """Device time of K1's first launch alone on the tensor-core route (the
    activation codes, csrc/quant_matmul.cu::rwkv_w8a8_quantize)."""
    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.tools.card import device_ms

    m, k = x.shape
    x8 = torch.empty((m, k), dtype=torch.int8, device=x.device)
    dx = torch.empty((m,), dtype=torch.float32, device=x.device)
    fn = _cuda.function("quant_matmul", "rwkv_w8a8_quantize", 3, 2)

    def launch():
        _cuda.check("quant_matmul", "rwkv_w8a8_quantize",
                    fn(x.data_ptr(), x8.data_ptr(), dx.data_ptr(), m, k, _cuda.stream_ptr(x.device)))

    return device_ms(launch)


def phase_k1(cfg, d_lora: int, f_dim: int, t: int, dev):
    import torch

    from rwkv_tpu_torch.ops.kernels import (
        PackedQuantWeight, matmul_plan, quant_matmul, quant_matmul_plain,
    )
    from rwkv_tpu_torch.tools.card import device_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    calls = k1_calls(cfg.n_layer, cfg.n_embed, d_lora, f_dim, cfg.n_vocab, t)
    shapes = sorted({(k, n) for _, k, n, _ in calls})
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "t_bytes": 0.0, "t_ops": 0.0, "quantize_ms": 0.0}
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
            print(f"K1 M={m} K={k} N={n} ({plan_str(matmul_plan('w8a8', m, k, n))}): "
                  f"max ulp {u}, max abs err {err:.3e}")
            if u > 0:
                raise AssertionError(f"K1 disagrees with its plain version at M={m} K={k} N={n}: {u} ulp")
            max_err, max_ulp = max(max_err, err), max(max_ulp, u)
    for m, k, n, count in calls:
        q = torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen)
        d = torch.rand((n,), device=dev, generator=gen) * 1e-2
        w = PackedQuantWeight(q=q, d=d)
        x = torch.randn((m, k), device=dev, generator=gen)
        kern = device_ms(lambda: quant_matmul(x, w))
        plain = device_ms(lambda: quant_matmul_plain(x, w), reps=5)
        # yardstick: the int8 GEMM alone (cuBLASLt), rows padded to 32 (it
        # refuses M <= 16)
        mp = max(m, 32)
        x8 = torch.randint(-127, 128, (mp, k), dtype=torch.int8, device=dev, generator=gen)
        qt = q.t()
        lib = device_ms(lambda: torch._int_mm(x8, qt))
        b, kind = bound_ms(m * k * 4 + k * n + n * 4 + m * n * 4, 2 * m * k * n, INT8_OPS_PER_S)
        plan = matmul_plan("w8a8", m, k, n)
        quant = k1_quantize_ms(x) if plan.route == "gemm" else 0.0
        print(f"K1 M={m} K={k} N={n} x{count} ({plan_str(plan)}): kernel {kern:.4f} ms "
              f"(its quantization launch {quant:.4f} ms), plain {plain:.4f} ms, "
              f"_int_mm {lib:.4f} ms, bound {b:.5f} ms ({kind})")
        tot["quantize_ms"] += count * quant
        tot["ms"] += count * kern
        tot["plain_ms"] += count * plain
        tot["library_ms"] += count * lib
        tot["bound_ms"] += count * b
        tot["t_bytes" if kind == "bytes" else "t_ops"] += count * b
    n_calls = sum(count for *_, count in calls)
    print(f"K1 per 256-token prefill ({n_calls} calls): kernel {tot['ms']:.4f} ms (quantization "
          f"launches {tot['quantize_ms']:.4f} ms, {100 * tot['quantize_ms'] / tot['ms']:.1f}%), plain "
          f"{tot['plain_ms']:.4f} ms, _int_mm {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
    # the kernels line gives times per launch: the mean over the main path's mix of shapes
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        tot[key] /= n_calls
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    tot["max_abs_err"] = max_err
    tot["max_ulp"] = max_ulp
    return tot


# K9 on the block formats: (case, form) pairs checked and timed. A case is a
# ggmf format (the weight quantized by the port's codecs and loaded as the
# file's blocks) or the serving requantizations q8 / q8r. The plain form is
# timed on q8, the form the main path's q8 run launches.
K9_CASES = (("Q8_0", "plain"), ("q8", "plain"), ("Q5_1", "min"), ("Q4_0", "pack4"),
            ("Q4_1", "pack4_min"), ("q8r", "rowwise"))
K9_TIMED = ("q8", "Q5_1", "Q4_0", "Q4_1", "q8r")
K9_BAND = 1e-5  # of sum_k |x_k| |W_nk|: f32 sums in another order


def k9_weight(case: str, n: int, k: int, dev, seed: int):
    """A seeded [n, k] weight in `case` on `dev` (see K9_CASES)."""
    from rwkv_tpu_torch.io import quant as TQ
    from rwkv_tpu_torch.ops import kernels as TK
    from rwkv_tpu_torch.ops.parity import Weight

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32) / np.float32(np.sqrt(k))
    if case in ("q8", "q8r"):
        pw = TK.quantize_q8_serving(w, rowwise=case == "q8r", int8_act=False)
    else:
        dt = TQ.dtype_from_name(case)
        pw = TK.PackedQuantWeight.from_weight(
            Weight.from_packed(TQ.quantize_rows(w, dt).tobytes(), dt, (n, k)))
    return pw.to(dev)


def k9_shapes(case: str, c: int, d: int, f: int, v: int):
    """(M, K, N) the 169M main path gives K9 in `case`: the six projections
    a layer a file quantizes (r, k, v, out; fk; fv) at M = 1 (decode) and
    256 (a prefill bucket); q8 and q8r also the LoRAs and, at M=1, the head."""
    mats = [(c, c), (c, f), (f, c)]
    if case in ("q8", "q8r"):
        mats += [(c, d), (d, c)]
    shapes = [(m, k, n) for m in (1, 256) for k, n in mats]
    return shapes + ([(1, c, v)] if case in ("q8", "q8r") else [])


def phase_k9(cfg, d_lora: int, f_dim: int, dev):
    """K9 against its plain version in every case at the main path's shapes
    (K9_BAND), then its time per form: kernel, plain version, bound and
    torch.matmul on a dequantized f32 copy (rowwise: bf16 x against a bf16
    copy of the codes), per shape and as the mean per launch over the
    per-op 169M path's mix (64 decode steps at M=1 and one 256-token
    bucket, the six file-quantized projections a layer)."""
    import torch

    from rwkv_tpu_torch.ops import kernels as TK
    from rwkv_tpu_torch.tools.card import device_ms

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("K9's f32 yardstick must be torch.matmul in full f32, not TF32")
    c, v = cfg.n_embed, cfg.n_vocab
    gen = torch.Generator(device=dev).manual_seed(9)
    res = {}
    for case, form in K9_CASES:
        worst, max_err = 0.0, 0.0
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0,
               "t_ops": 0.0, "n": 0}
        for m, k, n in k9_shapes(case, c, d_lora, f_dim, v):
            w = k9_weight(case, n, k, dev, seed=m + k + n)
            if w.form != form:
                raise AssertionError(f"K9 {case}: form {w.form}, expected {form}")
            x = torch.randn((m, k), device=dev, generator=gen)
            y = TK.quant_matmul(x, w)
            y_ref = TK.block_matmul_plain(x, w)
            deq = TK.dequant_weight(w)
            band = x.abs() @ deq.abs().T
            torch.cuda.synchronize()
            rel = float(((y - y_ref).abs() / (band + 1e-30)).max())
            err = float((y - y_ref).abs().max())
            worst, max_err = max(worst, rel), max(max_err, err)
            if rel > K9_BAND or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"K9 {case} M={m} K={k} N={n}: {rel:.3e} of sum |x||W|, "
                                     f"limit {K9_BAND}")
            if case not in K9_TIMED:
                continue
            kern = device_ms(lambda: TK.quant_matmul(x, w))
            plain = device_ms(lambda: TK.block_matmul_plain(x, w), reps=5)
            if form == "rowwise":
                xb, qb = x.to(torch.bfloat16), w.q.to(torch.bfloat16)
                lib = device_ms(lambda: torch.matmul(xb, qb.T))
                rate = BF16_FLOPS_PER_S
            else:
                lib = device_ms(lambda: torch.matmul(x, deq.T))
                # no f32-accurate product on this card beats the TF32 tensor cores
                rate = TF32_FLOPS_PER_S
            n_bytes = m * k * 4 + sum(t.numel() * t.element_size()
                                      for t in (w.q, w.d, w.m) if t is not None) + m * n * 4
            b, kind = bound_ms(n_bytes, 2 * m * k * n, rate)
            print(f"K9 {case} ({form}) M={m} K={k} N={n} ({plan_str(TK.matmul_plan(form, m, k, n))}): "
                  f"kernel {kern:.4f} ms, plain "
                  f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {b:.5f} ms ({kind}), "
                  f"{rel:.2e} of the band")
            if (k, n) in ((c, c), (c, f_dim), (f_dim, c)):
                count = (64 if m == 1 else 1) * (4 if (k, n) == (c, c) else 1)
                for key, t in (("ms", kern), ("plain_ms", plain), ("library_ms", lib),
                               ("bound_ms", b), ("t_bytes" if kind == "bytes" else "t_ops", b)):
                    tot[key] += count * t
                tot["n"] += count
        print(f"K9 {case} ({form}): every output within {worst:.2e} of sum |x||W| "
              f"(limit {K9_BAND}), max abs err {max_err:.3e}")
        if case in K9_TIMED:
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[key] /= tot["n"]
            print(f"K9 {form}: mean per launch over the per-op path's mix: kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, torch.matmul "
                  f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms")
            res[form] = {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                         "library_ms": tot["library_ms"], "bound_ms": tot["bound_ms"],
                         "bound_by": "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
                         "max_abs_err": max_err}
    return res


# K2 / K5 at the prefill buckets (T = 3: the card tests' ragged T, below
# the crossover; 256: the main path's) and the heads of the main paths (v7
# 169M 12, v6 1.6B / v5.2 World 1.5B 32) and of a batched B=8 prefill at
# 169M (96): within rtol 1e-4 / atol 1e-5 of the token recurrence and rtol
# 3e-4 / atol 3e-5 of the plain two-pass form and (T a multiple of 16) of the
# plain chunked form
WKV_TS = (3, 4, 16, 64, 256)


def wkv_check(kind: int, t: int, bh: int, s: int, dev, extreme: bool = False) -> float:
    """One launch of K2 (kind 7) / K5 (kind 6) against the token recurrence,
    the kernel's plain two-pass form and the plain chunked form; prints its
    plan (``wkv_chunk_plan``); returns the largest error against the
    recurrence."""
    import torch

    from rwkv_tpu_torch.ops import chunked as TC
    from rwkv_tpu_torch.tools.card import wkv6_operands, wkv7_operands

    name = "K2" if kind == 7 else "K5"
    if kind == 7:
        ops = wkv7_operands(t, bh, s, dev)
        y, s_t = TC.wkv7_recurrence(*ops)
        refs = {"scan": TC.wkv7_recurrence_plain(*ops), "two-pass": TC.wkv7_twopass(*ops)}
        if t % 16 == 0:
            s0, *rest = ops
            y_c, s_c = TC.wkv7_chunked(s0[None], *(x[:, None] for x in rest))
            refs["chunked"] = (y_c[:, 0], s_c[0])
    else:
        ops = wkv6_operands(t, bh, s, dev, extreme=extreme)
        y, s_t = TC.wkv6_recurrence(*ops)
        refs = {"scan": TC.wkv6_recurrence_plain(*ops), "two-pass": TC.wkv6_twopass(*ops)}
        if t % 16 == 0 and not extreme:
            s0, r, k, v, w, tf = ops
            y_c, s_c = TC.wkv6_chunked(s0[None], r[:, None], k[:, None], v[:, None],
                                       w[:, None], tf)
            refs["chunked"] = (y_c[:, 0], s_c[0])
    torch.cuda.synchronize()
    plan = TC.wkv_chunk_plan(kind, t, bh, s, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    err = max(float((y - refs["scan"][0]).abs().max()), float((s_t - refs["scan"][1]).abs().max()))
    print(f"{name} T={t} BH={bh} S={s}{' extreme decays' if extreme else ''}: max abs err "
          f"{err:.3e} vs scan; plan {'recurrence' if plan.recurrent else 'two-pass'}, "
          f"{plan.n_chunks} chunks, {plan.rows} rows a block, grid {plan.grid}, "
          f"{plan.stages} stages, {plan.smem_bytes} B shared")
    for what, (y_r, s_r) in refs.items():
        rtol, atol = (1e-4, 1e-5) if what == "scan" else (3e-4, 3e-5)
        for a, b, part in ((y, y_r, "y"), (s_t, s_r, "state")):
            if not torch.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(f"{name} T={t} BH={bh} {part} vs {what} outside rtol "
                                     f"{rtol} / atol {atol}: max abs err "
                                     f"{float((a - b).abs().max()):.3e}")
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_t).all())):
        raise AssertionError(f"{name} T={t} BH={bh}: outputs not finite")
    return err


def phase_k2(t: int, bh: int, s: int, dev):
    from rwkv_tpu_torch.ops.chunked import wkv7_chunked, wkv7_recurrence
    from rwkv_tpu_torch.tools.card import device_ms, wkv7_operands

    for b in (bh, 96):
        for tt in WKV_TS:
            e = wkv_check(7, tt, b, s, dev)
            if (tt, b) == (t, bh):
                err = e
    ops = wkv7_operands(t, bh, s, dev)
    s0, *rest = ops
    kern = device_ms(lambda: wkv7_recurrence(*ops))
    plain = device_ms(lambda: wkv7_chunked(s0[None], *(x[:, None] for x in rest)), reps=5)
    n_bytes = (7 * t * bh * s + 2 * bh * s * s) * 4
    b, kind = bound_ms(n_bytes, 8 * t * bh * s * s, F32_FLOPS_PER_S)
    print(f"K2: kernel {kern:.4f} ms, plain (chunked) {plain:.4f} ms, bound {b:.5f} ms ({kind})")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": kind, "max_abs_err": err}


def phase_k5(t: int, bh: int, s: int, dev):
    from rwkv_tpu_torch.ops.chunked import wkv6_chunked, wkv6_recurrence
    from rwkv_tpu_torch.tools.card import device_ms, wkv6_operands

    def chunked(s0, r, k, v, w, tf):
        y, s_new = wkv6_chunked(s0[None], r[:, None], k[:, None], v[:, None], w[:, None], tf)
        return y[:, 0], s_new[0]

    for b in (bh, 96):
        for tt in WKV_TS:
            e = wkv_check(6, tt, b, s, dev)
            if (tt, b) == (t, bh):
                err = e
            if b == bh:
                wkv_check(6, tt, b, s, dev, extreme=True)
    ops = wkv6_operands(t, bh, s, dev)
    kern = device_ms(lambda: wkv6_recurrence(*ops))
    plain = device_ms(lambda: chunked(*ops), reps=5)
    n_bytes = (5 * t * bh * s + bh * s + 2 * bh * s * s) * 4
    b, kind = bound_ms(n_bytes, 5 * t * bh * s * s, F32_FLOPS_PER_S)
    print(f"K5: kernel {kern:.4f} ms, plain (chunked) {plain:.4f} ms, bound {b:.5f} ms ({kind})")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": kind, "max_abs_err": err}


# The 256-token prefill at full depth with K2 / K5 against the same prefill
# with the plain token recurrence in their place, on the card: f32 within
# PREFILL_F32_REL of the scale (the two forms' f32 sums in another order,
# ~1e-6 a launch, grown through the layers: v7 169M 1.6-2.0e-6, v6 1.6B
# 7.8-9.5e-5, the parent's kernels 1.4-2.2e-6 / 7.9e-5-1.01e-4; twice the
# worst), w8a8 within PREFILL_INT_REL (int8 codes flip at .5 boundaries and
# the flips compound: v7 169M 4.3-4.9e-2, the parent's 3.5-5.6e-2; twice
# the worst) with the same top token; readings of `probe_wkv --drift`, 6
# prompts, PERF.md. v6's w8a8 prefill at the 1.6B width drifts 0.52-0.71 of
# the scale from the plain recurrence with either kernel, so v6 is held at
# f32.
PREFILL_F32_REL = 2e-4
PREFILL_INT_REL = 1.2e-1


def prefill_vs_plain(name: str, model, prompt) -> float:
    """Logits and every state tensor of `model`'s prefill against the same
    prefill on the plain recurrence; returns the worst distance over its
    scale."""
    import torch

    from rwkv_tpu_torch.ops import chunked as TC
    from rwkv_tpu_torch.tools.probe_wkv import prefill_distance, wkv_swapped

    out = model.prefill(prompt)
    with wkv_swapped(TC.wkv7_recurrence_plain, TC.wkv6_recurrence_plain):
        ref = model.prefill(prompt)
    torch.cuda.synchronize()
    rel = PREFILL_F32_REL if model.precision == "f32" else PREFILL_INT_REL
    worst = prefill_distance(out, ref)
    same_top = int(out[0].argmax()) == int(ref[0].argmax())
    print(f"{name} prefill of {len(prompt)} tokens, K2 / K5 against the plain recurrence: "
          f"{worst:.3e} of the scale (limit {rel:g}), same top token {same_top}")
    if worst > rel or not same_top:
        raise AssertionError(f"{name} prefill with K2 / K5 leaves the plain recurrence's band")
    return worst


def pack_bytes(pack: dict, cfg) -> int:
    """Bytes one decode step must move: every weight, scale and vector once
    (v6's f32 maa2 too; the bf16 form's matrices and head at two bytes a
    value, no scales), the embedding row, the state read and written, the
    logits written."""
    n = sum(pack[k].numel() * pack[k].element_size()
            for k in ("mats", "scales", "vecs", "head8", "head_d", "headbf16", "ln_out", "ln0",
                      "maa2")
            if k in pack)
    return (n + cfg.n_embed * pack["emb"].element_size() + 2 * cfg.state_len * 4
            + cfg.n_vocab * 4)


def head_weights(pack: dict) -> int:
    """Values of the pack's LM head (int8 or bf16)."""
    return pack["headbf16" if pack["form"] == "bf16" else "head8"].numel()


def op_rate(pack: dict) -> float:
    """Peak rate of a B=1 decode kernel's multiply-adds: int8 dp4a for the
    int forms, float32 FMAs (bf16 values widened) for the bf16 form."""
    return F32_FLOPS_PER_S if pack["form"] == "bf16" else INT8_OPS_PER_S


def k4_rate(pack: dict) -> float:
    """Peak rate of K4's products: int8 tensor cores for the int forms; for
    the bf16 form, which runs f32 products as three bf16 passes, TF32's
    tensor-core rate (as K9's f32 forms are reckoned)."""
    return TF32_FLOPS_PER_S if pack["form"] == "bf16" else INT8_OPS_PER_S


def layer_codes(pack: dict) -> int:
    """Weight codes of the layers (int4 codes count one each)."""
    from rwkv_tpu_torch.ops.megakernel import _layout

    mat_keys, w4_mats = _layout(pack)[:2]
    return sum(pack[k].numel() * (2 if pack["w4"] and k in w4_mats else 1) for k in mat_keys)


def batched_bytes(pack: dict, cfg, b: int) -> int:
    """Bytes one K4 step for b sequences must move: every layer weight,
    scale and vector once, b embedding rows and tokens, b states read and
    written, x [b, C] written."""
    n = sum(pack[k].numel() * pack[k].element_size()
            for k in ("mats", "scales", "vecs", "ln0") if k in pack)
    c, l = cfg.n_embed, cfg.n_layer
    state = (2 * l * c + l * cfg.head_count * cfg.head_size ** 2) * 4
    return n + b * (c * pack["emb"].element_size() + 4 + 2 * state + c * 4)


def phase_k3(model, state, token, cfg, name="K3"):
    import torch

    from rwkv_tpu_torch.ops.megakernel import v7_decode_step, v7_decode_step_ref
    from rwkv_tpu_torch.tools.card import device_ms

    pack = model._mega
    one = {k: v[0] for k, v in state.items()}
    logits, new = v7_decode_step(pack, one, token, cfg)
    logits_ref, new_ref = v7_decode_step_ref(pack, one, token, cfg)
    torch.cuda.synchronize()
    err = float((logits - logits_ref).abs().max())
    for k in new:
        err = max(err, float((new[k] - new_ref[k]).abs().max()))
    print(f"{name}: max abs err {err:.3e}, argmax {int(logits.argmax())} vs "
          f"{int(logits_ref.argmax())}")
    for a, b, what in [(logits, logits_ref, "logits")] + [(new[k], new_ref[k], k) for k in new]:
        if not torch.allclose(a, b, rtol=2e-2, atol=2e-2):
            raise AssertionError(f"{name} {what} outside 2e-2: max abs err "
                                 f"{float((a - b).abs().max()):.3e}")
    if int(logits.argmax()) != int(logits_ref.argmax()):
        raise AssertionError(f"{name} argmax differs from its plain version")
    kern = device_ms(lambda: v7_decode_step(pack, one, token, cfg), reps=50)
    plain = device_ms(lambda: v7_decode_step_ref(pack, one, token, cfg), reps=3, warmup=1)
    nb = pack_bytes(pack, cfg)
    n_weights = layer_codes(pack) + head_weights(pack)
    b, kind = bound_ms(nb, 2 * n_weights, op_rate(pack))
    print(f"{name}: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound {b:.5f} ms ({kind}, "
          f"{nb / 1e6:.1f} MB), grid {pack['_grid']} blocks; {k3_plan_str(pack, cfg)}")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
            "bound_by": kind, "max_abs_err": err}


def k3_plan_str(pack: dict, cfg) -> str:
    """K3's stream plan on the pack's grid: stages, stage bytes and a
    block's pieces a layer (fewest and most over the grid)."""
    from rwkv_tpu_torch.ops.megakernel import v7_stream_plan

    plan = v7_stream_plan(pack["form"], cfg.n_embed, pack["f_dim"], pack["d_lora"],
                          cfg.head_count, cfg.head_size, cfg.n_vocab, pack["_grid"])
    pieces = [plan.layer_pieces(b) for b in range(plan.blocks)]
    return (f"stream plan: {plan.n_stages} stages of {plan.stage_bytes} bytes, "
            f"{min(pieces)}-{max(pieces)} pieces a layer, {plan.head_pieces(0)} of the head")


def small_model_check(dev, version: str = "7.0", precision: str = "w8a8"):
    """The card's serving path (megakernel=True, `precision`) against the
    CPU's plain path on a small v7 (L=2, C=128) or v4-v6 (L=2, C=256)
    model: a 20-token prefill and 4 decode steps within 2e-2 (int8 codes
    and, under bf16, the per-op prefill's bf16 roundings flip under
    last-bit differences), equal argmax."""
    import numpy as np
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    if version == "7.0":
        cfg = synth_config("7.0", 2, 128, 256, 32)
        params = synth_params(cfg, seed=3, lora_dim=32)
    else:
        cfg = synth_config(version, 2, 256, 256, 64)
        params = synth_params(cfg, seed=3)
    gpu = ServingModel((cfg, params), precision=precision, megakernel=True, device=dev)
    cpu = ServingModel((cfg, params), precision=precision, megakernel=True, device="cpu")
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
    print(f"small model (v{version} {precision}, L=2, C={cfg.n_embed}, V=256): card vs CPU max "
          f"abs err {worst:.3e}, argmax equal")


# K4 against its plain version. An int8 activation code at a .5 boundary
# flips when the kernel's sums and the plain version's round differently in
# the last bit, and the flip moves the rest of the step: at the 169M width
# by up to 1.5% of the sequence's largest value within one layer and 3.9%
# over twelve (readings over 12 seeds in PERF.md: at most 1 of 64
# sequences flipped at one layer, 16 of 64 and 4 of 8 at twelve). So every
# sequence must lie within rtol = atol = 2e-2 element-wise except at most
# `max_out` flipped ones, each within `max_rel` of its scale (twice the
# worst reading), and at least half the batch must agree within EXACT_ABS:
# flips never reach most sequences, a wrong kernel moves them all. The bf16
# form has no codes: every sequence must lie within BF16_SHALLOW_REL of its
# scale on a pack cut to one or two layers, and within BF16_FULL_DEPTH_REL
# at the 169M width's full depth: about twice the worst reading over 12
# seeded batches of 64 of probe_batched --flips --bf16 (1.09e-6, PERF.md).
EXACT_ABS = 1e-4
FULL_DEPTH_REL = 0.075
SHALLOW_REL, SHALLOW_OUT = 0.03, 2
BF16_SHALLOW_REL = 1e-4
BF16_FULL_DEPTH_REL = 2.2e-6


# grids K4's bf16 form must give equal bits on (its sums' order is K's alone)
K4_GRIDS = (132, 64, 33, 7)


def check_k4(pack, cfg, st, tok, name: str, max_out: int, max_rel: float) -> float:
    """K4 on (st, tok) against its plain version (see EXACT_ABS); two
    launches on the same inputs agree bit for bit, and so does a sequence
    run in this batch and in a batch of 8; the bf16 form also on grids of
    K4_GRIDS blocks (through the C entry: the launch counters do not move).
    Returns the max abs error."""
    import torch

    from rwkv_tpu_torch.ops.megakernel import (
        batched_launch, k4_function, v7_decode_batched, v7_decode_batched_ref,
    )
    from rwkv_tpu_torch.tools.card import seq_errors

    b = tok.shape[0]
    x, new = v7_decode_batched(pack, st, tok, cfg)
    x2, new2 = v7_decode_batched(pack, st, tok, cfg)
    torch.cuda.synchronize()
    if not torch.equal(x, x2) or any(not torch.equal(new[k], new2[k]) for k in new):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    if pack["form"] == "bf16":
        for grid in K4_GRIDS:
            xg, newg, _ = batched_launch(k4_function(pack), pack, st, tok, cfg, grid)
            if not torch.equal(xg, x) or any(not torch.equal(newg[k], new[k]) for k in new):
                raise AssertionError(f"{name}: a grid of {grid} blocks gives other bits")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: x is not finite")
    for lo in range(0, b, 8) if b > 8 else ():
        part = {k: v[lo : lo + 8] for k, v in st.items()}
        xp, newp = v7_decode_batched(pack, part, tok[lo : lo + 8], cfg)
        if not torch.equal(xp, x[lo : lo + 8]) or any(
                not torch.equal(newp[k], new[k][lo : lo + 8]) for k in new):
            raise AssertionError(f"{name}: sequences {lo}-{lo + 7} differ from the same "
                                 f"sequences in a batch of 8")
    keys = sorted(new)
    x_ref, new_ref = v7_decode_batched_ref(pack, st, tok, cfg)
    err, rel, ok = seq_errors([x] + [new[k] for k in keys], [x_ref] + [new_ref[k] for k in keys])
    if pack["form"] == "bf16":
        worst = float(rel.max())
        msg = (f"{name}: max abs err {float(err.max()):.3e}, every sequence within "
               f"{worst:.3e} of its scale; grids of {K4_GRIDS} blocks bit-equal")
        if worst > max_rel:
            raise AssertionError(f"{msg} (limit {max_rel:g})")
        print(msg)
        return float(err.max())
    n_out, n_exact = int((~ok).sum()), int((err <= EXACT_ABS).sum())
    msg = (f"{name}: max abs err {float(err.max()):.3e}, {n_exact} of {b} sequences within "
           f"{EXACT_ABS:g}")
    worst = float(rel[~ok].max()) if n_out else 0.0
    if n_out:
        msg += (f"; sequences {(~ok).nonzero().flatten().tolist()} outside 2e-2 after a code "
                f"flip, worst {worst:.3e} of its scale")
    if n_out > max_out or worst > max_rel or 2 * n_exact < b:
        raise AssertionError(f"{msg} (limits: {max_out} flipped, {max_rel:g} of the scale, "
                             f"half within {EXACT_ABS:g})")
    print(msg)
    return float(err.max())


def phase_k4(pack, cfg, states, tokens, b: int, name: str, max_rel=None,
             show_f32_bound: bool = False):
    """K4 at batch b (check_k4 at the full depth's limits, or `max_rel` of
    the scale for the bf16 form), its time, the plain version's, the bound
    (bytes, or the products at k4_rate) and the plan; `show_f32_bound`
    also prints the bound the products would set as f32 FMAs (the earlier
    CUDA-core bf16 form's)."""
    from rwkv_tpu_torch.ops.megakernel import k4_plan, v7_decode_batched, v7_decode_batched_ref
    from rwkv_tpu_torch.tools.card import device_ms

    st = {k: v[:b].contiguous() for k, v in states.items()}
    tok = tokens[:b].contiguous()
    if max_rel is None:
        max_rel = BF16_FULL_DEPTH_REL if pack["form"] == "bf16" else FULL_DEPTH_REL
    err = check_k4(pack, cfg, st, tok, name, b // 4 + 2, max_rel)
    kern = device_ms(lambda: v7_decode_batched(pack, st, tok, cfg), reps=20)
    plain = device_ms(lambda: v7_decode_batched_ref(pack, st, tok, cfg), reps=2, warmup=1)
    nb = batched_bytes(pack, cfg, b)
    bd, kind = bound_ms(nb, 2 * b * layer_codes(pack), k4_rate(pack))
    plan = k4_plan(pack, b, cfg, pack["_grid_batched"])
    print(f"{name}: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound {bd:.5f} ms ({kind}, "
          f"{nb / 1e6:.1f} MB), grid {pack['_grid_batched']} blocks, placement ({plan.place}), "
          f"K slices {plan.k_slice}")
    if show_f32_bound:
        old, old_kind = bound_ms(nb, 2 * b * layer_codes(pack), F32_FLOPS_PER_S)
        print(f"{name}: reckoned as f32 FMAs at {F32_FLOPS_PER_S / 1e12:g} TFLOP/s (the "
              f"earlier CUDA-core form's bound) {old:.5f} ms ({old_kind})")
    return {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": bd,
            "bound_by": kind, "max_abs_err": err}


def phase_k4_shallow(packs, states, tokens) -> None:
    """K4 on the 169M packs cut to their first layer (a one-layer config
    over the same buffers, the state's first layer), w8a8, w4a8 and bf16 at
    B=64: check_k4 at one layer's limits (SHALLOW_OUT, SHALLOW_REL; bf16
    BF16_SHALLOW_REL)."""
    from rwkv_tpu_torch.models.synth import synth_config

    cfg1 = synth_config("7.0", 1, 768, 65536, 64)
    st = {k: v[:, :1].contiguous() for k, v in states.items()}
    for prec, pack in packs.items():
        rel = BF16_SHALLOW_REL if pack["form"] == "bf16" else SHALLOW_REL
        check_k4(pack, cfg1, st, tokens, f"K4 {prec} first layer B=64", SHALLOW_OUT, rel)


def k4_identical_lanes(pack, cfg, states, tokens, b: int = 8) -> None:
    """b copies of one sequence through K4 come out bit-identical."""
    import torch

    from rwkv_tpu_torch.ops.megakernel import v7_decode_batched

    st = {k: v[:1].repeat(b, *([1] * (v.ndim - 1))) for k, v in states.items()}
    x, new = v7_decode_batched(pack, st, tokens[:1].repeat(b), cfg)
    for name, t in [("x", x)] + list(new.items()):
        if not torch.equal(t, t[:1].expand_as(t)):
            raise AssertionError(f"K4: lanes fed identical inputs differ in {name}")
    print(f"K4: {b} lanes fed identical inputs give identical x and state")


def crossover(model, states, tokens) -> dict:
    """The w8a8 decode step (logits included) at B = 8 and 64 through K4
    and the head, and through the per-op path: wall and device time."""
    from rwkv_tpu_torch.tools.card import device_ms, wall_ms

    out = {}
    for b in (8, 64):
        st = {k: v[:b].contiguous() for k, v in states.items()}
        tok = tokens[:b].contiguous()
        row = {}
        for route, fn in (("K4+head", lambda: model.decode(tok, st)),
                          ("per-op", lambda: model._batched(st, tok[:, None]))):
            row[route] = (wall_ms(fn), device_ms(fn, reps=10))
        out[b] = row
        print(f"decode step B={b} (w8a8, logits included): " + ", ".join(
            f"{r} {w:.3f} ms wall ({b / w * 1e3:.0f} tok/s), {d:.3f} ms device"
            for r, (w, d) in row.items()))
    return out


# The B=1 decode kernels K6 (v6), K7 (v5) and K8 (v4) against their plain
# versions. A random-weight model at these widths amplifies last-bit
# differences through int8 code flips (and, in v6, exp(-exp(.))), so each is
# held element-wise (2e-2 of each tensor's scale) on packs cut to their
# first 1 and 2 layers; at full depth two launches must agree bit for bit
# and the drift from the plain version must stay within the full-depth
# limit: about twice the worst reading over 12 seeds of probe_batched
# --v6 / --v5 / --v4 --flips (PERF.md). K6 read 8.61% (w8a8) and 7.03%
# (w4a8) at 24 layers, at most 0.91% at one and two. K7 read 3.10%
# (w8a8) and 3.98% (w4a8) at 24 layers, K8 1.87% and 0.98% at 12, and both
# at most 1.74% at one and two layers (v5.1 included); a flip moves
# either format alike, so K7's and K8's limits are twice the worse of
# their two formats. The bf16 forms (K3 here too) have no codes: within
# 1e-4 of the scale on the cut packs, and at full depth within about twice
# the worst reading over 12 seeds of the same probes with --bf16 and this
# script's own 8 states (PERF.md): K3 7.33e-7 at 12 layers, K6 2.21e-6 at
# 24, K7 1.02e-6 at 24, K8 5.78e-7 at 12.
B1_SHALLOW_REL = {"w8a8": 2e-2, "w4a8": 2e-2, "bf16": BF16_SHALLOW_REL}
B1_FULL_DEPTH_REL = {
    "K3": {"bf16": 1.5e-6},
    "K6": {"w8a8": 0.17, "w4a8": 0.14, "bf16": 4.4e-6},
    "K7": {"w8a8": 0.08, "w4a8": 0.08, "bf16": 2.1e-6},
    "K8": {"w8a8": 0.037, "w4a8": 0.037, "bf16": 1.2e-6},
}


def b1_step(version: int):
    """(kernel wrapper, plain version) of the B=1 decode step of `version`."""
    from rwkv_tpu_torch.ops import megakernel as M

    return {7: (M.v7_decode_step, M.v7_decode_step_ref),
            6: (M.v6_decode_step, M.v6_decode_step_ref),
            5: (M.v5_decode_step, M.v5_decode_step_ref),
            4: (M.v4_decode_step, M.v4_decode_step_ref)}[version]


def check_shallow(name, models, cfg, n_states: int, seed: int, depths=(1, 2)) -> dict:
    """The decode kernel of `models` on their packs cut to `depths` layers,
    from n_states seeded states (a prefill on the first model), within
    B1_SHALLOW_REL of the scale; returns the worst reading per (format,
    depth)."""
    from rwkv_tpu_torch.tools.card import decode_vs_plain, seeded_states

    states, tokens = seeded_states(next(iter(models.values())), cfg, n_states, 16, seed=seed)
    worst = {}
    for i in range(n_states):
        st = {k: v[i] for k, v in states.items()}
        for prec, model in models.items():
            for depth in depths:
                e = max(decode_vs_plain(model._mega, cfg, st, tokens[i : i + 1], depth).values())
                worst[(prec, depth)] = max(worst.get((prec, depth), 0.0), e)
                if e > B1_SHALLOW_REL[prec]:
                    raise AssertionError(f"{name} {prec} depth {depth}: {e:.3e} of the scale, "
                                         f"limit {B1_SHALLOW_REL[prec]}")
    print(f"{name}: {n_states} seeded states at depths {depths}, worst distance from the plain "
          f"version over the scale {worst} (limits {B1_SHALLOW_REL})")
    return worst


def phase_b1(name: str, models, cfg, n_states: int = 8, seed: int = 7):
    """K3 (bf16), K6, K7 or K8 (w8a8, w4a8 and bf16) at a published width
    from n_states seeded states: the shallow and full-depth checks above,
    argmax equal to the plain version's, its time, the plain version's and
    the bound. Returns {precision: result}."""
    import torch

    from rwkv_tpu_torch.tools.card import decode_vs_plain, device_ms, seeded_states

    step, step_ref = b1_step(cfg.version_major)
    check_shallow(name, models, cfg, n_states, seed)
    states, tokens = seeded_states(next(iter(models.values())), cfg, n_states, 16, seed=seed)
    out = {}
    for prec, model in models.items():
        pack = model._mega
        limit = B1_FULL_DEPTH_REL[name][prec]
        worst = 0.0
        for i in range(n_states):
            st = {k: v[i] for k, v in states.items()}
            e = decode_vs_plain(pack, cfg, st, tokens[i : i + 1], cfg.n_layer)
            worst = max(worst, *e.values())
            if max(e.values()) > limit:
                raise AssertionError(f"{name} {prec} full depth: {e} of the scale, limit {limit}")
        one, tok = {k: v[0] for k, v in states.items()}, tokens[:1]
        logits, new = step(pack, one, tok, cfg)
        logits2, new2 = step(pack, one, tok, cfg)
        logits_ref, new_ref = step_ref(pack, one, tok, cfg)
        torch.cuda.synchronize()
        if not torch.equal(logits, logits2) or any(not torch.equal(new[k], new2[k]) for k in new):
            raise AssertionError(f"{name} {prec}: two launches on the same inputs differ")
        if not bool(torch.isfinite(logits).all()) or any(
                not bool(torch.isfinite(v).all()) for v in new.values()):
            raise AssertionError(f"{name} {prec}: outputs are not finite")
        if pack["form"] == "bf16" and int(logits.argmax()) != int(logits_ref.argmax()):
            raise AssertionError(f"{name} {prec}: argmax differs from the plain version's")
        err = max([float((logits - logits_ref).abs().max())]
                  + [float((new[k] - new_ref[k]).abs().max()) for k in new])
        print(f"{name} {prec}: {n_states} seeded states at {cfg.n_layer} layers, worst distance "
              f"from the plain version {worst:.3e} of the scale (limit {limit}); two launches "
              f"bit-identical; max abs err {err:.3e}, argmax {int(logits.argmax())} vs "
              f"{int(logits_ref.argmax())}")
        kern = device_ms(lambda: step(pack, one, tok, cfg), reps=20)
        plain = device_ms(lambda: step_ref(pack, one, tok, cfg), reps=3, warmup=1)
        nb = pack_bytes(pack, cfg)
        n_weights = layer_codes(pack) + head_weights(pack)
        b, kind = bound_ms(nb, 2 * n_weights, op_rate(pack))
        grid = pack.get("_grid_v6", pack.get("_grid_v45", pack.get("_grid")))
        plan = f"; {k3_plan_str(pack, cfg)}" if cfg.version_major == 7 else ""
        print(f"{name} {prec}: kernel {kern:.4f} ms, plain {plain:.4f} ms, bound {b:.5f} ms "
              f"({kind}, {nb / 1e6:.1f} MB), grid {grid} blocks{plan}")
        out[prec] = {"ms": kern, "plain_ms": plain, "library_ms": None, "bound_ms": b,
                     "bound_by": kind, "max_abs_err": err}
    return out


def grid_invariance(name: str, models, cfg, width: str, seed: int = 9) -> None:
    """K3, K6, K7 or K8 (by the config's version) on the packs at a published
    width cut to 2 layers (a shallower config over the same buffers) on the
    full grid and on half of it: logits, x and state bit-equal in every
    form. Launches through the C entry, so the launch counters do not
    move."""
    import dataclasses

    import torch

    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.tools.card import decode_entry, seeded_states

    key, launch = {7: ("_grid", M.decode_launch), 6: ("_grid_v6", M.v6_decode_launch),
                   5: ("_grid_v45", M.v45_decode_launch),
                   4: ("_grid_v45", M.v45_decode_launch)}[cfg.version_major]
    states, tokens = seeded_states(next(iter(models.values())), cfg, 1, 16, seed=seed)
    cd = dataclasses.replace(cfg, n_layer=2)
    st = {k: v[0, :2].contiguous() for k, v in states.items()}
    grids = ()
    for prec, model in models.items():
        pack = model._mega
        full = pack[key]
        grids = (full, full // 2)
        outs = []
        for grid in grids:
            pack[key] = grid
            logits, new, scratch = launch(decode_entry(pack), pack, st, tokens[:1], cd)
            outs.append([logits, scratch[: cfg.n_embed]] + [new[k] for k in sorted(new)])
        pack[key] = full
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{name} {prec}: grids of {grids} blocks give different outputs")
    print(f"{name} {', '.join(models)}: 2 layers at the {width} width bit-equal on grids of "
          f"{grids} blocks")


def phase_cut_width(name: str, width) -> None:
    """The decode kernel on a 2-layer pair (w8a8, w4a8) at another
    published width: the shallow checks, from 8 seeded states."""
    import torch

    from rwkv_tpu_torch.tools.card import width_models

    cfg, models = width_models(width)
    check_shallow(f"{name} {width[0]} C={cfg.n_embed} L={cfg.n_layer}", models, cfg, 8, 8)
    del models
    torch.cuda.empty_cache()


def phase_k4_wide():
    """K4 at B=1 on the 1.5B width (C=2048, F=8192, depth cut to 2), where
    ServingModel routes B=1 to K4 and the head (K3 refuses the width),
    w8a8 and bf16 (placement (b) at every B there; B=3 too)."""
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops.megakernel import v7_decode_batched
    from rwkv_tpu_torch.tools.card import seeded_states

    cfg = synth_config("7.0", 2, 2048, 65536, 64)
    params = synth_params(cfg, seed=0)
    res = {}
    for precision in ("w8a8", "bf16"):
        model = ServingModel((cfg, params), precision=precision, megakernel=True)
        if model._mega_k3:
            raise AssertionError("the 1.5B width should not route B=1 to K3")
        states, tokens = seeded_states(model, cfg, 3, 16, seed=6)
        bf16 = precision == "bf16"
        res[precision] = phase_k4(model._mega, cfg, states, tokens, 1,
                                  f"K4 {precision} C=2048 L=2 B=1",
                                  BF16_SHALLOW_REL if bf16 else None)
        if bf16:
            res["bf16 B=3"] = phase_k4(model._mega, cfg, states, tokens, 3,
                                       "K4 bf16 C=2048 L=2 B=3", BF16_SHALLOW_REL)
        before = v7_decode_batched.launches_by_form[model._mega["form"]]
        one = {k: v[:1] for k, v in states.items()}
        logits, _ = model.decode(tokens[:1], one)
        torch.cuda.synchronize()
        if (v7_decode_batched.launches_by_form[model._mega["form"]] != before + 1
                or logits.shape != (1, cfg.n_vocab)):
            raise AssertionError(f"B=1 at the 1.5B width ({precision}) did not decode through K4")
        del model
    return res


# kernels every B=1 main path of a precision launches besides its decode
# kernel (and K5 for v5 / v6): K1 for the int formats' per-op prefill; the
# dense bf16 prefill runs torch.matmul
B1_NEEDED = {"w8a8": ("K1",), "w4a8": ("K1",), "bf16": ()}


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


def counted(fn, needed):
    """Run fn() with every kernel's launch counter zeroed just before and
    read just after; raise unless each kernel in `needed` launched. K9
    counts each form on its own ("K9 plain", ..., "K9 rowwise"), and K3, K4,
    K6-K8 and K10-K15 each weight form beside their total ("K3 bf16", "K4
    i8", "K13 mix45 i4": K13's v4 / v5 form)."""
    from rwkv_tpu_torch.ops.chunked import wkv6_recurrence, wkv7_recurrence
    from rwkv_tpu_torch.ops.kernels import quant_matmul
    from rwkv_tpu_torch.ops import megakernel as M
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    counters = {"K1": quant_matmul, "K2": wkv7_recurrence, "K3": M.v7_decode_step,
                "K4": M.v7_decode_batched, "K5": wkv6_recurrence, "K6": M.v6_decode_step,
                "K7": M.v5_decode_step, "K8": M.v4_decode_step, "K10": TP.tp_att_layer,
                "K11": TP.tp_ffn_layer, "K12": TP.tp_att_layer_v6, "K13": TP.tp_ffn_layer_v6,
                "K13 mix45": TP.tp_ffn_layer_v45, "K14": TP.tp_att_layer_v4,
                "K15": TP.tp_att_layer_v5}
    by_form = {"K9": quant_matmul.launches_by_form}
    by_form.update({k: counters[k].launches_by_form
                    for k in ("K3", "K4", "K6", "K7", "K8", "K10", "K11", "K12", "K13",
                              "K13 mix45", "K14", "K15")})
    for c in counters.values():
        c.launches = 0
    for forms in by_form.values():
        for form in forms:
            forms[form] = 0
    out = fn()
    launches = {k: c.launches for k, c in counters.items()}
    launches.update({f"{k} {form}": n for k, forms in by_form.items() for form, n in forms.items()})
    for k in needed:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on this path: {launches}")
    return out, launches


def single_stream_path(name, model, prompt, cfg, card, n_runs: int,
                       needed=("K1", "K2", "K3"), n_decode: int = 64):
    """The B=1 main path: n_runs timing runs, then the counted run, which
    must launch every kernel in `needed`."""
    import torch

    samples = [run_main_path(model, prompt, n_decode)[:2] for _ in range(n_runs)]
    (t_prefill, t_decode, toks, logits, state), launches = counted(
        lambda: run_main_path(model, prompt, n_decode), needed)
    print(f"{name} main path launches: {launches}")
    samples.append((t_prefill, t_decode))
    toks = torch.cat(toks).cpu()
    if logits.shape != (cfg.n_vocab,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} main path logits are not finite [V]")
    for k, v in state.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name} main path state {k} is not finite")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.n_vocab:
        raise AssertionError(f"{name}: decoded token out of range")
    pre = sorted(t for t, _ in samples)
    dec = sorted(t for _, t in samples)
    print(f"{name} main path on {card}, {len(samples)} runs: prefill 256 tokens median "
          f"{pre[len(pre) // 2] * 1e3:.2f} ms ({256 / pre[len(pre) // 2]:.0f} tok/s; "
          f"all ms {[round(t * 1e3, 2) for t in pre]}), decode {n_decode} tokens at B=1 median "
          f"{dec[len(dec) // 2] * 1e3:.2f} ms ({n_decode / dec[len(dec) // 2]:.0f} tok/s; "
          f"all ms {[round(t * 1e3, 2) for t in dec]}); first tokens {toks[:8].tolist()}")
    return launches


# -- the tensor-parallel decode: K10-K15 ------------------------------------

# K10-K15 against their plain versions: the TP step on packs cut to the
# model's first 1 and 2 layers, at tp = 2 and 4 on this card, from seeded
# states, x and state within TP_SHALLOW_REL of their scale (the int forms:
# K6's shallow limit, which allows an int8 code flip; bf16: sums in another
# order). The served path against the same model without a mesh, x and
# logits: the int forms within TP_VS_SINGLE_REL of the scale with the TP
# argmax in the single-device top 5 (JAX's band between its TP and
# single-chip kernels, tests/test_megakernel_tp.py: per-shard activation
# scales on out and fv; the v6 1.6B width at 24 layers read 13.3% in x,
# PERF.md), bf16 x within TP_VS_SINGLE_BF16[version] (v7, v5, v4 1e-4, v6
# 1e-3: JAX's).
TP_SHALLOW_REL = {"w8a8": 2e-2, "w4a8": 2e-2, "bf16": BF16_SHALLOW_REL}
TP_VS_SINGLE_REL = 1.5e-1
TP_VS_SINGLE_BF16 = {7: 1e-4, 6: 1e-3, 5: 1e-4, 4: 1e-4}
# bf16 logits: the TP route's per-op bf16 head against the same head on
# the single-device x (K6-K8 run their head in the kernel on f32
# activations; the per-op head rounds them to bf16, ~2e-3 of the scale
# apart), so a last-bit difference in x may flip one rounding
# (tests/test_torch_cuda.py's band)
TP_BF16_HEAD_REL = 2e-3
# RWKV-7 World 1.5B width, LoRA 96 (scripts/bench_15b.py:32-33)
V7_TP_WIDTH = ("7.0", 24, 2048, 65536, 64)
V7_TP_LORA = 96
# RWKV-4 World 1.5B width (BlinkDL's RWKV-4-World-1.5B: 24 layers, n_embd
# 2048), where v4 is sharded; the v4 single-device path runs the 0.1B width
V4_TP_WIDTH = ("4.0", 24, 2048, 65536, 64)
# the TP paths served at a cut depth (layers): v7's and v6's w4a8 and bf16
# forms, whose per-launch times do not depend on depth, keep the run within
# its time
TP_CUT_DEPTH = 4
# (attention, FFN) kernel of each version's TP path
TP_KERNELS = {7: ("K10", "K11"), 6: ("K12", "K13"), 5: ("K15", "K13 mix45"),
              4: ("K14", "K13 mix45")}


def cut(cfg, params, depth: int):
    """The model cut to its first `depth` layers: (cfg, params)."""
    import dataclasses

    return dataclasses.replace(cfg, n_layer=depth), {**params, "blocks": params["blocks"][:depth]}


def tp_base(cfg, params, precision: str, depth: int):
    """The decode pack of the model cut to its first `depth` layers."""
    from rwkv_tpu_torch.ops import megakernel as M

    cd, cp = cut(cfg, params, depth)
    build = {7: M.build_mega_pack, 6: M.build_mega_pack_v6, 5: M.build_mega_pack_v5,
             4: M.build_mega_pack_v4}[cfg.version_major]
    return cd, build(cp, cd, w4=precision == "w4a8", quant=precision != "bf16")


def tp_packs_on_card(base, cfg, tp: int):
    """`base` re-laid out for tp shards, all on this card."""
    from rwkv_tpu_torch.ops import megakernel_tp as TP
    from rwkv_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(1, tp, devices=["cuda:0"] * tp)
    build = {7: TP.build_mega_pack_tp, 6: TP.build_mega_pack_tp_v6, 5: TP.build_mega_pack_tp_v5,
             4: TP.build_mega_pack_tp_v4}[cfg.version_major]
    return build(base, cfg, mesh)


def phase_tp_kernels(name: str, cfg, params, n_states: int = 4, seed: int = 7) -> dict:
    """The TP kernels of a version (K10 / K11, K12 / K13, K15 / K13 mix45
    or K14 / K13 mix45) in every form against their plain versions
    (tools/card.py::tp_vs_plain) on packs cut to 2 layers, at depths 1 and
    2, tp = 2 and 4, from n_states states of a seeded prefill of the cut
    model (v4: also from the blank state, pp = -1e30); two launches
    bit-identical. Returns {precision: max abs err}."""
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.ops.parity import layer_norm
    from rwkv_tpu_torch.tools.card import seeded_states, tp_vs_plain

    cd, base = tp_base(cfg, params, "w8a8", 2)
    probe = ServingModel(cut(cfg, params, 2), precision="w8a8")
    states, tokens = seeded_states(probe, cd, n_states, 16, seed=seed)
    x0s = layer_norm(probe.params["emb"][tokens].float(), *probe.params["ln0"])
    if cfg.version_major == 4:  # the blank state as the last one
        blank = probe.init_state(1)
        states = {k: torch.cat([v, blank[k]]) for k, v in states.items()}
        x0s = torch.cat([x0s, x0s[:1]])
        n_states += 1
    del probe
    step = tp_step(cfg.version_major)
    out = {}
    for prec in ("w8a8", "w4a8", "bf16"):
        if prec != "w8a8":
            cd, base = tp_base(cfg, params, prec, 2)
        worst, err = {}, 0.0
        for tp in (2, 4):
            packs = tp_packs_on_card(base, cd, tp)
            for i in range(n_states):
                st = {k: v[i] for k, v in states.items()}
                for depth in (1, 2):
                    e = tp_vs_plain(packs, cd, st, x0s[i], depth)
                    err = max(err, e["max_abs_err"])
                    worst[(tp, depth)] = max(worst.get((tp, depth), 0.0), e["x"], e["state"])
                    if max(e["x"], e["state"]) > TP_SHALLOW_REL[prec]:
                        raise AssertionError(f"{name} {prec} tp={tp} depth {depth}: {e} of the "
                                             f"scale, limit {TP_SHALLOW_REL[prec]}")
            st = {k: v[0] for k, v in states.items()}
            a, b = step(packs, st, x0s[0], cd), step(packs, st, x0s[0], cd)
            torch.cuda.synchronize()
            if not torch.equal(a[0], b[0]) or any(not torch.equal(a[1][k], b[1][k]) for k in a[1]):
                raise AssertionError(f"{name} {prec} tp={tp}: two launches on the same inputs differ")
            tp6_same_on_half_grid(f"{name} {prec} tp={tp}", packs[0], cd, st, x0s[0])
            del packs
        print(f"{name} {prec}: {n_states} states, tp = 2 and 4, depths 1 and 2: worst "
              f"distance from the plain versions over the scale {worst} (limit "
              f"{TP_SHALLOW_REL[prec]}); max abs err {err:.3e}; two launches bit-identical; "
              f"{name} bit-equal on the full and half grid")
        out[prec] = err
        del base
        torch.cuda.empty_cache()
    return out


def tp6_same_on_half_grid(label: str, pk, cfg, st, x0) -> None:
    """The stream TP kernels of shard pack pk -- K10 (v7; layer 1, reading
    v_first), K11 (v7), K12 (v6), K15 (v5), K14 (v4) and K13 (v6, and its
    MIX45 form on v5 / v4 packs) -- at layer 0 (K10 1) through their C
    entries on the full grid and on half of it: every output bit-equal
    (their stream plans deal rows over the grid but never change how a row
    is computed). The launch counters do not move."""
    import torch

    from rwkv_tpu_torch.ops import megakernel_tp as TP

    v, c_loc = pk["version"], pk["c_loc"]
    for kind in ("att", "ffn"):
        full, fn = TP.tp6_grid(pk, kind, cfg), TP.tp6_function(pk, kind)
        outs = []
        for grid in (full, full // 2):
            heads = st["heads"][int(v == 7), : c_loc // cfg.head_size] if v != 4 else None
            if kind == "ffn" and v == 7:
                outs.append(TP.tp7_ffn_launch(fn, pk, 0, x0, st["ffn_xx"][0], cfg, grid))
            elif kind == "ffn":
                outs.append(TP.tp6_ffn_launch(fn, pk, 0, x0, st["ffn_xx"][0], cfg, grid))
            elif v == 4:
                own = tuple(st[k][0, :c_loc] for k in ("aa", "bb", "pp"))
                outs.append(TP.tp4_att_launch(fn, pk, 0, x0, st["att_xx"][0], *own, cfg, grid))
            elif v == 7:
                vf = x0[: pk["c_loc"]].contiguous()
                outs.append(TP.tp7_att_launch(fn, pk, 1, x0, st["att_xx"][1], heads, vf, False,
                                              cfg, grid))
            elif v == 5:
                outs.append(TP.tp5_att_launch(fn, pk, 0, x0, st["att_xx"][0], heads, cfg, grid))
            else:
                outs.append(TP.tp6_att_launch(fn, pk, 0, x0, st["att_xx"][0], heads, cfg, grid))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{label}: {kind} kernel differs on grids of {full} and "
                                 f"{full // 2} blocks")


def tp_step(version: int):
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    return {7: TP.tp_decode_step, 6: TP.tp_decode_step_v6, 5: TP.tp_decode_step_v5,
            4: TP.tp_decode_step_v4}[version]


def tp_launch_bytes(pk: dict, kind: str, cfg) -> tuple:
    """(bytes, weight values) one K10-K15 launch must move: its shard's
    matrices and scales of one layer (the replicated ones too: every shard
    reads them), the vector rows it reads, x and the token-shift input, the
    shard's wkv state read and written (attention), its outputs."""
    from rwkv_tpu_torch.ops import megakernel_tp as TP

    v = pk["version"]
    c, c_loc, s = cfg.n_embed, pk["c_loc"], cfg.head_size
    if kind == "att":
        mats = {7: ("rkv", "lora1", "lora2", "out"), 6: ("rkvg", "maa1", "dw1", "dw2", "out"),
                5: ("rkvg", "out"), 4: ("rkv", "out")}[v]
        rvec_rows = 8 if v in (6, 7) else 2 + pk["n_mix"]
        lvec_rows = {7: len(TP.TP_LVECS), 6: len(TP.TP6_LVECS), 5: len(TP.TP5_LVECS),
                     4: len(TP.TP4_LVECS)}[v]
        state = 6 * c_loc if v == 4 else 2 * c_loc * s
        act = (2 + 2) * c + (c_loc if v == 7 else 0) + state
    else:
        mats = ("fk", "fv") if v == 7 else ("fr", "fk", "fv")
        rvec_rows, lvec_rows = (3 if v == 7 else 4), 0
        act = (2 + 2) * c + (0 if v == 7 else c_loc)
    n = 0
    values = 0
    for m in mats:
        w = pk[m][0]
        n += w.numel() * w.element_size()
        values += w.numel() * (2 if pk["w4"] and m in TP._W4_MATS[v] else 1)
        if m + "_d" in pk:
            n += pk[m + "_d"][0].numel() * 4
    if v == 6 and kind == "att":
        n += pk["maa2"][0].numel() * 4
        values += pk["maa2"][0].numel()
    return n + (rvec_rows * c + lvec_rows * c_loc + act) * 4, values


def tp_kernel_times(packs, cfg, state, x0) -> dict:
    """Device time of one launch of each TP kernel of `packs` (shard 0,
    layer 1, the main path's shapes), its plain version's, the bound."""
    from rwkv_tpu_torch.ops import megakernel_tp as TP
    from rwkv_tpu_torch.tools.card import device_ms

    pk, l = packs[0], 1
    v, c_loc = pk["version"], pk["c_loc"]
    xx, fxx = state["att_xx"][l], state["ffn_xx"][l]
    if v == 4:
        own = tuple(state[k][l, :c_loc] for k in ("aa", "bb", "pp"))
    else:
        own = (state["heads"][l, : c_loc // cfg.head_size],)
    if v == 7:
        own += (x0[:c_loc].contiguous(), False)
    att = {7: (TP.tp_att_layer, TP.tp_att_layer_ref), 6: (TP.tp_att_layer_v6,
           TP.tp_att_layer_v6_ref), 5: (TP.tp_att_layer_v5, TP.tp_att_layer_v5_ref),
           4: (TP.tp_att_layer_v4, TP.tp_att_layer_v4_ref)}[v]
    ffn = {7: (TP.tp_ffn_layer, TP.tp_ffn_layer_ref), 6: (TP.tp_ffn_layer_v6,
           TP.tp_ffn_layer_v6_ref)}.get(v, (TP.tp_ffn_layer_v45, TP._ffn45_ref))
    calls = {"att": tuple((lambda f=f: f(pk, l, x0, xx, *own, cfg)) for f in att),
             "ffn": tuple((lambda f=f: f(pk, l, x0, fxx, cfg)) for f in ffn)}
    out = {}
    for kind, (kern, plain) in calls.items():
        nb, values = tp_launch_bytes(pk, kind, cfg)
        b, by = bound_ms(nb, 2 * values, op_rate(pk))
        out[kind] = {"ms": device_ms(kern, reps=50), "plain_ms": device_ms(plain, reps=3, warmup=1),
                     "bound_ms": b, "bound_by": by, "library_ms": None, "bytes": nb}
    return out


def tp_serving_path(name: str, cfg, params, precision: str, prompt, card, ref=None) -> tuple:
    """ServingModel((cfg, params), precision, megakernel=True, mesh=
    make_mesh(1, 2, devices=[cuda:0, cuda:0])): the B=1 main path (prefill,
    64 greedy decode steps, counted: the attention and FFN kernels must
    launch), then 16 steps from its prefill state, each step's x (before
    ln_out) and logits held to the same model without a mesh (`ref`, built
    here when None; its decode kernel; under bf16 the per-op head on its x)
    on the same state and token (TP_VS_SINGLE_*, TP_BF16_HEAD_REL).
    Returns (launches, {kind: per-launch times})."""
    import torch

    from rwkv_tpu_torch.models import graph as G
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.ops.parity import layer_norm
    from rwkv_tpu_torch.parallel.sharding import make_mesh
    from rwkv_tpu_torch.tools.card import rel_err, single_device_x

    t0 = time.perf_counter()
    model = ServingModel((cfg, params), precision=precision, megakernel=True,
                         mesh=make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
    t_build = time.perf_counter() - t0
    form = model._mega_tp[0]["form"]
    version = cfg.version_major
    att, ffn = TP_KERNELS[version]
    prefill = {7: ("K2",), 6: ("K5",), 5: ("K5",), 4: ()}[version]
    needed = B1_NEEDED[precision] + prefill + (f"{att} {form}", f"{ffn} {form}")
    launches = single_stream_path(name, model, prompt, cfg, card, 1, needed=needed)
    print(f"{name}: TP model ({cfg.n_layer} layers) built in {t_build:.1f} s; "
          f"{launches[f'{att} {form}'] / 64:g} {att} and {launches[f'{ffn} {form}'] / 64:g} "
          f"{ffn} launches per token (layers x shards)")
    own_ref = ref is None
    if own_ref:
        ref = ServingModel((cfg, params), precision=precision, megakernel=True)
    logits, state = model.prefill(prompt)
    worst = {"x": 0.0, "logits": 0.0}
    top5, same = True, True
    step = tp_step(version)
    for _ in range(16):
        tok = logits.argmax().reshape(1)
        one = {k: v[0] for k, v in state.items()}
        x0 = layer_norm(model.params["emb"][tok[0]].float(), *model.params["ln0"])
        lt, new = model.decode(tok, state)
        lr, _ = ref.decode(tok, state)
        x_tp, _ = step(model._mega_tp, one, x0, cfg)
        x_single = single_device_x(ref, state, tok)
        if precision == "bf16":
            lr = G.mm(layer_norm(x_single, *ref.params["ln_out"])[None, :], ref.params["head"])
        worst["x"] = max(worst["x"], rel_err(x_tp, x_single))
        worst["logits"] = max(worst["logits"], float((lt - lr).abs().max()) / float(lr.abs().max()))
        top5 &= int(lt.argmax()) in torch.topk(lr[0], 5).indices.tolist()
        same &= int(lt.argmax()) == int(lr.argmax())
        state, logits = new, lt[0]
    if precision == "bf16":
        limits = {"x": TP_VS_SINGLE_BF16[version], "logits": TP_BF16_HEAD_REL}
    else:
        limits = {"x": TP_VS_SINGLE_REL, "logits": TP_VS_SINGLE_REL}
    print(f"{name}: 16 steps against the model without a mesh, from the same state and token: "
          f"worst {worst} of the scale (limits {limits}); TP argmax in its top 5: {top5}, "
          f"equal: {same}")
    if any(worst[k] > limits[k] for k in limits) or not top5 or (precision == "bf16" and not same):
        raise AssertionError(f"{name}: the TP path strays from the single-device one")
    if own_ref:
        del ref
    x0 = layer_norm(model.params["emb"][prompt[-1]].float(), *model.params["ln0"])
    times = tp_kernel_times(model._mega_tp, cfg, {k: v[0] for k, v in state.items()}, x0)
    for kind, t in times.items():
        print(f"{name} {att if kind == 'att' else ffn}: kernel {t['ms']:.4f} ms a launch, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
              f"{t['bytes'] / 1e6:.2f} MB)")
    del model
    torch.cuda.empty_cache()
    return launches, times


def tp_paths(tag: str, cfg, params, prompt, card, launches: dict, ref=None) -> dict:
    """The TP main paths of one model (``tp_serving_path``): w8a8 at its
    full depth (held to `ref`, or to a model built there), w4a8 and bf16 on
    the model cut to TP_CUT_DEPTH layers. Records each path's launches in
    `launches` ("tp <tag> <precision>"); returns {precision: (launches,
    per-launch times)}."""
    out = {}
    for prec in ("w8a8", "w4a8", "bf16"):
        c, p, r = (cfg, params, ref) if prec == "w8a8" else (*cut(cfg, params, TP_CUT_DEPTH), None)
        out[prec] = tp_serving_path(f"tp {tag} {prec}", c, p, prec, prompt, card, ref=r)
        launches[f"tp {tag} {prec}"] = out[prec][0]
    return out


def phase_k4_large(model, model4, model16, cfg) -> dict:
    """K4 where decode already sends it: B = 128 and 256 (MEGA_MAX_BATCH)
    on the 169M w8a8, w4a8 and bf16 packs, from states of a seeded batched
    prefill, check_k4 at the full depth's limits, and its time."""
    from rwkv_tpu_torch.tools.card import seeded_states

    states, tokens = seeded_states(model, cfg, 256, 32, seed=10)
    out = {}
    for b in (128, 256):
        out[f"K4 B={b}"] = phase_k4(model._mega, cfg, states, tokens, b, f"K4 w8a8 B={b}")
        out[f"K4w4 B={b}"] = phase_k4(model4._mega, cfg, states, tokens, b, f"K4 w4a8 B={b}")
        out[f"K4bf16 B={b}"] = phase_k4(model16._mega, cfg, states, tokens, b,
                                        f"K4 bf16 B={b}")
    return out


# the 169M file paths: (format, K9 form its quantized projections run)
FILE_PATHS = (("Q5_1", "min"), ("Q4_0", "pack4"), ("Q4_1", "pack4_min"))


def phase_files(cfg, params, prompt, card, tmp: str) -> dict:
    """The v7 169M model (cfg, params) written as an FP32 ggmf into `tmp`
    and quantized by the port to each of FILE_PATHS;
    ServingModel(path, precision="quant") per file: a 256-token prompt and
    64 greedy decode steps at B=1 on the per-op path (K2, K9); Q5_1 again
    with megakernel=True (K9 in prefill, K3 in decode); then q8 and q8r on
    (cfg, params), prefill and 16 decode steps. The FP32, Q5_1 and Q4_0
    files stay in `tmp` for ``phase_parity``. Returns the launches of each
    path and the seconds the port's Python quantizer took for each format."""
    import os

    import torch

    from rwkv_tpu_torch.io.quantize import quantize_model_file
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

    launches, seconds = {}, {}
    src = os.path.join(tmp, "v7-169m-FP32.bin")
    t0 = time.perf_counter()
    write_synth_ggmf(cfg, params, src)
    print(f"169M FP32 ggmf written in {time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(src) / 1e6:.1f} MB)")
    for fmt, form in FILE_PATHS:
        path = os.path.join(tmp, f"v7-169m-{fmt}.bin")
        t0 = time.perf_counter()
        quantize_model_file(src, path, fmt, verbose=False)
        t1 = time.perf_counter()
        seconds[fmt] = t1 - t0
        model = ServingModel(path, precision="quant")
        print(f"{fmt}: quantized in {t1 - t0:.1f} s ({os.path.getsize(path) / 1e6:.1f} MB), "
              f"loaded in {time.perf_counter() - t1:.1f} s")
        launches[f"quant {fmt}"] = single_stream_path(
            f"quant {fmt}", model, prompt, cfg, card, 2, needed=("K2", f"K9 {form}"))
        del model
        if fmt == "Q5_1":
            model = ServingModel(path, precision="quant", megakernel=True)
            launches["quant Q5_1 megakernel"] = single_stream_path(
                "quant Q5_1 megakernel=True", model, prompt, cfg, card, 2,
                needed=("K2", "K3", "K9 min"))
            del model
        if fmt not in PARITY_FORMATS:
            os.unlink(path)
        torch.cuda.empty_cache()
    for precision, form in (("q8", "plain"), ("q8r", "rowwise")):
        model = ServingModel((cfg, params), precision=precision)
        launches[precision] = single_stream_path(precision, model, prompt, cfg, card, 1,
                                                 needed=("K2", f"K9 {form}"), n_decode=16)
        del model
        torch.cuda.empty_cache()
    return launches, seconds


# -- the ggml-parity engine and the tools -------------------------------------

# The parity engine (models.model.RWKVModel) on the card against the same
# file on the CPU. FP32 / FP16 files run float32 products on both (TF32
# off): within PARITY_DENSE_REL of the scale. Quantized files quantize the
# activations to int8 codes with fp16-rounded block scales, so a last-bit
# difference upstream can move a code across a .5 boundary or a scale
# across its rounding midpoint, and the flip grows through the layers (the
# port against JAX on the CPU: scripts/probe_torch_parity_flips.py, PERF.md);
# the prompt and every greedy step are held within PARITY_QUANT_REL at
# the 169M width and PARITY_SMALL_QUANT_REL on the small files (L=2,
# C=256), each about twice the worst reading that
# scripts/parity_card_readings.py printed on the H100 (169M Q4_K 4.47e-2,
# small v6 Q4_1 1.56e-2, both at a greedy step; PERF.md), with equal
# argmax on the prompt's logits.
PARITY_FORMATS = ("FP32", "FP16", "Q4_0", "Q5_1", "Q4_K")
PARITY_DENSE_REL = 1e-4
PARITY_QUANT_REL = 9e-2
PARITY_SMALL_QUANT_REL = 3e-2
PARITY_PROMPT, PARITY_CHUNK, PARITY_GREEDY = 64, 16, 16
# the fixed text of the tools' perplexity runs
TOOLS_TEXT = ("The quick brown fox jumps over the lazy dog. RWKV is a recurrent network "
              "with the quality of a transformer: its state has a fixed size, so a token "
              "costs the same however long the text before it.")


def parity_rel(a, b) -> float:
    """max |a - b| over max |b| (b on the CPU)."""
    return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def parity_run(gpu, cpu, tokens, chunk: int, n_greedy: int, band: float, name: str) -> dict:
    """`tokens` through eval_sequence_in_chunks on both models, then
    `n_greedy` eval steps with the card's greedy tokens fed to both, so
    both models see the same tokens throughout: the prompt's logits and
    state and every step's within `band` of their scale, with equal argmax
    on the prompt's logits. Returns the worst reading of the prompt and of
    each step, how many of the CPU's greedy picks equal the card's, and the
    card's ms a chunk and a token."""
    import torch

    gpu.eval(0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, sg = gpu.eval_sequence_in_chunks(tokens, chunk_size=chunk)
    torch.cuda.synchronize()
    ms_chunk = (time.perf_counter() - t0) * 1e3 / -(-len(tokens) // chunk)
    lc, sc = cpu.eval_sequence_in_chunks(tokens, chunk_size=chunk)
    rels, agree, ms_token = [], 0, 0.0
    for step in range(n_greedy + 1):
        if step:
            tok = int(lg.argmax())
            agree += int(lc.argmax()) == tok
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, sg = gpu.eval(tok, sg)
            torch.cuda.synchronize()
            ms_token += (time.perf_counter() - t0) * 1e3 / n_greedy
            lc, sc = cpu.eval(tok, sc)
        if lg.shape != lc.shape or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"parity {name} step {step}: logits not finite [V]")
        rels.append(max([parity_rel(lg, lc)] + [parity_rel(sg[k], sc[k]) for k in sc]))
        if rels[-1] > band:
            raise AssertionError(f"parity {name} step {step}: card vs CPU {rels[-1]:.3e} of "
                                 f"the scale, limit {band}")
        if not step and int(lg.argmax()) != int(lc.argmax()):
            raise AssertionError(f"parity {name}: the prompt's argmax differs")
    return {"rel": max(rels), "rel_prompt": rels[0], "rel_steps": rels[1:], "agree": agree,
            "ms_chunk": ms_chunk, "ms_token": ms_token}


def parity_line(r: dict) -> str:
    """parity_run's readings as text: the prompt's and the steps' worst."""
    return (f"card vs CPU {r['rel_prompt']:.3e} of the scale on the prompt, "
            f"{max(r['rel_steps']):.3e} over the greedy steps "
            f"(by step: {', '.join(f'{e:.2e}' for e in r['rel_steps'])})")


def phase_parity(cfg, params, card, tmp: str) -> dict:
    """The ggml-parity engine at the 169M width: RWKVModel on the card
    against the CPU on the FP32, Q5_1 and Q4_0 files of ``phase_files``, an
    FP16 file and a Q4_K one (PARITY_FORMATS): a PARITY_PROMPT-token prompt
    in chunks of PARITY_CHUNK, then PARITY_GREEDY greedy steps. Then the
    tools' loops as functions, with the World tokenizer and seeded rngs:
    the generation loop on the parity engine (FP32) and on ``--serve w4a8
    --megakernel`` (K1, K2, K3), perplexity over TOOLS_TEXT on Q5_1 through
    the parity engine and through ``--serve quant`` (K2, K9 min), and two
    turns of ChatSession with a replay from its snapshot. Returns the
    launches of the serve routes and the card and CPU models of the FP32
    and Q5_1 files, {fmt: (card, cpu)}, for ``phase_reservoir``."""
    import contextlib
    import io
    import os

    import torch

    from rwkv_tpu_torch.io.quantize import quantize_model_file
    from rwkv_tpu_torch.models.model import RWKVModel
    from rwkv_tpu_torch.tools.chat_with_bot import PROMPTS_DIR, ChatSession
    from rwkv_tpu_torch.tools.generate_completions import generate, load_model
    from rwkv_tpu_torch.tools.measure_perplexity import measure_perplexity
    from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf
    from rwkv_tpu_torch.utils.tokenizer import get_tokenizer

    t_phase = time.perf_counter()
    path = {fmt: os.path.join(tmp, f"v7-169m-{fmt}.bin") for fmt in PARITY_FORMATS}
    t0 = time.perf_counter()
    write_synth_ggmf(cfg, params, path["FP16"], "FP16")
    t1 = time.perf_counter()
    quantize_model_file(path["FP32"], path["Q4_K"], "Q4_K", verbose=False)
    print(f"parity files: FP16 written in {t1 - t0:.1f} s, Q4_K quantized in "
          f"{time.perf_counter() - t1:.1f} s")
    prompt = np.random.default_rng(11).integers(0, cfg.n_vocab, PARITY_PROMPT).tolist()
    models = {}
    for fmt in PARITY_FORMATS:
        t0 = time.perf_counter()
        gpu, cpu = RWKVModel(path[fmt]), RWKVModel(path[fmt], device="cpu")
        t_load = time.perf_counter() - t0
        band = PARITY_DENSE_REL if fmt in ("FP32", "FP16") else PARITY_QUANT_REL
        r = parity_run(gpu, cpu, prompt, PARITY_CHUNK, PARITY_GREEDY, band, f"169M {fmt}")
        print(f"parity 169M {fmt} on {card}: {parity_line(r)}, limit {band}; prompt argmax "
              f"equal, CPU greedy picks equal to the card's at "
              f"{r['agree']} of {PARITY_GREEDY} steps; {r['ms_chunk']:.2f} ms a "
              f"{PARITY_CHUNK}-token chunk, {r['ms_token']:.2f} ms a token "
              f"(both models loaded in {t_load:.1f} s)")
        if fmt in ("FP32", "Q5_1"):
            models[fmt] = (gpu, cpu)
        del gpu, cpu
    torch.cuda.empty_cache()

    decode, encode = get_tokenizer("auto", cfg.n_vocab)
    words = encode("One upon a time,")
    launches = {}

    def gen(model):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            streams = generate(model, "One upon a time,", words, decode, 1, PARITY_GREEDY, 0.8,
                               0.5, np.random.default_rng(0))
        took = [ln for ln in out.getvalue().splitlines() if ln.startswith("Took")]
        return streams[0], took[0]

    stream, took = gen(models["FP32"][0])
    print(f"generation loop, parity engine FP32: tokens {stream[:8]}...; {took}")
    serve = load_model(path["FP32"], "w4a8", True)
    gen(serve)  # warm-up
    (stream, took), launches["tools w4a8"] = counted(lambda: gen(serve), ("K1", "K2", "K3"))
    print(f"generation loop, --serve w4a8 --megakernel: tokens {stream[:8]}...; {took}; "
          f"launches {launches['tools w4a8']}")
    del serve
    torch.cuda.empty_cache()
    if any(not 0 <= t < cfg.n_vocab for t in stream):
        raise AssertionError("generation loop: token out of range")

    text = encode(TOOLS_TEXT)
    ppl, ms = measure_perplexity(models["Q5_1"][0], text)
    serve = load_model(path["Q5_1"], "quant")
    measure_perplexity(serve, text[:4])  # warm-up
    (ppl_s, ms_s), launches["tools quant"] = counted(
        lambda: measure_perplexity(serve, text), ("K2", "K9 min"))
    del serve
    print(f"perplexity over {len(text)} tokens, Q5_1 on {card}: parity engine {ppl:.4f} "
          f"({ms:.2f} ms a token), --serve quant {ppl_s:.4f} ({ms_s:.2f} ms a token); "
          f"launches {launches['tools quant']}")
    if not (np.isfinite(ppl) and np.isfinite(ppl_s)):
        raise AssertionError("perplexity is not finite")

    script = json.loads((PROMPTS_DIR / "English-Chat.json").read_text())
    user, bot, sep = script["user"], script["bot"], script["separator"]
    chat = ChatSession(models["FP32"][0], decode, encode, seed=0)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chat.process_tokens(encode(script["prompt"]))
        n_init = len(chat.tokens)
        replies = []
        for msg in ("Hello, who are you?", "What is a recurrent network?"):
            chat.process_tokens(encode(f"{user}{sep} {msg}\n\n{bot}{sep}"))
            snap = chat.snapshot()
            chat.rng = np.random.default_rng(len(replies))
            replies.append(chat.generate(max_len=PARITY_GREEDY))
        chat.restore(snap)
        chat.rng = np.random.default_rng(1)
        replay = chat.generate(max_len=PARITY_GREEDY)
    if replay != replies[1]:
        raise AssertionError(f"ChatSession: the replay from a snapshot differs: {replay} vs "
                             f"{replies[1]}")
    print(f"ChatSession, parity engine FP32: {n_init}-token persona prompt, two turns of "
          f"{[len(r) for r in replies]} tokens, the replay from the snapshot equal, "
          f"{time.perf_counter() - t0:.1f} s")
    del chat
    torch.cuda.empty_cache()
    print(f"parity engine and tools phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, models


# -- the reservoir layer, profiling and the native library -------------------

# phase_reservoir: RES_SEQS seeded sequences of RES_LEN tokens, the first
# RES_WARMUP of each left out of the fits. The reservoir's activations on the
# card are held to the CPU's within the parity engine's bands
# (PARITY_DENSE_REL, PARITY_QUANT_REL: they are its FFN rows). Readouts are
# held within RES_RIDGE_REL / RES_READOUT_REL of the CPU's predictions'
# scale, about twice the worst reading of this phase over task seeds 23-30
# on the H100 (scripts/reservoir_card_readings.py; PERF.md section 6): ridge
# FP32 3.93e-6, Q5_1 5.81e-4; SGD 2.90e-7, RLS 6.74e-7, hierarchical
# 6.13e-7; the MLP trained on the CPU's activations on both devices ("mlp")
# and read end to end on the card's own ("mlp e2e") 2.84e-3 (seed 23: 200
# Adam epochs take float32 sum-order differences apart: one relu gate opens
# on one device only). The first step of a tanh MLP from the same start
# ("mlp grad": gradients over their largest; "mlp step": the change over
# the rate) holds the card's training arithmetic tight: seeds 23-26
# 3.8e-8-1.07e-7 and 1.49e-5, fake data of the phase's shapes 1.98e-7 and
# 1.49e-5, where the card reads 1.24e-4 on TF32 products, 2.25e-3 on bf16
# ones, and a step of 9.91e-3 with its rate 1% off
# (scripts/probe_reservoir_mlp_step.py); "mlp grad" is about five times the
# worst, "mlp step" an ulp of the largest weight over the rate (2.98e-5 up
# to 0.5) with room.
RES_SEQS, RES_LEN, RES_WARMUP, RES_CHAT_TOKENS, RES_SEED = 8, 64, 2, 16, 23
RES_READOUT_SEQS = 4  # the enhanced readouts fit on the first 4 sequences
RES_RIDGE_REL = {"FP32": 8e-6, "Q5_1": 1.2e-3}
RES_READOUT_REL = {"mlp grad": 1e-6, "mlp step": 1e-4, "mlp": 6e-3, "mlp e2e": 6e-3,
                   "online sgd": 6e-7, "online rls": 1.4e-6, "hierarchical": 1.3e-6}


def host_rel(a, b) -> float:
    """max |a - b| over max |b|, numpy arrays (b the CPU's)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"shapes {a.shape} vs {b.shape}, or values not finite")
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def recorded(res) -> list:
    """Every activation array `res` computes from now on, in a list."""
    seen, inner = [], res._get_reservoir_activations

    def wrapper(tokens, return_states=False):
        out = inner(tokens, return_states)
        seen.append(out[0] if return_states else out)
        return out

    res._get_reservoir_activations = wrapper
    return seen


def trace_check(tr, label: str, card: str, kernel=None) -> None:
    """The Chrome trace of `tr` exists and holds device activity (and a
    kernel whose name holds `kernel`); prints what it holds."""
    import torch

    if tr.path is None or not tr.path.exists():
        raise AssertionError(f"trace of {label}: no trace file")
    events = json.loads(tr.path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    device = [e for e in tr.profiler.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels or not device:
        raise AssertionError(f"trace of {label}: no device activity ({len(events)} trace "
                             f"events, {len(tr.profiler.events())} profiler events)")
    found = [e for e in kernels if kernel and kernel in e.get("name", "")]
    if kernel and not found:
        raise AssertionError(f"trace of {label}: no {kernel} among "
                             f"{sorted({e.get('name', '')[:60] for e in kernels})}")
    busy = sum(float(e.get("dur", 0)) for e in kernels)
    extra = (f"; {kernel} {sum(float(e['dur']) for e in found) / 1e3:.4f} ms in "
             f"{len(found)} launch(es)" if kernel else "")
    print(f"trace of {label} on {card}: {tr.path.name} ({tr.path.stat().st_size / 1e3:.0f} kB), "
          f"{len(kernels)} kernels, device busy {busy / 1e3:.4f} ms{extra}")


def mlp_first_step(start: dict, make, x, y, cpu_device, card_device) -> tuple:
    """Card against CPU for a ``MultiLayerReadout`` (``make(device)``) from
    the state `start` on the same (x, y): the first backward's gradients
    (max |card - CPU| over all parameters, over the largest |CPU| of them
    all: a tensor's own largest can be a cancelled sum, as the output
    bias's is for some targets), and the first Adam step of ``fit`` (max
    |card - CPU| of the parameters' change over the learning rate, where
    the CPU's gradient is above 1e-3 of that largest: the step is
    lr * g / (|g| + eps), so a gradient near zero may take either sign on
    the two devices)."""
    import torch

    grads, steps = {}, {}
    for where, dev in (("cpu", cpu_device), ("card", card_device)):
        m = make(dev)
        m.load_state_dict(start)
        yt = m._tensor(np.asarray(y, np.float32).reshape(len(x), -1))
        torch.mean((m(m._tensor(x)) - yt) ** 2).backward()
        grads[where] = {k: p.grad.cpu().numpy() for k, p in m.named_parameters()}
        m.fit(x, y, epochs=1)
        steps[where] = {k: p.detach().cpu().numpy() - start[k].cpu().numpy()
                        for k, p in m.named_parameters()}
    scale = max(float(np.abs(g).max()) for g in grads["cpu"].values())
    grad = max(float(np.abs(grads["card"][k] - g).max()) for k, g in grads["cpu"].items())
    step = max(float(np.abs(steps["card"][k] - steps["cpu"][k])[np.abs(g) > 1e-3 * scale]
                     .max(initial=0.0)) for k, g in grads["cpu"].items())
    return grad / max(scale, 1e-30), step / m.learning_rate


def phase_reservoir(models, model, state, token, card, tmp: str, py_seconds: dict) -> None:
    """The reservoir layer at the 169M width on the card against the CPU,
    on ``phase_parity``'s RWKVModels, {fmt: (card, cpu)}: the ridge
    ``ReservoirRWKV`` (every unit) on FP32 and Q5_1, fit, predict and score
    over RES_SEQS sequences of RES_LEN tokens; on FP32 the enhanced
    reservoir's MLP (the CPU's start and activations carried to the
    card), online (SGD,
    RLS) and hierarchical readouts (on the first RES_READOUT_SEQS
    sequences), and ``ESNChatbot.respond`` for RES_CHAT_TOKENS tokens with
    the same seed. Then ``utils.profiling``:
    traces of a reservoir run and of one K3 decode step of `model` (the
    169M w8a8 ServingModel, from `state` and `token`), and ``StepTimer``
    over 64 K3 steps beside ``device_ms``. Then the native library: built
    with g++, the FP32 file quantized to Q5_1 and Q8_0, byte-equal to the
    port's Python quantizer (its Q5_1 time `py_seconds` from
    ``phase_files``)."""
    import os

    import torch

    from rwkv_tpu_torch import native
    from rwkv_tpu_torch.io.quant import dtype_from_name
    from rwkv_tpu_torch.io.quantize import quantize_model_file
    from rwkv_tpu_torch.reservoir import (EnhancedReservoirRWKV, ESNChatbot, MultiLayerReadout,
                                          ReservoirRWKV)
    from rwkv_tpu_torch.reservoir.esn import esn_create_config
    from rwkv_tpu_torch.tools.card import device_ms
    from rwkv_tpu_torch.utils.profiling import StepTimer, annotate, trace
    from rwkv_tpu_torch.utils.tokenizer import get_tokenizer

    t_phase = time.perf_counter()
    gpu, cpu = models["FP32"]
    vocab, units = gpu.n_vocab, gpu.n_embed
    rng = np.random.default_rng(RES_SEED)
    xs = [rng.integers(0, vocab, RES_LEN).tolist() for _ in range(RES_SEQS)]
    ys = np.array([[x[-1] / vocab] for x in xs], np.float32)

    # activations: one pass a sequence against a token-by-token eval loop
    res = ReservoirRWKV(gpu, units=units)
    res.run(xs[0])  # warm-up
    acts, one_pass = host_seconds(lambda: res.run(xs[1]))

    def token_loop():
        st, rows = gpu.init_state(), []
        for t in xs[1]:
            _, st = gpu.eval(t, st, compute_logits=False)
            rows.append(st["ffn_xx"][0, :units].cpu().numpy())
        return np.stack(rows)

    rows, loop = host_seconds(token_loop)
    err = host_rel(acts, rows)
    if err > PARITY_DENSE_REL:
        raise AssertionError(f"reservoir: one pass vs token by token {err:.3e}")
    print(f"reservoir activations, 169M FP32 on {card}: {one_pass * 1e3 / RES_LEN:.3f} ms a "
          f"token in one {RES_LEN}-token pass, {loop * 1e3 / RES_LEN:.3f} ms a token in a "
          f"token-by-token eval loop ({loop / one_pass:.1f}x); the two {err:.3e} apart")

    for fmt, limit in (("FP32", PARITY_DENSE_REL), ("Q5_1", PARITY_QUANT_REL)):
        runs = {}
        for where, m in zip(("card", "cpu"), models[fmt]):
            r = ReservoirRWKV(m, units=units)
            seen = recorded(r)
            _, fit_s = host_seconds(lambda: r.fit(xs, ys, warmup=RES_WARMUP))
            runs[where] = (seen[:RES_SEQS], fit_s, r.predict(xs[0]),
                           r.score(xs, ys, warmup=RES_WARMUP))
        act = max(host_rel(a, b) for a, b in zip(runs["card"][0], runs["cpu"][0]))
        pred = host_rel(runs["card"][2], runs["cpu"][2])
        print(f"reservoir ridge 169M {fmt} on {card}: activations card vs CPU {act:.3e} of the "
              f"scale (limit {limit}), predictions {pred:.3e} (limit {RES_RIDGE_REL[fmt]}); "
              f"R^2 {runs['card'][3]:.6f} card, {runs['cpu'][3]:.6f} CPU; fit "
              f"{runs['card'][1]:.3f} s on the card, {runs['cpu'][1]:.3f} s on the CPU "
              f"({RES_SEQS} x {RES_LEN} tokens, warmup {RES_WARMUP}, {units} units)")
        if act > limit or pred > RES_RIDGE_REL[fmt] or not np.isfinite(runs["card"][3]):
            raise AssertionError(f"reservoir ridge {fmt}: card vs CPU out of its limits")

    # The MLP: the CPU's readout fits on the CPU's activations, and the
    # card's, from the same start, on those same activations (the card's
    # own are held above), so that `shared` measures the card's training
    # arithmetic alone; `e2e` runs the card's activations through the
    # card's MLP. 200 Adam epochs can take float32 sum-order differences
    # far apart, so the tight check is the first step's (`mlp_first_step`).
    e_cpu = EnhancedReservoirRWKV(cpu, readout_type="mlp")
    e_card = EnhancedReservoirRWKV(gpu, readout_type="mlp")
    start = {k: v.clone() for k, v in e_cpu.custom_readout.state_dict().items()}
    e_card.custom_readout.load_state_dict(start)
    seen, cpu_mlp, card_mlp = {}, e_cpu.custom_readout, e_card.custom_readout
    cpu_fit, cpu_predict, card_fit = cpu_mlp.fit, cpu_mlp.predict, card_mlp.fit

    def recording_fit(x, y):
        seen["fit"] = (x, y)
        out, seen["cpu_s"] = host_seconds(lambda: cpu_fit(x, y))
        return out

    def recording_predict(x):
        seen["predict"] = x
        return cpu_predict(x)

    def shared_fit(x, y):  # the card's own activations are left unused
        out, seen["card_s"] = host_seconds(lambda: card_fit(*seen["fit"]))
        return out

    cpu_mlp.fit, cpu_mlp.predict, card_mlp.fit = recording_fit, recording_predict, shared_fit
    fit_s = {}
    for where, e in (("cpu", e_cpu), ("card", e_card)):
        _, fit_s[where] = host_seconds(lambda: e.fit(xs[:RES_READOUT_SEQS],
                                                     ys[:RES_READOUT_SEQS], warmup=RES_WARMUP))
    ref = e_cpu.predict(xs[0])
    shared = host_rel(card_mlp.predict(seen["predict"]), ref)
    e2e = host_rel(e_card.predict(xs[0]), ref)
    # The first step on a tanh MLP of the same shapes from the same start:
    # a relu gate whose input float32 sums leave near zero may open on one
    # device and not the other, which moves the gradients by far more than
    # the arithmetic does (task seed 23, PERF.md section 6).
    grad, step = mlp_first_step(
        start, lambda dev: MultiLayerReadout(units, hidden_layers=cpu_mlp.hidden_layers,
                                             activation="tanh", device=dev),
        *seen["fit"], cpu.device, gpu.device)
    print(f"enhanced reservoir, mlp readout, 169M FP32 on {card}: card vs CPU on the CPU's "
          f"activations from one start: a tanh MLP's first gradients {grad:.3e} of the scale "
          f"(limit {RES_READOUT_REL['mlp grad']}), first Adam step {step:.3e} of the rate (limit "
          f"{RES_READOUT_REL['mlp step']}), predictions after 200 epochs {shared:.3e} (limit "
          f"{RES_READOUT_REL['mlp']}); end to end on the card's activations {e2e:.3e} (limit "
          f"{RES_READOUT_REL['mlp e2e']}); fit {fit_s['card']:.3f} s on the card, "
          f"{fit_s['cpu']:.3f} s on the CPU, of it the MLP's 200 epochs {seen['card_s']:.3f} s "
          f"on the card, {seen['cpu_s']:.3f} s on the CPU")
    if (grad > RES_READOUT_REL["mlp grad"] or step > RES_READOUT_REL["mlp step"]
            or shared > RES_READOUT_REL["mlp"] or e2e > RES_READOUT_REL["mlp e2e"]):
        raise AssertionError(f"reservoir mlp: card vs CPU gradients {grad:.3e}, step "
                             f"{step:.3e}, 200 epochs {shared:.3e}, end to end {e2e:.3e}")

    for name, readout, rc in (("online sgd", "online", {"method": "sgd"}),
                              ("online rls", "online", {"method": "rls"}),
                              ("hierarchical", "hierarchical", {})):
        outs, secs = {}, {}
        for where, m in (("cpu", cpu), ("card", gpu)):
            e = EnhancedReservoirRWKV(m, readout_type=readout, readout_config=rc)
            _, secs[where] = host_seconds(lambda: e.fit(xs[:RES_READOUT_SEQS],
                                                        ys[:RES_READOUT_SEQS], warmup=RES_WARMUP))
            outs[where] = e.predict(xs[0])
        if isinstance(outs["cpu"], dict):
            if sorted(outs["card"]) != sorted(outs["cpu"]):
                raise AssertionError(f"reservoir {name}: readouts {sorted(outs['card'])}")
            err = max(host_rel(outs["card"][k], outs["cpu"][k]) for k in outs["cpu"])
        else:
            err = host_rel(outs["card"], outs["cpu"])
        print(f"enhanced reservoir, {name} readout, 169M FP32 on {card}: predictions card vs "
              f"CPU {err:.3e} of the scale (limit {RES_READOUT_REL[name]}); fit "
              f"{secs['card']:.3f} s on the card, {secs['cpu']:.3f} s on the CPU")
        if err > RES_READOUT_REL[name]:
            raise AssertionError(f"reservoir {name}: card vs CPU {err:.3e}")

    decode, encode = get_tokenizer("auto", vocab)
    chats = {}
    for where, m in (("card", gpu), ("cpu", cpu)):
        bot = ESNChatbot(m, esn_create_config("creative"), seed=0)
        reply, chat_s = host_seconds(
            lambda: bot.respond("Hello, who are you?", encode, decode, RES_CHAT_TOKENS))
        chats[where] = (bot.conversation.history_tokens, reply, chat_s)
    if chats["card"][0] != chats["cpu"][0]:
        raise AssertionError(f"ESNChatbot: the card's tokens {chats['card'][0]} differ from "
                             f"the CPU's {chats['cpu'][0]}")
    n_out = len(chats["card"][0]) - len(encode("Hello, who are you?"))
    print(f"ESNChatbot.respond, 169M FP32, creative, seed 0, on {card}: {n_out} tokens equal "
          f"to the CPU's, {chats['card'][2]:.2f} s on the card ({chats['cpu'][2]:.2f} s on "
          f"the CPU); reply {chats['card'][1][:40]!r}")

    # The process's first profiler sessions: on the H100 machine (torch
    # 2.11) a one-step session begun a minute or more after the first one
    # records no device activity (PERF.md section 7).
    trace_dir = os.path.join(tmp, "traces")
    model.decode(token, state)  # warm-up
    with trace(trace_dir) as tr:
        with annotate("k3_decode_step"):
            model.decode(token, state)
    trace_check(tr, "one K3 decode step (169M w8a8)", card, kernel="v7_decode_kernel")
    with trace(trace_dir) as tr:
        with annotate("reservoir_run"):
            res.run(xs[2])
    trace_check(tr, "one reservoir run (169M FP32, 64 tokens)", card)
    timer, st, tok = StepTimer(), state, token
    for _ in range(64):
        timer.start()
        lg, st = model.decode(tok, st)
        timer.stop(lg)
        tok = lg[0].argmax().reshape(1)
    dev = device_ms(lambda: model.decode(token, state), reps=50)
    print(f"StepTimer over 64 K3 decode steps (169M w8a8) on {card}: {timer.summary()}; "
          f"device_ms of one step {dev:.4f} ms")

    _, build_s = host_seconds(lambda: native.build(force=True))
    src = os.path.join(tmp, "v7-169m-FP32.bin")
    for fmt in ("Q5_1", "Q8_0"):
        py_path = os.path.join(tmp, f"v7-169m-{fmt}.bin")
        if fmt not in py_seconds:
            _, py_seconds[fmt] = host_seconds(
                lambda: quantize_model_file(src, py_path, fmt, verbose=False))
        nat_path = os.path.join(tmp, f"v7-169m-{fmt}-native.bin")
        _, nat_s = host_seconds(
            lambda: native.quantize_model_file(src, nat_path, int(dtype_from_name(fmt))))
        with open(py_path, "rb") as a, open(nat_path, "rb") as b:
            same = a.read() == b.read()
        if not same:
            raise AssertionError(f"native {fmt} file differs from the Python quantizer's")
        print(f"native quantizer, 169M FP32 -> {fmt} on this card's host ({card}): "
              f"{nat_s:.2f} s on {os.cpu_count()} threads, the Python quantizer "
              f"{py_seconds[fmt]:.2f} s ({py_seconds[fmt] / nat_s:.1f}x), files byte-equal "
              f"({os.path.getsize(nat_path) / 1e6:.1f} MB)")
        os.unlink(nat_path)
    print(f"native library built in {build_s:.1f} s; reservoir, profiling and native "
          f"phase: {time.perf_counter() - t_phase:.1f} s")


# The card's ServingModel(path, "quant") against the CPU's on small files:
# their dense leaves (the head, v7's LoRAs) are bf16, so a last-bit
# difference upstream can flip the bf16 rounding of an input element (the
# port against JAX on the CPU reads up to 6e-4 of the scale, test_torch_quant_serve.py).
QUANT_SMALL_REL = 5e-3


def small_file(tmp: str, version: str, fmt: str) -> tuple:
    """The small synth model of `version` (L=2, C=256, V=256, seed 3) as a
    ggmf file in `fmt` in `tmp` (FP32 / FP16 written, the rest quantized
    from FP32 by the port): (cfg, path)."""
    import os

    from rwkv_tpu_torch.io.quantize import quantize_model_file
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

    cfg = synth_config(version, 2, 256, 256, 64)
    path = os.path.join(tmp, f"{fmt}.bin")
    if fmt in ("FP32", "FP16"):
        write_synth_ggmf(cfg, synth_params(cfg, seed=3), path, fmt)
    else:
        src = os.path.join(tmp, "f32.bin")
        write_synth_ggmf(cfg, synth_params(cfg, seed=3), src)
        quantize_model_file(src, path, fmt, verbose=False)
    return cfg, path


def small_file_check(dev, version: str, fmt: str) -> float:
    """ServingModel(path, precision="quant") on the card against the CPU on
    a small file (L=2, C=256, V=256) in `fmt`: prefill 20 tokens and 4
    decode steps, logits and state within QUANT_SMALL_REL of their scale,
    equal argmax. Returns the worst reading."""
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel

    with tempfile.TemporaryDirectory(prefix="rwkv_smoke_") as tmp:
        cfg, path = small_file(tmp, version, fmt)
        gpu = ServingModel(path, precision="quant", device=dev)
        cpu = ServingModel(path, precision="quant", device="cpu")
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
        for a, b in [(lg, lc)] + [(sg[k], sc[k]) for k in sc]:
            e = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            worst = max(worst, e)
            if e > QUANT_SMALL_REL or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"v{version} {fmt} file step {step}: card vs CPU {e:.3e} of "
                                     f"the scale, limit {QUANT_SMALL_REL}")
        if int(lg.argmax()) != int(lc.argmax()):
            raise AssertionError(f"v{version} {fmt} file step {step}: argmax differs")
    print(f"small file (v{version} {fmt}, L=2, C=256, V=256): card vs CPU worst {worst:.3e} of "
          f"the scale (limit {QUANT_SMALL_REL}), argmax equal")
    return worst


def small_parity_check(dev, version: str, fmt: str) -> float:
    """RWKVModel (the parity engine) on the card against the CPU on a small
    file (L=2, C=256, V=256) in `fmt`: 20 tokens in chunks of 8, then 4
    greedy steps (``parity_run``), a dense file within PARITY_DENSE_REL, a
    quantized one within PARITY_SMALL_QUANT_REL. Returns the worst reading."""
    from rwkv_tpu_torch.models.model import RWKVModel

    with tempfile.TemporaryDirectory(prefix="rwkv_smoke_") as tmp:
        cfg, path = small_file(tmp, version, fmt)
        gpu, cpu = RWKVModel(path, device=dev), RWKVModel(path, device="cpu")
    band = PARITY_DENSE_REL if fmt in ("FP32", "FP16") else PARITY_SMALL_QUANT_REL
    toks = np.random.default_rng(4).integers(0, cfg.n_vocab, 20).tolist()
    r = parity_run(gpu, cpu, toks, 8, 4, band, f"v{version} {fmt} (L=2, C=256)")
    print(f"small parity file (v{version} {fmt}, L=2, C=256, V=256): {parity_line(r)}, limit "
          f"{band}; prompt argmax equal, greedy picks equal at {r['agree']} of 4 steps")
    return r["rel"]


def batcher_requests(model, cfg, n: int, max_len: int, new_tokens: int, seed: int):
    """n seeded requests: prompts of 8 to max_len tokens; a quarter with
    half the new tokens; even ones greedy, odd ones temperature 1 / top_p
    0.8; two with presence/frequency penalties 0.4/0.25; two with stop
    tokens -- one the fifth token of its own greedy stream, so it stops."""
    import torch

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.n_vocab, int(rng.integers(8, max_len + 1))).tolist()
        kw = dict(max_new_tokens=new_tokens // 2 if i % 4 == 3 else new_tokens)
        if i % 2:
            kw.update(temperature=1.0, top_p=0.8)
        else:
            kw.update(temperature=0.0)
        if i in (1, 2):
            kw.update(presence_penalty=0.4, frequency_penalty=0.25)
        if i == 5:
            kw["stop_tokens"] = tuple(int(t) for t in rng.integers(0, cfg.n_vocab, 8))
        if i == 4:
            logits, state = model.prefill(prompt)
            for _ in range(5):
                tok = logits.argmax().reshape(1)
                lg, state = model.decode(tok, state)
                logits = lg[0]
            kw["stop_tokens"] = (int(tok),)
        reqs.append((prompt, kw))
    torch.cuda.synchronize()
    return reqs


def batcher_path(name, model, cfg, reqs, needed=("K1", "K2", "K4")):
    """ContinuousBatcher(max_batch=8, sync_every=8).run(on_device=True)
    over `reqs`, which must launch every kernel in `needed`; checks every
    request finished within its limits with tokens in range. Returns
    (launches, tok/s, ms per round)."""
    import torch

    from rwkv_tpu_torch.parallel.batching import ContinuousBatcher

    def run():
        b = ContinuousBatcher(model, max_batch=8, sync_every=8)
        rids = [b.submit(p, **kw) for p, kw in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = b.run(on_device=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [res[r] for r in rids], b.rounds

    (wall, done, rounds), launches = counted(run, needed)
    n_tok, stopped = 0, 0
    for (prompt, kw), req in zip(reqs, done):
        g = req.generated
        if not req.done or not 1 <= len(g) <= kw["max_new_tokens"]:
            raise AssertionError(f"{name}: request {req.request_id} ended with {len(g)} tokens")
        if len(g) < kw["max_new_tokens"]:
            if g[-1] not in kw.get("stop_tokens", ()):
                raise AssertionError(f"{name}: request {req.request_id} stopped early")
            stopped += 1
        if min(g) < 0 or max(g) >= cfg.n_vocab:
            raise AssertionError(f"{name}: token out of range")
        n_tok += len(g)
    print(f"{name} batcher launches: {launches}")
    print(f"{name} batcher: {len(reqs)} requests, {n_tok} tokens generated in {wall * 1e3:.1f} ms "
          f"({n_tok / wall:.0f} tok/s over the wall clock, prefill included), {rounds} rounds "
          f"({wall * 1e3 / rounds:.2f} ms per round of 8 steps), {stopped} stopped on a stop token")
    return launches, n_tok / wall, wall * 1e3 / rounds


def small_batcher_check(dev):
    """On a small model on the card, the batcher's device loop gives
    exactly the token streams of its host loop (greedy, penalties)."""
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.parallel.batching import ContinuousBatcher

    cfg = synth_config("7.0", 2, 128, 256, 32)
    srv = ServingModel((cfg, synth_params(cfg, seed=3, lora_dim=32)), precision="w8a8",
                       megakernel=True, device=dev)
    prompts = [[3, 77, 200, 5, 9], [9, 4], list(range(1, 40)), [250, 1, 1]]
    kw = dict(max_new_tokens=12, temperature=0.0, presence_penalty=0.4, frequency_penalty=0.25)
    outs = []
    for on_device in (True, False):
        b = ContinuousBatcher(srv, max_batch=2, sync_every=4)
        rids = [b.submit(p, **kw) for p in prompts]
        res = b.run(on_device=on_device)
        outs.append([res[r].generated for r in rids])
    if outs[0] != outs[1]:
        raise AssertionError(f"small model: batcher device loop {outs[0]} != host loop {outs[1]}")
    print(f"small model (L=2, C=128): batcher device loop equals host loop, {len(prompts)} "
          f"greedy requests with penalties")


# -- speculative decoding: the v7 169M target, a 4-layer C=256 draft ---------

# scripts/bench_speculative.py's pair: the 169M target (seed 0) and
# synth_config("7.0", 4, 256, 65536, 64) (seed 1) as the draft, prompt
# range(16), 128 tokens, k = 4
SPEC_DRAFT = ("7.0", 4, 256, 65536, 64)
SPEC_PROMPT = list(range(16))
SPEC_TOKENS, SPEC_K = 128, 4


def host_seconds(fn):
    """(fn(), host seconds around it, ending in a synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_speculative(name: str, target, cfg, card, needed_host=(), needed_device=(),
                      sample: bool = True) -> dict:
    """Greedy speculative decoding with `target` (per-op paths; its decode
    kernel only where the target is its own draft in the host loop): the
    target's plain greedy, the host loop with the weak draft, and the
    device loop with the weak draft, with force_accept and with the target
    as a perfect draft, each timed once (ms a generated token, host clock)
    and counted. The weak and perfect streams must equal the plain greedy
    stream, the perfect draft accept everything, and the host / device
    loops launch `needed_host` / `needed_device`. With `sample`, the
    sampling loop at temperature 0.9 must give tokens in range and
    coherent stats. Returns the launches of each run."""
    from rwkv_tpu_torch.models import speculative as S
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    dcfg = synth_config(*SPEC_DRAFT)
    draft = ServingModel((dcfg, synth_params(dcfg, seed=1)), precision=target.precision)
    # warm-up: each loop once on a few tokens
    S.speculative_generate(target, draft, SPEC_PROMPT, 6, k=SPEC_K)
    S.speculative_generate_device(target, draft, SPEC_PROMPT, 6, k=SPEC_K)
    (want, _, _), t_plain = host_seconds(
        lambda: target.generate(SPEC_PROMPT, SPEC_TOKENS, temperature=0.0))
    want = want.tolist()
    print(f"speculative {name}: plain greedy {1e3 * t_plain / SPEC_TOKENS:.3f} ms/token "
          f"({SPEC_TOKENS / t_plain:.1f} tok/s) on {card}")
    runs = {
        "host loop, weak draft": (S.speculative_generate, draft, {}, needed_host),
        "device loop, weak draft": (S.speculative_generate_device, draft, {}, needed_device),
        "device loop, force_accept": (S.speculative_generate_device, draft,
                                      {"force_accept": True}, needed_device),
        "device loop, perfect draft": (S.speculative_generate_device, target, {}, needed_device),
    }
    launches = {}
    for run, (fn, d, kw, needed) in runs.items():
        ((toks, stats), t), launches[run] = counted(
            lambda: host_seconds(lambda: fn(target, d, SPEC_PROMPT, SPEC_TOKENS, k=SPEC_K, **kw)),
            needed)
        used = {k: n for k, n in launches[run].items() if n}
        print(f"speculative {name} {run}: {1e3 * t / SPEC_TOKENS:.3f} ms/token "
              f"({SPEC_TOKENS / t:.1f} tok/s, {t_plain / t:.2f}x plain greedy), acceptance "
              f"{stats['acceptance_rate']:.3f}, rounds {stats['rounds']}, launches {used}")
        if len(toks) != SPEC_TOKENS or not all(0 <= x < cfg.n_vocab for x in toks.tolist()):
            raise AssertionError(f"speculative {name} {run}: tokens out of range")
        if "force_accept" not in kw and toks.tolist() != want:
            raise AssertionError(f"speculative {name} {run}: not the target's greedy stream")
        if d is target and stats["acceptance_rate"] != 1.0:
            raise AssertionError(f"speculative {name} {run}: perfect draft accepted {stats}")
    if not sample:
        return launches
    (toks, stats), t = host_seconds(lambda: S.speculative_sample_generate_device(
        target, draft, SPEC_PROMPT, SPEC_TOKENS, k=SPEC_K, temperature=0.9, seed=0))
    print(f"speculative {name} sampling at 0.9, seed 0: {1e3 * t / SPEC_TOKENS:.3f} ms/token, "
          f"acceptance {stats['acceptance_rate']:.3f}, rounds {stats['rounds']}")
    if (len(toks) != SPEC_TOKENS or not all(0 <= x < cfg.n_vocab for x in toks.tolist())
            or stats["drafted"] != SPEC_K * stats["rounds"] or stats["rounds"] < 1
            or not 0 <= stats["accepted"] <= stats["drafted"]):
        raise AssertionError(f"speculative {name} sampling: {toks.tolist()[:8]} {stats}")
    return launches


def pack_cache_round_trip(model, cfg, params) -> None:
    """ServingModel(mega_pack_cache=...) on the 169M w8a8 pack in a
    temporary directory: the first model builds and writes the pack, the
    second reads it; the second's K3 logits over two tokens equal those of
    `model` (a freshly built pack) bit for bit."""
    import tempfile

    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.ops import megakernel as M

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "v7_169m_w8a8.npz")
        _, t_build = host_seconds(lambda: ServingModel(
            (cfg, params), precision="w8a8", megakernel=True, mega_pack_cache=path))
        size = Path(path).stat().st_size
        cached, t_load = host_seconds(lambda: ServingModel(
            (cfg, params), precision="w8a8", megakernel=True, mega_pack_cache=path))
    before = M.v7_decode_step.launches
    sa, sb = model.init_state(1), cached.init_state(1)
    for tok in (3, 77):
        la, sa = model.decode([tok], sa)
        lb, sb = cached.decode([tok], sb)
        if not torch.equal(la, lb):
            raise AssertionError("pack cache: K3 logits differ from the freshly built pack")
    if M.v7_decode_step.launches != before + 4:
        raise AssertionError("pack cache: the decode steps did not run K3")
    print(f"pack cache 169M w8a8: model with the pack built and written {t_build:.1f} s "
          f"({size / 2**20:.1f} MiB), read back {t_load:.1f} s; K3 logits bit-equal over 2 tokens")


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
    from rwkv_tpu_torch.tools.card import (
        card_line, seeded_states, v4_models, width_models, V4_WIDTH, V5_WIDTH,
        V6_WIDTH,
    )

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params

    t0 = time.perf_counter()
    paths = _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          + " ".join(f"{k}={v:.1f}s" for k, v in _cuda.build_seconds.items()))
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"  {name}: {line.strip()}")

    print(f"[{time.perf_counter() - t_start:.1f} s] the 169M model in both formats")
    # -- the 169M model in both formats: prefill for a real decode state -----
    cfg = synth_config("7.0", 12, 768, 65536, 64)
    t0 = time.perf_counter()
    params = synth_params(cfg, seed=0)
    model = ServingModel((cfg, params), precision="w8a8", megakernel=True)
    model4 = ServingModel((cfg, params), precision="w4a8", megakernel=True)
    d_lora, f_dim = model._mega["d_lora"], model._mega["f_dim"]
    print(f"169M models (w8a8, w4a8) built in {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.n_vocab, (256,),
                           generator=torch.Generator().manual_seed(0)).numpy()
    logits, state = model.prefill(prompt)  # warm-up of every path
    token = logits.argmax().reshape(1).to(torch.int32)

    print(f"[{time.perf_counter() - t_start:.1f} s] kernels against their plain versions")
    # -- kernels against their plain versions ---------------------------------
    res = {}
    res["K1"] = phase_k1(cfg, d_lora, f_dim, 256, dev)
    res["K2"] = phase_k2(256, cfg.head_count, cfg.head_size, dev)
    res["K5"] = phase_k5(256, 32, 64, dev)
    k9 = phase_k9(cfg, d_lora, f_dim, dev)
    res.update({f"K9 {form}": r for form, r in k9.items()})
    res["K3"] = phase_k3(model, state, token, cfg)
    logits4, state4 = model4.prefill(prompt)
    res["K3w4"] = phase_k3(model4, state4, logits4.argmax().reshape(1), cfg, "K3 w4a8")
    grid_invariance("K3", {"w8a8": model, "w4a8": model4}, cfg, "169M")
    states, tokens = seeded_states(model, cfg, 64, 32, seed=1)
    for b in (1, 8, 64):
        res[f"K4 B={b}"] = phase_k4(model._mega, cfg, states, tokens, b, f"K4 w8a8 B={b}")
    res["K4"] = res["K4 B=8"]
    res["K4w4"] = phase_k4(model4._mega, cfg, states, tokens, 8, "K4 w4a8 B=8")
    for b in (1, 64):
        res[f"K4w4 B={b}"] = phase_k4(model4._mega, cfg, states, tokens, b, f"K4 w4a8 B={b}")
    # a ragged batch: the last n-tile of the tensor-core matvec holds one sequence
    for m, prec in ((model, "w8a8"), (model4, "w4a8")):
        phase_k4(m._mega, cfg, states, tokens, 17, f"K4 {prec} B=17")
    k4_identical_lanes(model._mega, cfg, states, tokens)
    # the bf16 pack of the same tree: K3 and K4 in their bf16 form
    t0 = time.perf_counter()
    model16 = ServingModel((cfg, params), precision="bf16", megakernel=True)
    print(f"169M bf16 model built in {time.perf_counter() - t0:.1f} s")
    res["K3bf16"] = phase_b1("K3", {"bf16": model16}, cfg)["bf16"]
    grid_invariance("K3", {"bf16": model16}, cfg, "169M")
    for b in (1, 8, 64):
        res[f"K4bf16 B={b}"] = phase_k4(model16._mega, cfg, states, tokens, b,
                                        f"K4 bf16 B={b}", show_f32_bound=b == 64)
    res["K4bf16"] = res["K4bf16 B=8"]
    k4_identical_lanes(model16._mega, cfg, states, tokens)
    phase_k4_shallow({"w8a8": model._mega, "w4a8": model4._mega, "bf16": model16._mega},
                     states, tokens)
    crossover(model, states, tokens)
    phase_k4_wide()
    res.update(phase_k4_large(model, model4, model16, cfg))
    del states
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] the main paths")
    # -- the main paths: B=1 in both formats, then the batcher ---------------
    launches = {}
    launches["w8a8"] = single_stream_path("w8a8", model, prompt, cfg, card, 5)
    prefill_vs_plain("v7 169M w8a8", model, prompt)
    launches["w4a8"] = single_stream_path("w4a8", model4, prompt, cfg, card, 3)
    warm = batcher_requests(model, cfg, 2, 16, 8, seed=3)
    batcher_path("warm-up", model, cfg, warm)
    reqs = batcher_requests(model, cfg, 16, 256, 64, seed=2)
    launches["batcher w8a8"], _, _ = batcher_path("w8a8", model, cfg, reqs)
    # decode-bound: eight 8-token prompts fill the slots in one admission
    short = batcher_requests(model, cfg, 8, 8, 64, seed=5)
    batcher_path("w8a8 8-token prompts", model, cfg, short)
    reqs4 = batcher_requests(model4, cfg, 8, 64, 32, seed=4)
    launches["batcher w4a8"], _, _ = batcher_path("w4a8", model4, cfg, reqs4)
    # bf16 and f32 on the bf16 pack: B=1 (K3), then the batcher (K4)
    launches["bf16"] = single_stream_path("bf16", model16, prompt, cfg, card, 3,
                                          needed=("K2", "K3 bf16"))
    model32 = ServingModel((cfg, params), precision="f32", megakernel=True)
    launches["f32"] = single_stream_path("f32", model32, prompt, cfg, card, 1,
                                         needed=("K2", "K3 bf16"))
    prefill_vs_plain("v7 169M f32", model32, prompt)
    del model32
    reqs16 = batcher_requests(model16, cfg, 8, 64, 32, seed=4)
    launches["batcher bf16"], _, _ = batcher_path("bf16", model16, cfg, reqs16,
                                                  needed=("K2", "K4 bf16"))

    print(f"[{time.perf_counter() - t_start:.1f} s] speculative decoding")
    # -- speculative decoding: w8a8 (K1, K2) and bf16 (the fused dense path)
    phase_speculative("w8a8", model, cfg, card, needed_host=("K1", "K2"),
                      needed_device=("K1", "K2"))
    phase_speculative("bf16", model16, cfg, card, needed_host=("K2",), needed_device=("K2",),
                      sample=False)
    pack_cache_round_trip(model, cfg, params)
    del model16
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] the model files")
    # -- the model files: Q5_1, Q4_0, Q4_1 (and Q5_1 on K3), then q8 and q8r;
    # then the parity engine and the tools on the same files
    with tempfile.TemporaryDirectory(prefix="rwkv_smoke_") as tmp:
        file_launches, quant_seconds = phase_files(cfg, params, prompt, card, tmp)
        launches.update(file_launches)
        print(f"[{time.perf_counter() - t_start:.1f} s] the parity engine and the tools")
        parity_launches, parity_models = phase_parity(cfg, params, card, tmp)
        launches.update(parity_launches)
        print(f"[{time.perf_counter() - t_start:.1f} s] the reservoir layer, profiling and "
              f"the native library")
        phase_reservoir(parity_models, model, state, token, card, tmp, quant_seconds)
        del parity_models
        torch.cuda.empty_cache()

    small_model_check(dev)
    small_model_check(dev, "7.0", "bf16")
    small_batcher_check(dev)
    del model, model4, params
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] RWKV-6 at the 1.6B width")
    # -- RWKV-6 at the 1.6B width: K6, then the B=1 main path in both formats -
    t0 = time.perf_counter()
    cfg6, models6, params6 = width_models(V6_WIDTH, with_params=True)
    print(f"RWKV-6 1.6B-width models (w8a8, w4a8, bf16; {cfg6.n_layer} layers, "
          f"C={cfg6.n_embed}) built in {time.perf_counter() - t0:.1f} s")
    k6 = phase_b1("K6", models6, cfg6)
    grid_invariance("K6", models6, cfg6, "1.6B")
    res["K6"], res["K6w4"], res["K6bf16"] = k6["w8a8"], k6["w4a8"], k6["bf16"]
    prompt6 = torch.randint(0, cfg6.n_vocab, (256,),
                            generator=torch.Generator().manual_seed(0)).numpy()
    for prec, m in models6.items():
        launches[f"v6 {prec}"] = single_stream_path(
            f"v6 {prec}", m, prompt6, cfg6, card, 1 if prec == "bf16" else 2,
            needed=B1_NEEDED[prec] + ("K5", f"K6 {m._mega['form']}"))
    model6f = ServingModel((cfg6, params6), precision="f32")
    prefill_vs_plain("v6 1.6B f32", model6f, prompt6)
    del model6f
    print(f"[{time.perf_counter() - t_start:.1f} s] tensor-parallel v6")
    # tensor-parallel v6 on a tp=2 one-card mesh: K12 / K13 (w8a8 held to
    # the w8a8 model above; w4a8 and bf16 at TP_CUT_DEPTH layers)
    tp_errs = {6: phase_tp_kernels("K12 / K13", cfg6, params6)}
    tp_runs = {6: tp_paths("v6", cfg6, params6, prompt6, card, launches, models6["w8a8"])}
    del models6, params6
    torch.cuda.empty_cache()
    for precision in ("w8a8", "bf16"):
        small_model_check(dev, "6.0", precision)

    print(f"[{time.perf_counter() - t_start:.1f} s] tensor-parallel v7 at the World 1.5B width")
    # -- tensor-parallel v7 at the World 1.5B width, tp=2 on one card: K10 / K11
    t0 = time.perf_counter()
    cfg7 = synth_config(*V7_TP_WIDTH)
    params7 = synth_params(cfg7, seed=0, lora_dim=V7_TP_LORA)
    print(f"RWKV-7 World 1.5B-width tree ({cfg7.n_layer} layers, C={cfg7.n_embed}) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    tp_errs[7] = phase_tp_kernels("K10 / K11", cfg7, params7)
    tp_runs[7] = tp_paths("v7", cfg7, params7, prompt6, card, launches)
    del params7
    torch.cuda.empty_cache()

    print(f"[{time.perf_counter() - t_start:.1f} s] RWKV-5 (v5.2) at the World 1.5B width")
    # -- RWKV-5 (v5.2) at the World 1.5B width: K7, then the B=1 main path ---
    t0 = time.perf_counter()
    cfg5, models5, params5 = width_models(V5_WIDTH, with_params=True)
    print(f"RWKV-5.2 World 1.5B-width models (w8a8, w4a8, bf16; {cfg5.n_layer} layers, "
          f"C={cfg5.n_embed}) built in {time.perf_counter() - t0:.1f} s")
    k7 = phase_b1("K7", models5, cfg5)
    grid_invariance("K7", models5, cfg5, "World 1.5B")
    res["K7"], res["K7w4"], res["K7bf16"] = k7["w8a8"], k7["w4a8"], k7["bf16"]
    for prec, m in models5.items():
        launches[f"v5 {prec}"] = single_stream_path(
            f"v5.2 {prec}", m, prompt6, cfg5, card, 1 if prec == "bf16" else 2,
            needed=B1_NEEDED[prec] + ("K5", f"K7 {m._mega['form']}"))
    print(f"[{time.perf_counter() - t_start:.1f} s] tensor-parallel v5.2")
    # tensor-parallel v5.2 on a tp=2 one-card mesh: K15 / K13 mix45 (w8a8
    # held to the w8a8 model above, w4a8 and bf16 at TP_CUT_DEPTH layers),
    # then K15's v5.1 form on a 2-layer v5.1 tree at the same width
    tp_errs[5] = phase_tp_kernels("K15 / K13 mix45 v5.2", cfg5, params5)
    tp_runs[5] = tp_paths("v5.2", cfg5, params5, prompt6, card, launches, models5["w8a8"])
    del models5, params5
    torch.cuda.empty_cache()
    cfg51 = synth_config("5.1", 2, *V5_WIDTH[2:])
    phase_tp_kernels("K15 / K13 mix45 v5.1", cfg51, synth_params(cfg51, seed=0))
    phase_cut_width("K7", ("5.1", 2) + V5_WIDTH[2:])
    for version in ("5.2", "5.1"):
        for precision in ("w8a8", "bf16"):
            small_model_check(dev, version, precision)

    print(f"[{time.perf_counter() - t_start:.1f} s] RWKV-4 at the World 0.1B width")
    # -- RWKV-4 at the World 0.1B width: K8, then the B=1 main path ----------
    cfg4, models4 = v4_models()
    k8 = phase_b1("K8", models4, cfg4)
    grid_invariance("K8", models4, cfg4, "World 0.1B")
    res["K8"], res["K8w4"], res["K8bf16"] = k8["w8a8"], k8["w4a8"], k8["bf16"]
    for prec, m in models4.items():
        launches[f"v4 {prec}"] = single_stream_path(
            f"v4 {prec}", m, prompt6, cfg4, card, 3,
            needed=B1_NEEDED[prec] + (f"K8 {m._mega['form']}",))
    del models4
    torch.cuda.empty_cache()
    phase_cut_width("K8", ("4.0", 2, 2048) + V4_WIDTH[3:])
    print(f"[{time.perf_counter() - t_start:.1f} s] tensor-parallel v4 at the World 1.5B width")
    # tensor-parallel v4 at the World 1.5B width, tp=2 on one card: K14 /
    # K13 mix45 (w8a8 held to K8 on the same tree without a mesh)
    t0 = time.perf_counter()
    cfg4t = synth_config(*V4_TP_WIDTH)
    params4t = synth_params(cfg4t, seed=0)
    print(f"RWKV-4 World 1.5B-width tree ({cfg4t.n_layer} layers, C={cfg4t.n_embed}) drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    tp_errs[4] = phase_tp_kernels("K14 / K13 mix45", cfg4t, params4t)
    tp_runs[4] = tp_paths("v4", cfg4t, params4t, prompt6, card, launches)
    del params4t
    torch.cuda.empty_cache()
    for precision in ("w8a8", "bf16"):
        small_model_check(dev, "4.0", precision)
    for version in ("7.0", "6.0", "5.2", "5.1", "4.0"):
        for fmt in ("Q5_1", "Q4_0"):
            small_file_check(dev, version, fmt)
        for fmt in ("FP16", "Q4_1", "Q5_0", "Q8_0", "Q5_K"):
            small_parity_check(dev, version, fmt)

    print(f"[{time.perf_counter() - t_start:.1f} s] the kernels line")
    # name, source, TPU kernel replaced, result key, path whose launches count
    meta = [
        ("quant_matmul_w8a8", "rwkv_tpu_torch/csrc/quant_matmul.cu",
         "rwkv_tpu/ops/kernels.py:296", "K1", ("w8a8", "K1")),
        ("wkv7_recurrence", "rwkv_tpu_torch/csrc/wkv7.cu",
         "rwkv_tpu/ops/chunked.py:388", "K2", ("w8a8", "K2")),
        ("v7_decode_step_w8a8_head", "rwkv_tpu_torch/csrc/v7_decode.cu",
         "rwkv_tpu/ops/megakernel.py:744", "K3", ("w8a8", "K3")),
        ("v7_decode_step_w4a8_head", "rwkv_tpu_torch/csrc/v7_decode.cu",
         "rwkv_tpu/ops/megakernel.py:744", "K3w4", ("w4a8", "K3")),
        ("v7_decode_batched_w8a8", "rwkv_tpu_torch/csrc/v7_decode_batched.cu",
         "rwkv_tpu/ops/megakernel.py:1115", "K4", ("batcher w8a8", "K4")),
        ("v7_decode_batched_w4a8", "rwkv_tpu_torch/csrc/v7_decode_batched.cu",
         "rwkv_tpu/ops/megakernel.py:2211", "K4w4", ("batcher w4a8", "K4")),
        ("wkv6_recurrence", "rwkv_tpu_torch/csrc/wkv6.cu",
         "rwkv_tpu/ops/chunked.py:796", "K5", ("v6 w8a8", "K5")),
        ("v6_decode_step_w8a8", "rwkv_tpu_torch/csrc/v6_decode.cu",
         "rwkv_tpu/ops/megakernel.py:2841", "K6", ("v6 w8a8", "K6")),
        ("v6_decode_step_w4a8", "rwkv_tpu_torch/csrc/v6_decode.cu",
         "rwkv_tpu/ops/megakernel.py:3366", "K6w4", ("v6 w4a8", "K6")),
        ("v5_decode_step_w8a8", "rwkv_tpu_torch/csrc/v5_decode.cu",
         "rwkv_tpu/ops/megakernel.py:3847", "K7", ("v5 w8a8", "K7")),
        ("v5_decode_step_w4a8", "rwkv_tpu_torch/csrc/v5_decode.cu",
         "rwkv_tpu/ops/megakernel.py:5160", "K7w4", ("v5 w4a8", "K7")),
        ("v4_decode_step_w8a8", "rwkv_tpu_torch/csrc/v4_decode.cu",
         "rwkv_tpu/ops/megakernel.py:4224", "K8", ("v4 w8a8", "K8")),
        ("v4_decode_step_w4a8", "rwkv_tpu_torch/csrc/v4_decode.cu",
         "rwkv_tpu/ops/megakernel.py:4660", "K8w4", ("v4 w4a8", "K8")),
        ("v7_decode_step_bf16_head", "rwkv_tpu_torch/csrc/v7_decode.cu",
         "rwkv_tpu/ops/megakernel.py:744", "K3bf16", ("bf16", "K3 bf16")),
        ("v7_decode_batched_bf16", "rwkv_tpu_torch/csrc/v7_decode_batched.cu",
         "rwkv_tpu/ops/megakernel.py:1433", "K4bf16", ("batcher bf16", "K4 bf16")),
        ("v6_decode_step_bf16", "rwkv_tpu_torch/csrc/v6_decode.cu",
         "rwkv_tpu/ops/megakernel.py:2841", "K6bf16", ("v6 bf16", "K6 bf16")),
        ("v5_decode_step_bf16", "rwkv_tpu_torch/csrc/v5_decode.cu",
         "rwkv_tpu/ops/megakernel.py:3847", "K7bf16", ("v5 bf16", "K7 bf16")),
        ("v4_decode_step_bf16", "rwkv_tpu_torch/csrc/v4_decode.cu",
         "rwkv_tpu/ops/megakernel.py:4224", "K8bf16", ("v4 bf16", "K8 bf16")),
        ("block_matmul_plain", "rwkv_tpu_torch/csrc/block_matmul.cu",
         "rwkv_tpu/ops/kernels.py:251", "K9 plain", ("q8", "K9 plain")),
        ("block_matmul_min", "rwkv_tpu_torch/csrc/block_matmul.cu",
         "rwkv_tpu/ops/kernels.py:278", "K9 min", ("quant Q5_1", "K9 min")),
        ("block_matmul_pack4", "rwkv_tpu_torch/csrc/block_matmul.cu",
         "rwkv_tpu/ops/kernels.py:282", "K9 pack4", ("quant Q4_0", "K9 pack4")),
        ("block_matmul_pack4_min", "rwkv_tpu_torch/csrc/block_matmul.cu",
         "rwkv_tpu/ops/kernels.py:282", "K9 pack4_min", ("quant Q4_1", "K9 pack4_min")),
        ("block_matmul_rowwise", "rwkv_tpu_torch/csrc/block_matmul.cu",
         "rwkv_tpu/ops/kernels.py:266", "K9 rowwise", ("q8r", "K9 rowwise")),
    ]
    # the TP kernels: each version's attention and FFN kernel in every form,
    # its launches on that form's TP main path (K13's MIX45 form: v5.2's;
    # v4's runs it at the same shapes)
    tp_src = "rwkv_tpu_torch/csrc/"
    tp_meta = {7: (("tp_v7_att", tp_src + "tp_v7.cu", 413),
                   ("tp_v7_ffn", tp_src + "tp_v6.cu", 487)),
               6: (("tp_v6_att", tp_src + "tp_v6.cu", 935),
                   ("tp_v6_ffn", tp_src + "tp_v6.cu", 1007)),
               5: (("tp_v5_att", tp_src + "tp_v6.cu", 1644),
                   ("tp_v45_ffn", tp_src + "tp_v6.cu", 1007)),
               4: (("tp_v4_att", tp_src + "tp_v45.cu", 1324), None)}
    for version, rows in tp_meta.items():
        for prec, form in (("w8a8", "i8"), ("w4a8", "i4"), ("bf16", "bf16")):
            run_launches, times = tp_runs[version][prec]
            for row, kind, kernel in zip(rows, ("att", "ffn"), TP_KERNELS[version]):
                if row is None:
                    continue
                stem, source, line = row
                key = f"tp v{version} {kind} {prec}"
                res[key] = {**times[kind], "max_abs_err": tp_errs[version][prec]}
                launches[key] = {kernel: run_launches[f"{kernel} {form}"]}
                meta.append((f"{stem}_{prec}", source, f"rwkv_tpu/ops/megakernel_tp.py:{line}",
                             key, (key, kernel)))
    kernels = []
    for name, source, replaces, key, (path, counter) in meta:
        r = res[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_counterpart": replaces, "launches": launches[path][counter],
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
