#!/usr/bin/env python3
"""Where the port's parity engine leaves the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/probe_torch_parity_flips.py [--tokens 10]
        [--versions 7.0,6.0,5.2,5.1,4.0] [--formats Q4_0,Q4_1,Q5_0,Q5_1,Q8_0,Q4_K,Q5_K]
        [--seeds 3]

For each synth model (L=2, C=256, V=256, S=64, seeds from --seeds; the
size of ``tests/test_torch_model_api.py``) written as an FP32 ggmf
file and quantized by the port, runs the same tokens through JAX's
``RWKVModel.eval_sequence`` (jitted) and the port's ``RWKVModel(path,
device="cpu")``, recording the activations that reach every quantized
product on both sides. For every product in call order it quantizes both
activations with the port's ggml rules (q8_0 / q8_1 per 32, q8_K per 256)
and prints the first product whose int8 codes or rounded scales differ:
how many codes flipped, and how far the JAX side's scaled value ``x * inv`` lay from a
.5 boundary for each flipped code (a flip from last-bit noise lies within
a few ulp of .5), and how many fp16-rounded block scales ``fp16(amax /
127)`` differ (a last-bit change that crosses an fp16 rounding midpoint
moves the scale one fp16 step, ~5e-4 of it), and how many of q8_1's
``fp16(amax / 127 * sum(codes))`` (which also moves with a flipped code). Also prints the
activations' largest difference at that product and the last logits'
distance over their scale, and at the end the worst distance of each
version over the seeds and formats.

A CPU tool that imports both packages, like the tests; the port itself
imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

from rwkv_tpu.models.model import RWKVModel as JaxModel  # noqa: E402
from rwkv_tpu.ops import parity as JP  # noqa: E402
from rwkv_tpu_torch.io.quantize import quantize_model_file  # noqa: E402
from rwkv_tpu_torch.models.model import RWKVModel  # noqa: E402
from rwkv_tpu_torch.models.synth import synth_config, synth_params  # noqa: E402
from rwkv_tpu_torch.ops import parity as TP  # noqa: E402
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf  # noqa: E402


def kind(w) -> str:
    return "q8_K" if w.q8_k_act else "q8_1" if w.q8_1_act else "q8_0"


def quantized(x: np.ndarray, act: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x * inv, fp16(amax / 127), q8_1's fp16(amax / 127 * sum(codes))) of
    rows x [M, in] under the port's ggml rules: the value each int8 code
    rounds and the fp16-rounded scales per 32 (q8_K keeps its scales in
    float32, so none there; only q8_1 has the second)."""
    xt = torch.from_numpy(np.array(x, np.float32))
    m, n = xt.shape
    none = np.zeros((m, 0), np.float32)
    if act == "q8_K":
        xk = xt.reshape(m, n // 256, 256)
        mag = xk.abs()
        smax = torch.gather(xk, -1, mag.argmax(-1, keepdim=True))[..., 0]
        iscale = torch.where(mag.amax(-1) == 0, torch.zeros_like(smax),
                             TP._const(-127.0, smax) / smax)
        return (xk * iscale[..., None]).reshape(m, n).numpy(), none, none
    xb = xt.reshape(m, n // 32, 32)
    amax = xb.abs().amax(-1)
    inv = torch.where(amax != 0, TP._const(127.0, amax) / amax, torch.zeros_like(amax))
    scaled = xb * inv[..., None]
    d16 = TP._fp16_round(amax / TP._const(127.0, amax)).numpy()
    if act != "q8_1":
        return scaled.reshape(m, n).numpy(), d16, none
    s16 = TP._fp16_round(amax / TP._const(127.0, amax) * torch.round(scaled).sum(-1)).numpy()
    return scaled.reshape(m, n).numpy(), d16, s16


def record_jax(path: str, tokens) -> tuple[list, np.ndarray]:
    seen = []
    orig = JP._quant_matmul

    def hooked(x, w):
        jax.debug.callback(lambda a, k=kind(w): seen.append((np.asarray(a), k)), x,
                           ordered=True)
        return orig(x, w)

    JP._quant_matmul = hooked
    try:
        logits, _ = JaxModel(path).eval_sequence(tokens)
        logits = np.asarray(logits)
        jax.effects_barrier()
    finally:
        JP._quant_matmul = orig
    return seen, logits


def record_port(path: str, tokens) -> tuple[list, np.ndarray]:
    seen = []
    orig = TP._quant_matmul

    def hooked(x, w):
        seen.append((x.detach().numpy().copy(), kind(w)))
        return orig(x, w)

    TP._quant_matmul = hooked
    try:
        logits, _ = RWKVModel(path, device="cpu").eval_sequence(tokens)
    finally:
        TP._quant_matmul = orig
    return seen, logits.numpy()


def probe(path: str, tokens) -> tuple[float, str, str]:
    """(the last logits' distance over their scale, what flipped first:
    "code", "scale" or "none", the report)."""
    jseen, jl = record_jax(path, tokens)
    tseen, tl = record_port(path, tokens)
    rel = float(np.abs(tl - jl).max() / np.abs(jl).max())
    head = (f"logits {rel:.3e} of the scale, argmax "
            f"{'equal' if tl.argmax() == jl.argmax() else 'DIFFERS'}; {len(tseen)} products")
    if len(jseen) != len(tseen):
        return rel, "none", head + f"; JAX recorded {len(jseen)} products"
    for i, ((jx, k), (tx, _)) in enumerate(zip(jseen, tseen)):
        jx = jx.reshape(-1, jx.shape[-1])
        tx = tx.reshape(-1, tx.shape[-1])
        (js, jd, jsx), (ts, td, tsx) = quantized(jx, k), quantized(tx, k)
        codes = np.round(js) != np.round(ts)
        scales, sums = jd != td, jsx != tsx
        if not (codes.any() or scales.any() or sums.any()):
            continue
        dx = float(np.abs(jx - tx).max() / np.abs(jx).max())
        msg = (f"; first flip at product {i} ({k}, x differs by {dx:.2e} of its scale): "
               f"{int(codes.sum())} of {codes.size} codes")
        if codes.any():
            dist = np.abs(np.abs(js[codes] - np.trunc(js[codes])) - 0.5)
            msg += f" (JAX's x*inv within {dist.max():.2e} of .5)"
        msg += f", {int(scales.sum())} of {scales.size} fp16 scales"
        if scales.any():
            ulp = np.spacing(np.abs(jd[scales]).astype(np.float16)).astype(np.float32)
            msg += f" ({np.abs(jd[scales] - td[scales]).max() / ulp.max():.0f} fp16 step apart)"
        if sums.size:
            msg += f", {int(sums.sum())} of {sums.size} fp16 code sums (q8_1)"
        return rel, "code" if codes.any() else "scale", head + msg
    return rel, "none", head + "; no flips"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=10)
    ap.add_argument("--versions", default="7.0,6.0,5.2,5.1,4.0")
    ap.add_argument("--formats", default="Q4_0,Q4_1,Q5_0,Q5_1,Q8_0,Q4_K,Q5_K")
    ap.add_argument("--seeds", default="3", help="synth seeds, comma-separated")
    args = ap.parse_args()
    tokens = np.random.default_rng(1).integers(0, 256, args.tokens)
    worst, first, no_flip = {}, {"code": 0, "scale": 0, "none": 0}, 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for seed in (int(s) for s in args.seeds.split(",")):
            for version in args.versions.split(","):
                cfg = synth_config(version, 2, 256, 256, 64)
                src = os.path.join(tmp, "f32.bin")
                write_synth_ggmf(cfg, synth_params(cfg, seed=seed), src)
                for fmt in args.formats.split(","):
                    path = os.path.join(tmp, f"{fmt}.bin")
                    quantize_model_file(src, path, fmt, verbose=False)
                    rel, what, msg = probe(path, tokens)
                    worst[version] = max(worst.get(version, 0.0), rel)
                    first[what] += 1
                    if what == "none":
                        no_flip = max(no_flip, rel)
                    print(f"seed {seed} v{version} {fmt}: {msg}", flush=True)
    print("worst logits distance by version: "
          + ", ".join(f"v{v} {e:.3e}" for v, e in worst.items()))
    print(f"first flip a code in {first['code']} cases, a scale in {first['scale']}, none in "
          f"{first['none']} (worst logits distance without a flip {no_flip:.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
