"""The prefill wkv kernels K2 (wkv7) and K5 (wkv6) on the card.

    python3 -m rwkv_tpu_torch.tools.probe_wkv [--baseline DIR] [--crossover] [--tf32] [--stamps]
    python3 -m rwkv_tpu_torch.tools.probe_wkv --drift [--baseline DIR]

Holds both kernels against the token recurrence (rtol 1e-4 / atol 1e-5)
and the two-pass plain form (rtol 3e-4 / atol 3e-5) at T in {3, 4, 16,
17, 64, 256} and BH in {12, 32, 96} (S = 64; K5 also on extreme decays),
printing each shape's launch plan (``wkv_chunk_plan``) and device time.

With ``--baseline DIR`` it also builds ``DIR/wkv7.cu`` and ``DIR/wkv6.cu``
(an earlier version of the kernels, headers beside them: the parent's
``rwkv_tpu_torch/csrc`` from ``git archive``, whose entries are the token
recurrence ``rwkv_wkv7_seq`` / ``rwkv_wkv6_seq``, or an edited copy of the
current sources) and times both on the same inputs in the order baseline,
current, current, baseline, printing their largest output difference.

With ``--crossover`` it times the launch's two routes at T = 4-128 and BH
in {12, 32, 96}: builds with ``-DRWKV_WKV_BELOW=0`` (always the two
passes) and ``-DRWKV_WKV_BELOW=1000000`` (always the token recurrence).

With ``--stamps`` it builds the kernels (or, with ``--baseline DIR``, those
in DIR) with ``-DRWKV_WKV_STAMPS`` and
prints the two passes' timeline at T = 64 and 256 (BH 12 and 32, S = 64,
the route forced to the two passes): from the kernel's entry, when pass A's
items end (the first chunk's, each round's), when the last block's pass B
found each chunk's operators in its ring and finished its step.

With ``--drift`` it measures how far a whole model's 256-token prefill
moves when K2 / K5 replace the plain token recurrence (the readings that
set ``chip_smoke.py``'s ``PREFILL_*_REL``): the v7 169M model and the v6
1.6B width, w8a8 and f32, at full depth, synth seed 0, 6 seeded
prompts; each prefill's logits and state against the same prefill on the
plain recurrence, the largest distance over its scale and whether the top
token agrees; with ``--baseline DIR`` the earlier kernels' too.

With ``--tf32`` it times pass A's two product shapes, [P, S] x [S, P]
(bmat, kmat, br, kr at once) and [P, P] x [P, S], as f32 FMAs over the
block's 256 threads (the kernels' way) and as ``mma.sync`` m16n8k8 TF32
with the three-term split (big big + big small + small big, a warp a
product), on 132 blocks that repeat the product, and prints each form's
largest error against float64 on the v7 operands' factors.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

TS = (3, 4, 16, 17, 64, 256)
BHS = (12, 32, 96)


def _ops(kind: int, t: int, bh: int, s: int, dev, extreme: bool = False):
    from rwkv_tpu_torch.tools.card import wkv6_operands, wkv7_operands

    if kind == 7:
        return wkv7_operands(t, bh, s, dev)
    return wkv6_operands(t, bh, s, dev, extreme=extreme)


def _current(kind: int, ops, lib=None, below=None):
    from rwkv_tpu_torch.ops.chunked import _wkv_launch

    s0, *rest = ops
    if kind == 7:
        return _wkv_launch(7, [x.contiguous() for x in rest], s0, lib=lib, below=below)
    return _wkv_launch(6, [x.contiguous() for x in rest[:4]], s0, rest[4].contiguous(), lib=lib,
                       below=below)


@contextlib.contextmanager
def wkv_swapped(wkv7=None, wkv6=None):
    """Within the block, ``ops.chunked.wkv7_recurrence`` / ``wkv6_recurrence``
    (what ``wkv7_auto`` / ``wkv6_auto`` call on CUDA tensors, hence every
    prefill) are `wkv7` / `wkv6` where given: the plain recurrence, or an
    earlier kernel (``baseline_kernels``)."""
    from rwkv_tpu_torch.ops import chunked as TC

    saved = TC.wkv7_recurrence, TC.wkv6_recurrence
    TC.wkv7_recurrence = wkv7 or saved[0]
    TC.wkv6_recurrence = wkv6 or saved[1]
    try:
        yield
    finally:
        TC.wkv7_recurrence, TC.wkv6_recurrence = saved


def baseline_kernels(src_dir: Path) -> tuple:
    """(wkv7, wkv6) launchers with ``wkv7_recurrence``'s / ``wkv6_recurrence``'s
    signatures of the kernels in `src_dir` (for ``wkv_swapped``)."""
    b7, b6 = _baseline_fn(7, src_dir / "wkv7.cu"), _baseline_fn(6, src_dir / "wkv6.cu")

    def wkv7(s0, *ops):
        return b7([s0.contiguous()] + [x.contiguous() for x in ops])

    def wkv6(s0, r, k, v, w, tf):
        return b6([s0.contiguous()] + [x.contiguous() for x in (r, k, v, w, tf)])

    return wkv7, wkv6


def _baseline_fn(kind: int, src: Path):
    """A launcher of the earlier kernel in `src` on (s0, ops...)."""
    import torch

    from rwkv_tpu_torch.ops import _cuda

    name = f"wkv{kind}"
    lib = _cuda.library(name, src)
    if hasattr(lib, f"rwkv_{name}_twopass"):
        return lambda ops: _current(kind, ops, lib=(src, ()))
    n_ptrs = 9 if kind == 7 else 8
    fn = _cuda.function(name, f"rwkv_{name}_seq", n_ptrs, 3, src)

    def run(ops):
        s0, *rest = ops
        y = torch.empty_like(rest[0])
        s_out = torch.empty_like(s0)
        ptrs = [x.data_ptr() for x in rest] + [s0.data_ptr(), y.data_ptr(), s_out.data_ptr()]
        t, bh, s = rest[0].shape
        _cuda.check(name, f"rwkv_{name}_seq", fn(*ptrs, t, bh, s, _cuda.stream_ptr(s0.device)))
        return y, s_out

    return run


def check_and_time(dev, baseline: Path | None) -> None:
    import torch

    from rwkv_tpu_torch.ops import chunked as TC
    from rwkv_tpu_torch.tools.card import device_ms

    for kind in (7, 6):
        base = None if baseline is None else _baseline_fn(kind, baseline / f"wkv{kind}.cu")
        plain = TC.wkv7_recurrence_plain if kind == 7 else TC.wkv6_recurrence_plain
        twopass = TC.wkv7_twopass if kind == 7 else TC.wkv6_twopass
        for bh in BHS:
            for t in TS:
                for extreme in ((False, True) if kind == 6 else (False,)):
                    ops = _ops(kind, t, bh, 64, dev, extreme)
                    y, s_new = _current(kind, ops)
                    y_ref, s_ref = plain(*ops)
                    y_tp, s_tp = twopass(*ops)
                    torch.cuda.synchronize()
                    err = max(float((y - y_ref).abs().max()), float((s_new - s_ref).abs().max()))
                    ok = (torch.allclose(y, y_ref, rtol=1e-4, atol=1e-5)
                          and torch.allclose(s_new, s_ref, rtol=1e-4, atol=1e-5)
                          and torch.allclose(y, y_tp, rtol=3e-4, atol=3e-5)
                          and torch.allclose(s_new, s_tp, rtol=3e-4, atol=3e-5))
                    plan = TC.wkv_chunk_plan(kind, t, bh, 64, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                    line = (f"K{2 if kind == 7 else 5} T={t} BH={bh}{' extreme' if extreme else ''}:"
                            f" max abs err {err:.3e} vs scan, within tolerances {ok}; plan "
                            f"{'recurrence' if plan.recurrent else 'two-pass'} rows {plan.rows} "
                            f"grid {plan.grid} stages {plan.stages} smem {plan.smem_bytes}")
                    if extreme:
                        print(line)
                        if not ok:
                            raise AssertionError(line)
                        continue
                    if base is None:
                        ms = device_ms(lambda: _current(kind, ops))
                        line += f"; {ms:.4f} ms"
                    else:
                        yb, sb = base(ops)
                        diff = max(float((y - yb).abs().max()), float((s_new - sb).abs().max()))
                        b1 = device_ms(lambda: base(ops))
                        c1 = device_ms(lambda: _current(kind, ops))
                        c2 = device_ms(lambda: _current(kind, ops))
                        b2 = device_ms(lambda: base(ops))
                        line += (f"; current {(c1 + c2) / 2:.4f} ms ({c1:.4f}, {c2:.4f}), "
                                 f"baseline {(b1 + b2) / 2:.4f} ms ({b1:.4f}, {b2:.4f}), ratio "
                                 f"{(c1 + c2) / (b1 + b2):.3f}; outputs differ by {diff:.3e}")
                    print(line, flush=True)
                    if not ok:
                        raise AssertionError(line)


def crossover(dev) -> None:
    import torch

    from rwkv_tpu_torch.tools.card import device_ms

    libs = {"two-pass": ((None, ("-DRWKV_WKV_BELOW=0",)), 0),
            "recurrence": ((None, ("-DRWKV_WKV_BELOW=1000000",)), 1000000)}
    for kind in (7, 6):
        for bh in BHS:
            for t in (4, 8, 16, 24, 32, 48, 64, 128):
                ops = _ops(kind, t, bh, 64, dev)
                times = {}
                outs = {}
                for name, (lib, below) in libs.items():
                    outs[name] = _current(kind, ops, lib=lib, below=below)
                    times[name] = device_ms(lambda: _current(kind, ops, lib=lib, below=below))
                torch.cuda.synchronize()
                diff = max(float((a - b).abs().max()) for a, b in zip(*outs.values()))
                print(f"K{2 if kind == 7 else 5} BH={bh} T={t}: two-pass {times['two-pass']:.4f} "
                      f"ms, recurrence {times['recurrence']:.4f} ms (outputs differ by "
                      f"{diff:.3e})", flush=True)


_TF32_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
extern "C" const char* rwkv_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
constexpr int P = 16, S = 64, SP = S + 4;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// C[16 x 8 tile n0] += A[16 x K] B^T, A(m, k) and B(k, n) by accessors, 3 terms
template <int K, class AF, class BF>
__device__ __forceinline__ void mma3(float* c, AF a, BF b, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[4], as[4], bb[2], bs[2];
    split(a(g, k0 + t), ab[0], as[0]);
    split(a(g + 8, k0 + t), ab[1], as[1]);
    split(a(g, k0 + t + 4), ab[2], as[2]);
    split(a(g + 8, k0 + t + 4), ab[3], as[3]);
    split(b(k0 + t, n0 + g), bb[0], bs[0]);
    split(b(k0 + t + 4, n0 + g), bb[1], bs[1]);
    mma(c, as, bb);
    mma(c, ab, bs);
    mma(c, ab, bb);
  }
}

// shape 0: four [P, S] x [S, P] products (bmat, kmat, br, kr); shape 1:
// four [P, P] x [P, S] products. form 0: f32 FMAs over 256 threads; form 1:
// TF32 three-term mma, a warp a (product, 8-column tile) pair. Each block
// repeats `reps` times (each round depends on the last); block 0's first
// round's products go to out ([4][P][P] or [4][P][S]).
extern "C" __global__ void __launch_bounds__(256) probe(const float* x, const float* y,
                                                        float* out, int shape, int form, int reps) {
  __shared__ __align__(16) float X[4][P * SP];
  __shared__ __align__(16) float Y[4][P * SP];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 4 * P * S; i += 256) {
    const int q = i / (P * S), r = i % (P * S), m = r / S, j = r % S;
    X[q][m * SP + j] = x[i];
    Y[q][m * SP + j] = y[i];
  }
  __syncthreads();
  float keep = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    const float z = keep * 0.f;  // a dependence on the last round
    const bool save = rep == 0 && blockIdx.x == 0;
    if (shape == 0 && form == 0) {
      const int m = tid >> 4, n = tid & 15;
      float acc[4] = {z, z, z, z};
      for (int j = 0; j < S; ++j)
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(X[q][m * SP + j], Y[q][n * SP + j], acc[q]);
      for (int q = 0; q < 4; ++q) {
        keep += acc[q];
        if (save) out[q * P * P + m * P + n] = acc[q];
      }
    } else if (shape == 0) {
      const int q = warp >> 1, n0 = (warp & 1) * 8;
      float c[4] = {z, z, z, z};
      mma3<S>(c, [&](int m, int k) { return X[q][m * SP + k]; },
              [&](int k, int n) { return Y[q][n * SP + k]; }, n0);
      keep += c[0] + c[1] + c[2] + c[3];
      if (save) {
        float* o = out + q * P * P;
        o[g * P + n0 + 2 * t] = c[0];
        o[g * P + n0 + 2 * t + 1] = c[1];
        o[(g + 8) * P + n0 + 2 * t] = c[2];
        o[(g + 8) * P + n0 + 2 * t + 1] = c[3];
      }
    } else if (form == 0) {
      for (int i = tid; i < 4 * P * S; i += 256) {
        const int q = i / (P * S), r = i % (P * S), m = r & 15, n = r >> 4;
        float acc = z;
        for (int k = 0; k < P; ++k) acc = fmaf(X[q][m * SP + k], Y[q][k * SP + n], acc);
        keep += acc;
        if (save) out[q * P * S + m * S + n] = acc;
      }
    } else {
      for (int tile = warp; tile < 4 * S / 8; tile += 8) {
        const int q = tile / (S / 8), n0 = (tile % (S / 8)) * 8;
        float c[4] = {z, z, z, z};
        mma3<P>(c, [&](int m, int k) { return X[q][m * SP + k]; },
                [&](int k, int n) { return Y[q][k * SP + n]; }, n0);
        keep += c[0] + c[1] + c[2] + c[3];
        if (save) {
          float* o = out + q * P * S;
          o[g * S + n0 + 2 * t] = c[0];
          o[g * S + n0 + 2 * t + 1] = c[1];
          o[(g + 8) * S + n0 + 2 * t] = c[2];
          o[(g + 8) * S + n0 + 2 * t + 1] = c[3];
        }
      }
    }
  }
  if (keep == 12345.f) out[0] = keep;  // keeps the rounds
}

extern "C" int rwkv_probe_tf32(const void* x, const void* y, void* out, int shape, int form,
                               int reps, int blocks, void* stream) {
  probe<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out), shape,
      form, reps);
  return static_cast<int>(cudaGetLastError());
}
"""


def tf32(dev) -> None:
    import ctypes

    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.chunked import _pad_chunks
    from rwkv_tpu_torch.tools.card import wkv7_operands

    src = _cuda.BUILD_DIR / "probe_tf32" / "probe_tf32.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_TF32_SRC)
    lib = _cuda.library("probe_tf32", src)
    fn = lib.rwkv_probe_tf32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # chunk 0's factors of head 0 of the 169M operands: atil, rhat (x) against btil,
    # ktil (y) for shape 0; for shape 1 the strictly lower atil btil^T (x, the
    # first P columns) against atil, v, btil, ktil (y)
    s0, r, w, k, v, a, b = wkv7_operands(16, 12, 64, dev)
    lw = _pad_chunks(torch.log(torch.clamp(w, min=1e-30)), 16, 0.0)[0, 0]
    lc = torch.cumsum(lw, 0)
    f = [x[:, 0] for x in (a, b, k, r, v)]
    atil, btil, ktil, rhat = f[0] * torch.exp(lc - lw), f[1] * torch.exp(-lc), \
        f[2] * torch.exp(-lc), f[3] * torch.exp(lc)
    x0 = torch.stack([atil, atil, rhat, rhat]).contiguous()
    y0 = torch.stack([btil, ktil, btil, ktil]).contiguous()
    pp = torch.tril(atil @ btil.T, -1)
    pmat = torch.zeros(16, 64, device=dev)
    pmat[:, :16] = pp
    x1 = torch.stack([pmat] * 4).contiguous()
    y1 = torch.stack([atil, v[:, 0], btil, ktil]).contiguous()
    out = torch.empty(4 * 16 * 64, device=dev)
    for shape, (x, y) in enumerate(((x0, y0), (x1, y1))):
        if shape == 0:
            ref = torch.einsum("qmj,qnj->qmn", x.double(), y.double())
        else:
            ref = torch.einsum("mk,qkn->qmn", pp.double(), y.double())
        for form, name in ((0, "f32 FMA"), (1, "TF32 3-term mma.sync")):
            def launch(reps=200, blocks=132):
                _cuda.check("probe_tf32", "rwkv_probe_tf32",
                            fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), shape, form, reps,
                               blocks, _cuda.stream_ptr(dev)))
            launch(1, 1)
            torch.cuda.synchronize()
            got = out[: 4 * 256].view(4, 16, 16) if shape == 0 else out.view(4, 16, 64)
            err = float((got.double() - ref).abs().max() / ref.abs().max())
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            launch()
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            us = start.elapsed_time(end) * 1e3 / 200
            print(f"{'[P,S]x[S,P] x4' if shape == 0 else '[P,P]x[P,S] x4'} {name}: "
                  f"{us:.3f} us a round (132 blocks), max err / max |ref| {err:.3e}", flush=True)


def stamps(dev, src_dir=None) -> None:
    import ctypes

    import torch

    from rwkv_tpu_torch.ops import _cuda
    from rwkv_tpu_torch.ops.chunked import wkv_chunk_plan

    flags = ("-DRWKV_WKV_STAMPS", "-DRWKV_WKV_BELOW=0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in (7, 6):
        src = None if src_dir is None else src_dir / f"wkv{kind}.cu"
        lib = _cuda.library(f"wkv{kind}", src, flags)
        fn = lib.rwkv_wkv_stamps
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        for bh in (12, 32):
            for t in (64, 256):
                ops = _ops(kind, t, bh, 64, dev)
                for _ in range(3):
                    _current(kind, ops, lib=(src, flags), below=0)
                torch.cuda.synchronize()
                out = (ctypes.c_ulonglong * 801)()
                _cuda.check(f"wkv{kind}", "rwkv_wkv_stamps", fn(out))
                st = [float(x - out[0]) / 1e3 for x in out]
                plan = wkv_chunk_plan(kind, t, bh, 64, sms, below=0)
                items = plan.n_chunks * bh
                a_end = st[1: 1 + min(items, 512)]
                nc = min(plan.n_chunks, 64)
                print(f"K{2 if kind == 7 else 5} T={t} BH={bh} (grid {plan.grid}, {items} pass-A "
                      f"items, {bh * plan.groups} pass-B): us from entry: chunk 0's items end "
                      f"{max(a_end[:bh]):.2f}, all items {max(a_end):.2f} (first {min(a_end):.2f}); "
                      f"last block's chunks ready "
                      f"{[round(x, 2) for x in st[600:600 + nc]]}, done "
                      f"{[round(x, 2) for x in st[700:700 + nc]]}, end {st[800]:.2f}", flush=True)


def prefill_distance(out, ref) -> float:
    """The largest distance over its scale of a prefill's logits and state
    tensors from a reference prefill's."""
    (logits, state), (ref_logits, ref_state) = out, ref
    pairs = [(logits, ref_logits)] + [(state[k], ref_state[k]) for k in ref_state]
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in pairs)


def drift(dev, baseline: Path | None, n_prompts: int = 6) -> None:
    import torch

    from rwkv_tpu_torch.models.serve import ServingModel
    from rwkv_tpu_torch.models.synth import synth_config, synth_params
    from rwkv_tpu_torch.ops import chunked as TC
    from rwkv_tpu_torch.tools.card import V6_WIDTH

    swaps = {"plain": (TC.wkv7_recurrence_plain, TC.wkv6_recurrence_plain)}
    if baseline is not None:
        swaps["baseline"] = baseline_kernels(baseline)
    for name, width, precisions in (("v7 169M", ("7.0", 12, 768, 65536, 64), ("w8a8", "f32")),
                                    ("v6 1.6B", V6_WIDTH, ("w8a8", "f32"))):
        cfg = synth_config(*width)
        params = synth_params(cfg, seed=0)
        for prec in precisions:
            model = ServingModel((cfg, params), precision=prec, megakernel=prec != "f32")
            for seed in range(n_prompts):
                prompt = torch.randint(0, cfg.n_vocab, (256,),
                                       generator=torch.Generator().manual_seed(seed)).numpy()
                outs = {"current": model.prefill(prompt)}
                for k, (w7, w6) in swaps.items():
                    with wkv_swapped(w7, w6):
                        outs[k] = model.prefill(prompt)
                torch.cuda.synchronize()
                ref = outs.pop("plain")
                print(f"{name} {prec} prompt {seed}: " + ", ".join(
                    f"{k} {prefill_distance(o, ref):.3e} of the scale from the plain recurrence, "
                    f"same top token {int(o[0].argmax()) == int(ref[0].argmax())}"
                    for k, o in outs.items()), flush=True)
            del model
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    from rwkv_tpu_torch.tools.card import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--drift", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    if args.drift:
        drift(dev, args.baseline)
    elif args.stamps:
        stamps(dev, args.baseline)
    elif args.tf32:
        tf32(dev)
    elif args.crossover:
        crossover(dev)
    else:
        check_and_time(dev, args.baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
