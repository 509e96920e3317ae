"""Kernels K1-K15 of the PyTorch/CUDA port on the card (K3, K4, K6-K8 also
in their bf16 form, K10-K15 in all three), against their plain PyTorch
versions, the batcher's decode loop, the v7, v6, v5 and v4 serving paths
(int8, int4 and bf16 packs; single-device and tensor-parallel), the
serving path from quantized ggmf files, ``score`` / ``score_trace``, both
greedy speculative loops and the pack cache on the card. Every
test here needs a CUDA device and nvcc and skips
without one. The file imports no JAX, so it runs on a GPU machine without
it, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.io import quant as TQ
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import chunked as TC
from rwkv_tpu_torch.ops import kernels as TK
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops.parity import Weight
from rwkv_tpu_torch.parallel.batching import ContinuousBatcher
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

pytestmark = pytest.mark.cuda

SMALL = ("7.0", 2, 128, 256, 32)  # version, L, C, V, S (H = 4)
SMALL6 = ("6.0", 2, 256, 256, 64)  # v6: H = 4, d_maa 32, d_dec 64, F = 1024
V45 = ("5.2", "5.1", "4.0")  # at L=2, C=256, V=256 (v5: H=4, S=64), F = 1024


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided when the test
    runs, so every machine collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (M, K, N) for K1: the GEMV route (M <= 8: the head, M = 1 and 8), the
# tensor-core route at M = 9, 33, 256, 300 with its split-K shapes (768 ->
# 64, 3072 -> 768), the 1.5B widths, K tails (K = 16, 48: not a whole
# 32-byte mma step), ragged N, and M = 8 with codes past the GEMV's shared
# memory (the tensor-core route): the last GEMV shapes at M = 8 and 7 (M x K
# codes beside the GEMV's static bytes, K1_GEMV_STATIC_SMEM) and the first
# ones past them
K1_SHAPES = [(1, 768, 65536), (256, 768, 3072), (256, 64, 768), (7, 3072, 768), (20, 32, 200),
             (8, 768, 768), (1, 16, 200), (9, 768, 64), (33, 48, 200), (300, 16, 195),
             (256, 768, 64), (256, 768, 768), (256, 3072, 768), (33, 3072, 195), (300, 768, 768),
             (256, 2048, 2048), (256, 2048, 8192), (256, 8192, 2048), (8, 8192, 2048),
             (8, 32768, 64), (8, 28912, 64), (7, 33056, 64), (8, 28928, 64), (8, 29056, 64)]


def test_quant_matmul_kernel_matches_plain(cuda_device):
    """K1 on every route and edge (K1_SHAPES): bit-equal to its plain
    version, and two launches bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for m, k, n in K1_SHAPES:
        w = TK.PackedQuantWeight(
            q=torch.randint(-127, 128, (n, k), dtype=torch.int8, device=cuda_device, generator=gen),
            d=torch.rand((n,), device=cuda_device, generator=gen) * 1e-2)
        x = torch.randn((m, k), device=cuda_device, generator=gen)
        before = TK.quant_matmul.launches
        y = TK.quant_matmul(x, w)
        y2 = TK.quant_matmul(x, w)
        assert TK.quant_matmul.launches == before + 2
        assert torch.equal(y, TK.quant_matmul_plain(x, w)), (m, k, n, TK.matmul_plan("w8a8", m, k, n))
        assert torch.equal(y, y2), (m, k, n)


def test_kernels_static_shared_memory_matches_their_plans(cuda_device):
    """The plans count the kernels' static shared memory (K1's GEMV beside
    its M x K codes, K4's int forms beside the plan's dynamic bytes): the
    kernels' own must be what the planners assume."""
    from rwkv_tpu_torch.ops import _cuda

    fn = _cuda.library("quant_matmul").rwkv_w8a8_gemv_static_smem
    fn.restype = ctypes.c_int
    assert fn() == TK.K1_GEMV_STATIC_SMEM
    fn = _cuda.library("v7_decode_batched").rwkv_v7_decode_batched_static_smem
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert fn(0) == fn(1) == fn(2) == TM.K4_STATIC_SMEM


def test_quant_matmul_kernel_rejects_unaligned_k(cuda_device):
    w = TK.PackedQuantWeight(q=torch.zeros((8, 24), dtype=torch.int8, device=cuda_device),
                             d=torch.ones((8,), device=cuda_device))
    with pytest.raises(ValueError):
        TK.quant_matmul(torch.ones((2, 24), device=cuda_device), w)


def _wkv7_operands(t, bh, s, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    r, k, v = (rnd(t, bh, s, scale=0.3) for _ in range(3))
    w = torch.exp(torch.sigmoid(rnd(t, bh, s)) * -0.606531)
    kk = rnd(t, bh, s)
    kk = kk / kk.norm(dim=-1, keepdim=True)
    gate = torch.sigmoid(rnd(t, bh, s))
    return rnd(bh, s, s, scale=0.3), r, w, k, v, -kk, kk * gate


# K2 / K5 shapes: the prefill buckets (3 and 17 ragged, below and past a
# chunk), the heads of the v7 169M (12) and of a batched B=8 prefill (96) at
# S=64, and the other head sizes (40 heads of 128: pass B's 32-row groups)
WKV_TS = (3, 4, 16, 17, 64, 256)
WKV_HEADS = ((12, 64), (96, 64), (2, 128), (8, 32), (40, 128))


@pytest.mark.parametrize("bh,s", WKV_HEADS)
@pytest.mark.parametrize("t", WKV_TS)
def test_wkv7_kernel_matches_scan(cuda_device, t, bh, s):
    """K2 within rtol 1e-4 / atol 1e-5 of the token recurrence and 3e-4 /
    3e-5 of its plain two-pass form; two launches bit-identical."""
    ops = _wkv7_operands(t, bh, s, cuda_device, seed=t + s)
    before = TC.wkv7_recurrence.launches
    y, s_new = TC.wkv7_recurrence(*ops)
    y2, s2 = TC.wkv7_recurrence(*ops)
    assert TC.wkv7_recurrence.launches == before + 2
    y_ref, s_ref = TC.wkv7_recurrence_plain(*ops)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_new, s_ref, rtol=1e-4, atol=1e-5)
    y_tp, s_tp = TC.wkv7_twopass(*ops)
    torch.testing.assert_close(y, y_tp, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(s_new, s_tp, rtol=3e-4, atol=3e-5)
    assert torch.equal(y, y2) and torch.equal(s_new, s2)


@pytest.mark.parametrize("kind", [6, 7])
@pytest.mark.parametrize("route,below", [("two-pass", 0), ("recurrence", 1 << 20)])
def test_wkv_kernels_on_either_route(cuda_device, kind, route, below):
    """K2 / K5 built with their route forced (-DRWKV_WKV_BELOW: the two
    passes even for T < P, a single padded chunk; the recurrence at T=256)
    within rtol 1e-4 / atol 1e-5 of the token recurrence at every head
    shape."""
    lib = (None, (f"-DRWKV_WKV_BELOW={below}",))
    for t in (3, 17, 256):
        for bh, s in WKV_HEADS:
            if kind == 7:
                s0, *ops = _wkv7_operands(t, bh, s, cuda_device, seed=t)
                y, s_new = TC._wkv_launch(7, ops, s0, lib=lib, below=below)
                y_ref, s_ref = TC.wkv7_recurrence_plain(s0, *ops)
            else:
                s0, *ops, tf = _wkv6_operands(t, bh, s, cuda_device, seed=t, extreme=True)
                y, s_new = TC._wkv_launch(6, ops, s0, tf, lib=lib, below=below)
                y_ref, s_ref = TC.wkv6_recurrence_plain(s0, *ops, tf)
            torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5, msg=f"{route} {t} {bh} {s}")
            torch.testing.assert_close(s_new, s_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", [6, 7])
def test_wkv_kernel_plans_match_wkv_chunk_plan(cuda_device, kind):
    """K2's and K5's own plans (the C entry rwkv_wkv_chunk_plan) equal
    ops/chunked.py::wkv_chunk_plan on this card, both routes."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for t in WKV_TS + (1, 31, 32, 1000):
        for bh in (1, 12, 32, 96, 300):
            for s in (32, 64, 128):
                assert TC.wkv_kernel_plan(kind, t, bh, s, sms) == TC.wkv_chunk_plan(
                    kind, t, bh, s, sms), (t, bh, s)


def _small_pack(dev, w4=False, seed=7):
    tc = synth_config(*SMALL)
    tp = synth_params(tc, seed=seed, lora_dim=32)
    pack = TM.build_mega_pack(tp, tc, w4=w4)
    return tc, TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], dev)


@pytest.mark.parametrize("w4", [False, True])
def test_decode_kernel_matches_ref(cuda_device, w4):
    tc, dp = _small_pack(cuda_device, w4)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    L, h, s, c = tc.n_layer, tc.head_count, tc.head_size, tc.n_embed
    state = {"att_xx": torch.randn((L, c), device=cuda_device, generator=gen),
             "ffn_xx": torch.randn((L, c), device=cuda_device, generator=gen),
             "heads": torch.randn((L, h, s, s), device=cuda_device, generator=gen) * 0.1}
    tok = torch.tensor([5], device=cuda_device)
    before = TM.v7_decode_step.launches
    logits, new = TM.v7_decode_step(dp, state, tok, tc)
    assert TM.v7_decode_step.launches == before + 1
    ref_logits, ref_new = TM.v7_decode_step_ref(dp, state, tok, tc)
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        torch.testing.assert_close(new[k], ref_new[k], rtol=2e-2, atol=2e-2)


def _v7_pack(dev, form: str, c: int = 128, vocab: int = 256, seed: int = 7):
    """A seeded 2-layer v7 pack in weight form `form` at width c (S = 32 at
    c = 128, else 64; lora 32) with `vocab` head rows, and a seeded state."""
    s = 32 if c == 128 else 64
    tc = synth_config("7.0", 2, c, vocab, s)
    tp = synth_params(tc, seed=seed, lora_dim=32)
    pack = TM.build_mega_pack(tp, tc, w4=form == "i4", quant=form != "bf16")
    dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {"att_xx": torch.randn((2, c), device=dev, generator=gen),
             "ffn_xx": torch.randn((2, c), device=dev, generator=gen),
             "heads": torch.randn((2, c // s, s, s), device=dev, generator=gen) * 0.1}
    return tc, dp, state


@pytest.mark.parametrize("form", TM.FORMS)
def test_v7_decode_kernel_same_bits_on_every_grid(cuda_device, form):
    """K3's stream plan deals each phase's rows over the grid, but never
    changes how a row is computed: logits and state are bit-equal on grids
    of 132, 66, 33 and 7 blocks (pack["_grid"]), in every weight form, at
    C=128 (H=4, 2 heads a block on 1-3 blocks of the smaller grids) and
    C=768 (H=12) with 258 head rows (two past the last whole 4-row group,
    on the last block); there also within 2e-2 of the plain version."""
    for c, vocab in ((128, 256), (768, 258)):
        tc, dp, state = _v7_pack(cuda_device, form, c, vocab)
        tok = torch.tensor([9], device=cuda_device)
        outs = {}
        for grid in (132, 66, 33, 7):
            dp["_grid"] = grid
            logits, new = TM.v7_decode_step(dp, state, tok, tc)
            outs[grid] = [logits] + [new[k] for k in sorted(new)]
        for grid, out in outs.items():
            assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), (c, grid)
        ref_logits, ref_new = TM.v7_decode_step_ref(dp, state, tok, tc)
        torch.testing.assert_close(outs[132][0], ref_logits, rtol=2e-2, atol=2e-2)
        for got, k in zip(outs[132][1:], sorted(ref_new)):
            torch.testing.assert_close(got, ref_new[k], rtol=2e-2, atol=2e-2)


def test_v7_decode_plan_matches_the_python_plan(cuda_device):
    """The kernel's own stream plan (rwkv_v7_decode_plan: shared bytes,
    stage bytes and count, a block's pieces a layer and of the head, vector
    rows and lora2 runs a piece) is v7_stream_plan's, in every form, at the
    tests' small width, the 169M width and C=1024 with a lora of 128 (two
    lora2 pieces a head in bf16) on several grids; K3 has the static shared
    memory the plan assumes."""
    from rwkv_tpu_torch.ops import _cuda

    fn = _cuda.library("v7_decode").rwkv_v7_decode_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    for c, f, d, h, s, v in ((128, 512, 32, 4, 32, 256), (768, 3072, 64, 12, 64, 65536),
                             (1024, 4096, 128, 16, 64, 65533)):
        for wf, form in enumerate(TM.FORMS):
            for blocks in (132, 66, 33, 7):
                plan = TM.v7_stream_plan(form, c, f, d, h, s, v, blocks)
                for b in sorted({0, 5, blocks - 1}):
                    out = (ctypes.c_longlong * 8)()
                    assert fn(wf, c, s, d, f, h, v, blocks, b, out) == 0
                    assert list(out) == [plan.smem_bytes, plan.stage_bytes, plan.n_stages,
                                         plan.layer_pieces(b), plan.head_pieces(b),
                                         TM.V7_STATIC_SMEM, plan.vec_rows,
                                         plan.l2_runs], (c, form, blocks, b)


def _batched_state(tc, b, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, h, s, c = tc.n_layer, tc.head_count, tc.head_size, tc.n_embed
    return {"att_xx": torch.randn((b, L, c), device=dev, generator=gen),
            "ffn_xx": torch.randn((b, L, c), device=dev, generator=gen),
            "heads": torch.randn((b, L, h, s, s), device=dev, generator=gen) * 0.1}


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 8, 9, 17, 64])
def test_batched_decode_kernel_matches_ref(cuda_device, batch, w4):
    tc, dp = _small_pack(cuda_device, w4)
    state = _batched_state(tc, batch, cuda_device, batch)
    toks = torch.randint(0, tc.n_vocab, (batch,), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = TM.v7_decode_batched.launches
    x, new = TM.v7_decode_batched(dp, state, toks, tc)
    assert TM.v7_decode_batched.launches == before + 1
    x_ref, new_ref = TM.v7_decode_batched_ref(dp, state, toks, tc)
    torch.testing.assert_close(x, x_ref, rtol=2e-2, atol=2e-2)
    for k in new:
        torch.testing.assert_close(new[k], new_ref[k], rtol=2e-2, atol=2e-2)


def _launch_k4(dp, state, toks, tc, place=None):
    """K4 once through its C entry, `place` forcing a placement; (x, state)."""
    TM.v7_decode_batched(dp, {k: v[:1] for k, v in state.items()}, toks[:1], tc)
    x, new, _ = TM.batched_launch(TM.k4_function(dp), dp, state, toks, tc, dp["_grid_batched"],
                                  place=place)
    return x, new


@pytest.mark.parametrize("w4", [False, True])
def test_batched_decode_kernel_same_bits_in_batches_of_1_and_64(cuda_device, w4):
    """A sequence comes out bit for bit the same alone (placement (a)) and
    among 64 (placement (b), its n-tile full)."""
    tc, dp = _small_pack(cuda_device, w4)
    state = _batched_state(tc, 64, cuda_device, 64)
    toks = torch.randint(0, tc.n_vocab, (64,), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(2))
    x, new = TM.v7_decode_batched(dp, state, toks, tc)
    for b in (0, 9, 63):
        one = {k: v[b:b + 1].contiguous() for k, v in state.items()}
        x1, new1 = TM.v7_decode_batched(dp, one, toks[b:b + 1], tc)
        assert torch.equal(x1[0], x[b]), b
        for k in new:
            assert torch.equal(new1[k][0], new[k][b]), (b, k)


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("batch", [9, 17])
def test_batched_decode_kernel_placements_agree(cuda_device, batch, w4):
    """Both placements of the activation preparation give the same bits
    (the same codes, scales and exact integer dots)."""
    tc, dp = _small_pack(cuda_device, w4)
    state = _batched_state(tc, batch, cuda_device, batch + 1)
    toks = torch.randint(0, tc.n_vocab, (batch,), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(3))
    xa, newa = _launch_k4(dp, state, toks, tc, "a")
    xb, newb = _launch_k4(dp, state, toks, tc, "b")
    assert torch.equal(xa, xb)
    for k in newa:
        assert torch.equal(newa[k], newb[k]), k


def test_batched_decode_kernel_identical_lanes(cuda_device):
    """Sequences fed identical inputs come out bit-identical."""
    tc, dp = _small_pack(cuda_device)
    one = _batched_state(tc, 1, cuda_device, 5)
    state = {k: v.repeat(9, *([1] * (v.ndim - 1))) for k, v in one.items()}
    x, new = TM.v7_decode_batched(dp, state, torch.full((9,), 17, device=cuda_device), tc)
    for t in [x] + list(new.values()):
        assert torch.equal(t, t[:1].expand_as(t))


def test_card_batcher_device_loop_matches_host_loop(cuda_device):
    tc = synth_config(*SMALL)
    srv = ServingModel((tc, synth_params(tc, seed=11, lora_dim=32)), precision="w8a8",
                       megakernel=True, device=cuda_device)
    prompts = [[3, 77, 200, 5, 9], [9, 4], list(range(1, 40))]
    kw = dict(max_new_tokens=7, temperature=0.0, presence_penalty=0.4, frequency_penalty=0.25)
    out = []
    for on_device in (True, False):
        b = ContinuousBatcher(srv, max_batch=2, sync_every=3)
        rids = [b.submit(p, **kw) for p in prompts]
        res = b.run(on_device=on_device)
        out.append([res[r].generated for r in rids])
    assert out[0] == out[1]


def test_card_serving_matches_cpu_and_goes_through_kernels(cuda_device):
    tc = synth_config(*SMALL)
    tp = synth_params(tc, seed=11, lora_dim=32)
    gpu = ServingModel((tc, tp), precision="w8a8", megakernel=True, device=cuda_device)
    cpu = ServingModel((tc, tp), precision="w8a8", megakernel=True, device="cpu")
    counts = (TK.quant_matmul.launches, TC.wkv7_recurrence.launches, TM.v7_decode_step.launches)
    prompt = list(np.random.default_rng(0).integers(0, tc.n_vocab, 20))
    lg, sg = gpu.prefill(prompt)
    lc, sc = cpu.prefill(prompt)
    for _ in range(3):
        tok = [int(lc.argmax())]
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
        assert int(lg.argmax()) == tok[0]
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=2e-2, atol=2e-2)
    after = (TK.quant_matmul.launches, TC.wkv7_recurrence.launches, TM.v7_decode_step.launches)
    # two prefill chunks of 14 projections a layer but layer 0's two
    # value-residual LoRA products (its residual is selected away), one head
    assert after[0] - counts[0] == 2 * (14 * tc.n_layer - 2) + 1
    assert after[1] - counts[1] == 2 * tc.n_layer
    assert after[2] - counts[2] == 3


def _wkv6_operands(t, bh, s, dev, seed, extreme=False):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    r, k, v = (rnd(t, bh, s, scale=0.3) for _ in range(3))
    if extreme:  # half the channels decay by exp(-20) a token, some underflow to 0
        w = torch.where(torch.rand((t, bh, s), device=dev, generator=gen) < 0.5,
                        torch.exp(torch.tensor(-20.0, device=dev)), torch.exp(-torch.exp(rnd(t, bh, s) * 3)))
    else:
        w = torch.exp(-torch.exp(rnd(t, bh, s)))
    return rnd(bh, s, s, scale=0.3), r, k, v, w, rnd(bh, s, scale=0.2)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("bh,s", ((32, 64), (96, 64), (2, 128), (8, 32)))
@pytest.mark.parametrize("t", WKV_TS)
def test_wkv6_kernel_matches_scan(cuda_device, t, bh, s, extreme):
    """K5 within rtol 1e-4 / atol 1e-5 of the token recurrence and 3e-4 /
    3e-5 of its plain two-pass form, also on extreme decays; two launches
    bit-identical."""
    ops = _wkv6_operands(t, bh, s, cuda_device, seed=t + s, extreme=extreme)
    before = TC.wkv6_recurrence.launches
    y, s_new = TC.wkv6_recurrence(*ops)
    y2, s2 = TC.wkv6_recurrence(*ops)
    assert TC.wkv6_recurrence.launches == before + 2
    y_ref, s_ref = TC.wkv6_recurrence_plain(*ops)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s_new, s_ref, rtol=1e-4, atol=1e-5)
    y_tp, s_tp = TC.wkv6_twopass(*ops)
    torch.testing.assert_close(y, y_tp, rtol=3e-4, atol=3e-5)
    torch.testing.assert_close(s_new, s_tp, rtol=3e-4, atol=3e-5)
    assert torch.equal(y, y2) and torch.equal(s_new, s2)


def _small_pack6(dev, w4=False, seed=7):
    tc = synth_config(*SMALL6)
    tp = synth_params(tc, seed=seed)
    pack = TM.build_mega_pack_v6(tp, tc, w4=w4)
    return tc, TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], dev)


@pytest.mark.parametrize("w4", [False, True])
def test_v6_decode_kernel_matches_ref(cuda_device, w4):
    tc, dp = _small_pack6(cuda_device, w4)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    L, h, s, c = tc.n_layer, tc.head_count, tc.head_size, tc.n_embed
    state = {"att_xx": torch.randn((L, c), device=cuda_device, generator=gen) * 0.5,
             "ffn_xx": torch.randn((L, c), device=cuda_device, generator=gen) * 0.5,
             "heads": torch.randn((L, h, s, s), device=cuda_device, generator=gen) * 0.1}
    tok = torch.tensor([5], device=cuda_device)
    before = TM.v6_decode_step.launches
    logits, new = TM.v6_decode_step(dp, state, tok, tc)
    logits2, new2 = TM.v6_decode_step(dp, state, tok, tc)
    assert TM.v6_decode_step.launches == before + 2
    assert torch.equal(logits, logits2) and all(torch.equal(new[k], new2[k]) for k in new)
    ref_logits, ref_new = TM.v6_decode_step_ref(dp, state, tok, tc)
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        torch.testing.assert_close(new[k], ref_new[k], rtol=2e-2, atol=2e-2)


def test_v6_decode_kernel_refuses_a_v7_pack(cuda_device):
    tc, dp = _small_pack(cuda_device)
    tc6 = synth_config(*SMALL6)
    state = {"att_xx": torch.zeros((2, 256), device=cuda_device),
             "ffn_xx": torch.zeros((2, 256), device=cuda_device),
             "heads": torch.zeros((2, 4, 64, 64), device=cuda_device)}
    with pytest.raises((ValueError, KeyError)):
        TM.v6_decode_step(dp, state, torch.tensor([1], device=cuda_device), tc6)


@pytest.mark.parametrize("precision", ["w8a8", "w4a8"])
def test_card_v6_serving_matches_cpu_and_goes_through_kernels(cuda_device, precision):
    tc = synth_config(*SMALL6)
    tp = synth_params(tc, seed=11)
    gpu = ServingModel((tc, tp), precision=precision, megakernel=True, device=cuda_device)
    cpu = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    counts = (TK.quant_matmul.launches, TC.wkv6_recurrence.launches, TM.v6_decode_step.launches)
    prompt = list(np.random.default_rng(0).integers(0, tc.n_vocab, 20))
    lg, sg = gpu.prefill(prompt)
    lc, sc = cpu.prefill(prompt)
    for _ in range(3):
        tok = [int(lc.argmax())]
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
        assert int(lg.argmax()) == tok[0]
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=2e-2, atol=2e-2)
    after = (TK.quant_matmul.launches, TC.wkv6_recurrence.launches, TM.v6_decode_step.launches)
    assert after[0] - counts[0] == 2 * 11 * tc.n_layer + 1  # two prefill chunks, one head
    assert after[1] - counts[1] == 2 * tc.n_layer
    assert after[2] - counts[2] == 3


def _c768_pack6(dev, form: str):
    tc = synth_config("6.0", 1, 768, 256, 64)
    tp = synth_params(tc, seed=3)
    pack = TM.build_mega_pack_v6(tp, tc, w4=form == "i4", quant=form != "bf16")
    return tc, TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], dev)


def _state6(tc, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, c, h, s = tc.n_layer, tc.n_embed, tc.head_count, tc.head_size
    return {"att_xx": torch.randn((L, c), device=dev, generator=gen) * 0.5,
            "ffn_xx": torch.randn((L, c), device=dev, generator=gen) * 0.5,
            "heads": torch.randn((L, h, s, s), device=dev, generator=gen) * 0.1}


@pytest.mark.parametrize("form", TM.FORMS)
def test_v6_decode_kernel_takes_c768(cuda_device, form):
    """K6 at C=768 (F=3072), where a row's 16-byte chunks are no power of
    two per lane: the lane count stays a power of two (lanes_for); in each
    weight form, the int ones within 2e-2 and bf16 within BF16_BAND of the
    scale."""
    tc, dp = _c768_pack6(cuda_device, form)
    state = _state6(tc, cuda_device, 2)
    tok = torch.tensor([7], device=cuda_device)
    logits, new = TM.v6_decode_step(dp, state, tok, tc)
    ref_logits, ref_new = TM.v6_decode_step_ref(dp, state, tok, tc)
    if form == "bf16":
        assert _rel(logits, ref_logits) <= BF16_BAND
        assert all(_rel(new[k], ref_new[k]) <= BF16_BAND for k in new)
        return
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    for k in new:
        torch.testing.assert_close(new[k], ref_new[k], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", ["SMALL6", "C768"])
def test_v6_decode_kernel_same_bits_on_every_grid(cuda_device, width, form):
    """K6's stream plan deals each phase's rows over the grid, but never
    changes how a row is computed: logits and state are bit-equal on grids
    of 132, 64, 33 and 7 blocks (pack["_grid_v6"]), in every weight form."""
    if width == "SMALL6":
        tc = synth_config(*SMALL6)
        tp = synth_params(tc, seed=7)
        pack = TM.build_mega_pack_v6(tp, tc, w4=form == "i4", quant=form != "bf16")
        dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], cuda_device)
    else:
        tc, dp = _c768_pack6(cuda_device, form)
    state = _state6(tc, cuda_device, 4)
    tok = torch.tensor([9], device=cuda_device)
    outs = {}
    for grid in (132, 64, 33, 7):
        dp["_grid_v6"] = grid
        logits, new = TM.v6_decode_step(dp, state, tok, tc)
        outs[grid] = [logits] + [new[k] for k in sorted(new)]
    for grid, out in outs.items():
        assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), grid


def test_v6_decode_plan_matches_the_python_plan(cuda_device):
    """The kernel's own stream plan (rwkv_v6_decode_plan: shared bytes,
    stage bytes and count, a block's pieces a layer and of the head) is
    v6_stream_plan's, in every form at SMALL6, C=768 and the 1.6B width on
    several grids; K6 has the static shared memory the plan assumes."""
    from rwkv_tpu_torch.ops import _cuda

    fn = _cuda.library("v6_decode").rwkv_v6_decode_plan
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    for c, f, h, v in ((256, 1024, 4, 256), (768, 3072, 12, 65536), (2048, 8192, 32, 65536)):
        for wf, form in enumerate(TM.FORMS):
            for blocks in (132, 33, 7):
                plan = TM.v6_stream_plan(form, c, f, 32, 64, h, 64, v, blocks)
                for b in sorted({0, 5, blocks - 1}):
                    out = (ctypes.c_longlong * 6)()
                    assert fn(wf, c, 64, 32, 64, f, h, v, blocks, b, out) == 0
                    assert list(out) == [plan.smem_bytes, plan.stage_bytes, plan.n_stages,
                                         plan.layer_pieces(b), plan.head_pieces(b),
                                         TM.V6_STATIC_SMEM], (c, form, blocks, b)


def _v45_setup(version, dev, w4=False, seed=7, c=256):
    tc = synth_config(version, 2, c, 256, 64)
    tp = synth_params(tc, seed=seed)
    build = TM.build_mega_pack_v5 if tc.version_major == 5 else TM.build_mega_pack_v4
    return tc, TM.device_pack(build(tp, tc, w4=w4), tp["emb"].to(torch.bfloat16), tp["ln0"], dev)


def _v45_state(tc, dev, seed, blank=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, c = tc.n_layer, tc.n_embed

    def rnd(*shape, scale=0.5):
        return torch.randn(shape, device=dev, generator=gen) * scale

    if tc.version_major == 5:
        return {"att_xx": rnd(L, c), "ffn_xx": rnd(L, c),
                "heads": rnd(L, tc.head_count, 64, 64, scale=0.1)}
    if blank:
        zero = torch.zeros((L, c), device=dev)
        return {"att_xx": zero, "ffn_xx": zero, "aa": zero, "bb": zero,
                "pp": torch.full((L, c), -1e30, device=dev)}
    return {"att_xx": rnd(L, c), "ffn_xx": rnd(L, c), "aa": rnd(L, c, scale=1.0),
            "bb": rnd(L, c).abs() + 0.5, "pp": rnd(L, c, scale=1.0)}


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("version", V45)
def test_v45_decode_kernel_matches_ref(cuda_device, version, w4):
    """K7 (v5.2, v5.1) and K8 (v4) against their plain versions; two
    launches agree bit for bit."""
    tc, dp = _v45_setup(version, cuda_device, w4)
    step, ref = ((TM.v5_decode_step, TM.v5_decode_step_ref) if tc.version_major == 5
                 else (TM.v4_decode_step, TM.v4_decode_step_ref))
    state = _v45_state(tc, cuda_device, 0)
    tok = torch.tensor([5], device=cuda_device)
    before = step.launches
    logits, new = step(dp, state, tok, tc)
    logits2, new2 = step(dp, state, tok, tc)
    assert step.launches == before + 2
    assert torch.equal(logits, logits2) and all(torch.equal(new[k], new2[k]) for k in new)
    ref_logits, ref_new = ref(dp, state, tok, tc)
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        torch.testing.assert_close(new[k], ref_new[k], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("c", [768, 2048])
def test_v4_decode_kernel_from_blank_state(cuda_device, c):
    """K8 from the blank state (pp = -1e30) at the World 0.1B and 1.5B
    widths cut to 2 layers: finite, and within 2e-2 of its plain version."""
    tc, dp = _v45_setup("4.0", cuda_device, c=c)
    state = _v45_state(tc, cuda_device, 1, blank=True)
    tok = torch.tensor([9], device=cuda_device)
    logits, new = TM.v4_decode_step(dp, state, tok, tc)
    ref_logits, ref_new = TM.v4_decode_step_ref(dp, state, tok, tc)
    assert all(bool(torch.isfinite(t).all()) for t in [logits] + list(new.values()))
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    for k in new:
        torch.testing.assert_close(new[k], ref_new[k], rtol=2e-2, atol=2e-2)


def test_v45_decode_kernel_refuses_a_v6_pack(cuda_device):
    tc6, dp6 = _small_pack6(cuda_device)
    tc5 = synth_config("5.2", 2, 256, 256, 64)
    with pytest.raises(ValueError):
        TM.v5_decode_step(dp6, _v45_state(tc5, cuda_device, 0),
                          torch.tensor([1], device=cuda_device), tc5)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version", ["5.2", "5.1"])
def test_v5_decode_kernel_same_bits_on_every_grid(cuda_device, version, form):
    """K7's stream plan deals each phase's rows over the grid, but never
    changes how a row is computed: logits and state are bit-equal on grids
    of 132, 64, 33 and 7 blocks (pack["_grid_v45"]), in every weight form,
    at C=256 (H=4) and C=768 (H=12)."""
    for c in (256, 768):
        tc = synth_config(version, 2, c, 256, 64)
        tp = synth_params(tc, seed=7)
        pack = TM.build_mega_pack_v5(tp, tc, w4=form == "i4", quant=form != "bf16")
        dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], cuda_device)
        state = _v45_state(tc, cuda_device, 4)
        tok = torch.tensor([9], device=cuda_device)
        outs = {}
        for grid in (132, 64, 33, 7):
            dp["_grid_v45"] = grid
            logits, new = TM.v5_decode_step(dp, state, tok, tc)
            outs[grid] = [logits] + [new[k] for k in sorted(new)]
        for grid, out in outs.items():
            assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), (c, grid)


@pytest.mark.parametrize("version", ["5.2", "5.1"])
def test_v5_decode_kernel_at_c4096_in_bf16(cuda_device, version):
    """K7's bf16 form at C=4096 (F=16384, one layer), where the ring holds
    three stages of two vector rows: v5.1 holds phase A's three vector
    pieces at once, v5.2 releases ln1's piece before the mixes' amax
    (v5_stream_plan(...).phase_a_fused() is False). Both within BF16_BAND
    of the plain version, equal argmax, two launches bit for bit."""
    tc = synth_config(version, 1, 4096, 256, 64)
    tp = synth_params(tc, seed=3)
    dp = TM.device_pack(TM.build_mega_pack_v5(tp, tc, quant=False),
                        tp["emb"].to(torch.bfloat16), tp["ln0"], cuda_device)
    n_att = 4 if dp["has_gate"] else 3
    plan = TM.v5_stream_plan("bf16", 4096, dp["f_dim"], 64, 64, 256, 132, n_att)
    assert plan.n_stages == 3 and plan.phase_a_fused() == (version == "5.1")
    state = _v45_state(tc, cuda_device, 5)
    tok = torch.tensor([3], device=cuda_device)
    logits, new = TM.v5_decode_step(dp, state, tok, tc)
    logits2, new2 = TM.v5_decode_step(dp, state, tok, tc)
    assert torch.equal(logits, logits2) and all(torch.equal(new[k], new2[k]) for k in new)
    ref_logits, ref_new = TM.v5_decode_step_ref(dp, state, tok, tc)
    assert _rel(logits, ref_logits) <= BF16_BAND
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        assert _rel(new[k], ref_new[k]) <= BF16_BAND, k


def test_v5_decode_plan_matches_the_python_plan(cuda_device):
    """The kernel's own stream plan (rwkv_v5_decode_plan: shared bytes,
    stage bytes and count, a block's pieces a layer and of the head) is
    v5_stream_plan's, in every form, for v5.2 and v5.1, at C=256, 768, 2048
    and 4096 on several grids; K7 has the static shared memory the plan
    assumes."""
    from rwkv_tpu_torch.ops import _cuda

    fn = _cuda.library("v5_decode").rwkv_v5_decode_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    for c, f, h, v in ((256, 1024, 4, 256), (768, 3072, 12, 65536), (2048, 8192, 32, 65536),
                       (4096, 14336, 64, 65536)):
        for wf, form in enumerate(TM.FORMS):
            for gate in (0, 1):
                for blocks in (132, 33, 7):
                    plan = TM.v5_stream_plan(form, c, f, h, 64, v, blocks, 3 + gate)
                    for b in sorted({0, 5, blocks - 1}):
                        out = (ctypes.c_longlong * 6)()
                        assert fn(wf, gate, c, 64, f, h, v, blocks, b, out) == 0
                        assert list(out) == [plan.smem_bytes, plan.stage_bytes, plan.n_stages,
                                             plan.layer_pieces(b), plan.head_pieces(b),
                                             TM.V5_STATIC_SMEM], (c, form, gate, blocks, b)


@pytest.mark.parametrize("form", TM.FORMS)
def test_v4_decode_kernel_same_bits_on_every_grid(cuda_device, form):
    """K8's stream plan deals each phase's rows and the state's channels
    over the grid, but never changes how a row or a channel is computed:
    logits and aa / bb / pp / att_xx / ffn_xx are bit-equal on grids of
    132, 64, 33 and 7 blocks (pack["_grid_v45"]), in every weight form, at
    C=256 and C=768, from a seeded state and from the blank one (pp =
    -1e30); there also finite and within 2e-2 of the plain version."""
    for c in (256, 768):
        tc, dp = _v4_pack(cuda_device, form, c)
        tok = torch.tensor([9], device=cuda_device)
        for blank in (False, True):
            state = _v45_state(tc, cuda_device, 4, blank=blank)
            outs = {}
            for grid in (132, 64, 33, 7):
                dp["_grid_v45"] = grid
                logits, new = TM.v4_decode_step(dp, state, tok, tc)
                outs[grid] = [logits] + [new[k] for k in sorted(new)]
            for grid, out in outs.items():
                assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), (c, blank, grid)
            assert all(bool(torch.isfinite(t).all()) for t in outs[132])
            ref_logits, ref_new = TM.v4_decode_step_ref(dp, state, tok, tc)
            torch.testing.assert_close(outs[132][0], ref_logits, rtol=2e-2, atol=2e-2)
            for got, k in zip(outs[132][1:], sorted(ref_new)):
                torch.testing.assert_close(got, ref_new[k], rtol=2e-2, atol=2e-2)


def _v4_pack(dev, form, c):
    """A 2-layer v4 pack of width c in weight form `form`, V=256."""
    tc = synth_config("4.0", 2, c, 256, 64)
    tp = synth_params(tc, seed=7)
    pack = TM.build_mega_pack_v4(tp, tc, w4=form == "i4", quant=form != "bf16")
    return tc, TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], dev)


def test_v4_decode_kernel_at_c4096_in_bf16(cuda_device):
    """K8's bf16 form at C=4096 (F=16384, one layer), where a stage holds
    two vector rows and phase A holds its three vector pieces at once: within
    BF16_BAND of the plain version, equal argmax, two launches bit for
    bit."""
    tc = synth_config("4.0", 1, 4096, 256, 64)
    tp = synth_params(tc, seed=3)
    dp = TM.device_pack(TM.build_mega_pack_v4(tp, tc, quant=False),
                        tp["emb"].to(torch.bfloat16), tp["ln0"], cuda_device)
    plan = TM.v4_stream_plan("bf16", 4096, dp["f_dim"], 256, 132)
    assert plan.vec_rows == 2 and plan.count("vec_a", 0) == 3 <= plan.n_stages
    state = _v45_state(tc, cuda_device, 5)
    tok = torch.tensor([3], device=cuda_device)
    logits, new = TM.v4_decode_step(dp, state, tok, tc)
    logits2, new2 = TM.v4_decode_step(dp, state, tok, tc)
    assert torch.equal(logits, logits2) and all(torch.equal(new[k], new2[k]) for k in new)
    ref_logits, ref_new = TM.v4_decode_step_ref(dp, state, tok, tc)
    assert _rel(logits, ref_logits) <= BF16_BAND
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        assert _rel(new[k], ref_new[k]) <= BF16_BAND, k


def test_v4_decode_plan_matches_the_python_plan(cuda_device):
    """The kernel's own stream plan (rwkv_v4_decode_plan: shared bytes,
    stage bytes and count, a block's pieces a layer and of the head, vector
    rows a piece) is v4_stream_plan's, in every form, at C=256, 768, 2048
    and 4096 (the head's V a multiple of 4 and not) on several grids; K8 has
    the static shared memory the plan assumes."""
    for c, v in ((256, 256), (768, 65536), (768, 258), (2048, 65536), (4096, 65533)):
        for form in TM.FORMS:
            for blocks in (132, 64, 33, 7):
                plan = TM.v4_stream_plan(form, c, 4 * c, v, blocks)
                for b in sorted({0, 5, blocks - 1}):
                    got = TM.v4_kernel_plan(form, c, 4 * c, v, blocks, b)
                    assert got == (plan.smem_bytes, plan.stage_bytes, plan.n_stages,
                                   plan.layer_pieces(b), plan.head_pieces(b),
                                   TM.V4_STATIC_SMEM, plan.vec_rows), (c, form, blocks, b)


@pytest.mark.parametrize("precision", ["w8a8", "w4a8"])
@pytest.mark.parametrize("version", V45)
def test_card_v45_serving_matches_cpu_and_goes_through_kernels(cuda_device, version, precision):
    tc = synth_config(version, 2, 256, 256, 64)
    tp = synth_params(tc, seed=11)
    gpu = ServingModel((tc, tp), precision=precision, megakernel=True, device=cuda_device)
    cpu = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    step = TM.v5_decode_step if tc.version_major == 5 else TM.v4_decode_step
    counts = (TK.quant_matmul.launches, TC.wkv6_recurrence.launches, step.launches)
    prompt = list(np.random.default_rng(0).integers(0, tc.n_vocab, 20))
    lg, sg = gpu.prefill(prompt)
    lc, sc = cpu.prefill(prompt)
    for _ in range(3):
        tok = [int(lc.argmax())]
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
        assert int(lg.argmax()) == tok[0]
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=2e-2, atol=2e-2)
    after = (TK.quant_matmul.launches, TC.wkv6_recurrence.launches, step.launches)
    per_layer = 8 if version == "5.2" else 7  # projections a layer on K1
    assert after[0] - counts[0] == 2 * per_layer * tc.n_layer + 1  # two prefill chunks, one head
    assert after[1] - counts[1] == (2 * tc.n_layer if tc.version_major == 5 else 0)
    assert after[2] - counts[2] == 3


# -- K9: the block-format quantized matmul ------------------------------------

K9_CASES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K", "q8", "q8r"]


def _k9_weight(fmt, n, k, seed):
    """A seeded [n, k] weight in `fmt` (a file format, q8 or q8r)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    w[0] = 0.0
    if fmt in ("q8", "q8r"):
        return TK.quantize_q8_serving(w, rowwise=fmt == "q8r", int8_act=False)
    dt = TQ.dtype_from_name(fmt)
    return TK.PackedQuantWeight.from_weight(
        Weight.from_packed(TQ.quantize_rows(w, dt).tobytes(), dt, (n, k)))


# 1.5B-width shapes: every form but the K-quants, whose host quantization
# of a 16M-element matrix takes a minute (Q5_1 covers their min form)
K9_WIDE = [(256, 2048, 2048), (256, 2048, 8192), (256, 8192, 2048), (8, 8192, 2048)]


@pytest.mark.parametrize("fmt", K9_CASES)
def test_block_matmul_kernel_matches_plain(cuda_device, fmt):
    """K9 against its plain version in every form, on both routes: M in
    {1, 3, 5, 8} (GEMV) and {9, 33, 256, 300} (tensor cores), the split-K
    shapes (768 -> 64, 3072 -> 768, 768 -> 768), K tails (K % 64 == 32),
    ragged N, the 1.5B widths: within 1e-5 of sum |x| |W|; two launches
    bit-identical."""
    shapes = [(1, 768, 768), (8, 3072, 768), (5, 2080, 195), (9, 256, 200), (256, 768, 3072),
              (3, 32, 64), (256, 64, 768), (1, 3072, 768), (33, 2080, 195), (300, 768, 768),
              (256, 768, 64), (256, 3072, 768), (256, 768, 768), (9, 32, 16)]
    if fmt in ("Q4_K", "Q5_K"):
        shapes = [(m, k, n) for m, k, n in shapes if k % 256 == 0]
    else:
        shapes += K9_WIDE
    if fmt in ("q8", "q8r"):
        shapes.append((1, 768, 65536))  # the head
    for m, k, n in shapes:
        w = _k9_weight(fmt, n, k, m + k + n).to(cuda_device)
        gen = torch.Generator(device=cuda_device).manual_seed(m * k)
        x = torch.randn((m, k), device=cuda_device, generator=gen)
        before = TK.quant_matmul.launches_by_form[w.form]
        y = TK.quant_matmul(x, w)
        y2 = TK.quant_matmul(x, w)
        assert TK.quant_matmul.launches_by_form[w.form] == before + 2
        assert torch.equal(y, y2), (fmt, m, k, n)
        ref = TK.block_matmul_plain(x, w)
        band = x.abs() @ TK.dequant_weight(w).abs().T
        assert bool(((y - ref).abs() <= 1e-5 * band + 1e-30).all()), (fmt, m, k, n)


def test_block_matmul_kernel_refuses_what_it_cannot_take(cuda_device):
    w = _k9_weight("Q5_1", 64, 64, 0).to(cuda_device)
    with pytest.raises(ValueError):
        TK.quant_matmul(torch.ones((2, 32), device=cuda_device), w)  # K mismatch
    bad = TK.PackedQuantWeight(q=w.q, d=w.d, m=w.m, pack4=False, rowwise=False, int8_act=False)
    bad.q = torch.zeros((64, 48), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        TK.quant_matmul(torch.ones((2, 48), device=cuda_device), bad)  # K % 32
    q4 = _k9_weight("Q4_0", 64, 64, 0).to(cuda_device)
    q4.signed4 = False
    with pytest.raises(ValueError):
        TK.quant_matmul(torch.ones((2, 64), device=cuda_device), q4)


@pytest.mark.parametrize("fmt", ["Q5_1", "Q4_0"])
def test_card_quant_file_serving_matches_cpu(cuda_device, tmp_path, fmt):
    """ServingModel(path, "quant") on the card (K9 and K2) against the CPU
    on a small v7 file: 5e-3 of the scale (bf16 head and LoRAs), equal
    argmax; every projection of a layer on K9."""
    tc = synth_config("7.0", 2, 256, 256, 64)
    src, path = tmp_path / "f32.bin", tmp_path / "q.bin"
    write_synth_ggmf(tc, synth_params(tc, seed=5), str(src))
    quantize_model_file(str(src), str(path), fmt, verbose=False)
    gpu = ServingModel(str(path), precision="quant", device=cuda_device)
    cpu = ServingModel(str(path), precision="quant", device="cpu")
    form = "pack4" if fmt == "Q4_0" else "min"
    before = TK.quant_matmul.launches_by_form[form]
    prompt = list(np.random.default_rng(0).integers(0, tc.n_vocab, 20))
    lg, sg = gpu.prefill(prompt)
    lc, sc = cpu.prefill(prompt)
    for _ in range(4):
        tok = [int(lc.argmax())]
        assert int(lg.argmax()) == tok[0]
        scale = float(lc.abs().max())
        assert float((lg.cpu() - lc).abs().max()) <= 5e-3 * scale
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
    for k in sc:
        assert float((sg[k].cpu() - sc[k]).abs().max()) <= 5e-3 * float(sc[k].abs().max()), k
    # r, k, v, out, fk, fv a layer: two prefill chunks and four decode steps
    assert TK.quant_matmul.launches_by_form[form] - before == 6 * tc.n_layer * 6


# -- the bf16 forms of K3, K4, K6, K7 and K8 ----------------------------------

BF16_VERSIONS = ("7.0", "6.0", "5.2", "5.1", "4.0")
BF16_BAND = 1e-4  # of the scale: no activation codes, only the order of f32 sums differs


def _rel(a, ref) -> float:
    return float((a - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _bf16_setup(version, dev, depth=2, c=None, emb_f32=False):
    """A seeded 2-layer bf16 pack (quant=False) of `version` on `dev`, the
    config cut to its first `depth` layers (a shallower config over the
    same buffers) and a seeded state of that depth."""
    c = c or (128 if version == "7.0" else 256)
    s = 32 if version == "7.0" else 64
    tc = synth_config(version, 2, c, 256, s)
    tp = synth_params(tc, seed=7, **({"lora_dim": 32} if version == "7.0" else {}))
    build = {7: TM.build_mega_pack, 6: TM.build_mega_pack_v6, 5: TM.build_mega_pack_v5,
             4: TM.build_mega_pack_v4}[tc.version_major]
    emb = tp["emb"].float() if emb_f32 else tp["emb"].to(torch.bfloat16)
    dp = TM.device_pack(build(tp, tc, quant=False), emb, tp["ln0"], dev)
    tc = dataclasses.replace(tc, n_layer=depth)
    if tc.version_major == 4:
        return tc, dp, _v45_state(tc, dev, depth)
    gen = torch.Generator(device=dev).manual_seed(depth)
    state = {"att_xx": torch.randn((depth, c), device=dev, generator=gen) * 0.5,
             "ffn_xx": torch.randn((depth, c), device=dev, generator=gen) * 0.5,
             "heads": torch.randn((depth, c // s, s, s), device=dev, generator=gen) * 0.1}
    return tc, dp, state


_BF16_STEPS = {7: (TM.v7_decode_step, TM.v7_decode_step_ref),
               6: (TM.v6_decode_step, TM.v6_decode_step_ref),
               5: (TM.v5_decode_step, TM.v5_decode_step_ref),
               4: (TM.v4_decode_step, TM.v4_decode_step_ref)}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("version", BF16_VERSIONS)
def test_bf16_decode_kernel_matches_ref(cuda_device, version, depth):
    """The bf16 form of K3 (v7), K6, K7 and K8 on 1- and 2-layer packs
    against its plain version within BF16_BAND of the scale, equal argmax;
    two launches agree bit for bit and count as bf16 launches."""
    tc, dp, state = _bf16_setup(version, cuda_device, depth)
    step, ref = _BF16_STEPS[tc.version_major]
    tok = torch.tensor([5], device=cuda_device)
    before = dict(step.launches_by_form)
    logits, new = step(dp, state, tok, tc)
    logits2, new2 = step(dp, state, tok, tc)
    assert step.launches_by_form["bf16"] == before["bf16"] + 2
    assert step.launches_by_form["i8"] == before["i8"]
    assert torch.equal(logits, logits2) and all(torch.equal(new[k], new2[k]) for k in new)
    ref_logits, ref_new = ref(dp, state, tok, tc)
    assert _rel(logits, ref_logits) <= BF16_BAND
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in new:
        assert _rel(new[k], ref_new[k]) <= BF16_BAND, k


def test_bf16_decode_kernel_embeds_from_an_f32_table(cuda_device):
    """Under precision="f32" the bf16 form embeds from the f32 table."""
    tc, dp, state = _bf16_setup("5.2", cuda_device, emb_f32=True)
    tok = torch.tensor([11], device=cuda_device)
    logits, _ = TM.v5_decode_step(dp, state, tok, tc)
    ref_logits, _ = TM.v5_decode_step_ref(dp, state, tok, tc)
    assert dp["emb"].dtype == torch.float32 and _rel(logits, ref_logits) <= BF16_BAND


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_bf16_batched_decode_kernel_matches_ref(cuda_device, batch):
    tc, dp, _ = _bf16_setup("7.0", cuda_device)
    state = _batched_state(tc, batch, cuda_device, batch)
    toks = torch.randint(0, tc.n_vocab, (batch,), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = TM.v7_decode_batched.launches_by_form["bf16"]
    x, new = TM.v7_decode_batched(dp, state, toks, tc)
    assert TM.v7_decode_batched.launches_by_form["bf16"] == before + 1
    x_ref, new_ref = TM.v7_decode_batched_ref(dp, state, toks, tc)
    assert _rel(x, x_ref) <= BF16_BAND
    for k in new:
        assert _rel(new[k], new_ref[k]) <= BF16_BAND, k


def test_bf16_batched_decode_kernel_at_c2048(cuda_device):
    """K4's bf16 form at C=2048, F=8192, where batched_plan takes
    placement (b) at every B and the rows in K slices: B=3, each sequence
    within BF16_BAND of the plain version; identical lanes agree bit for
    bit."""
    tc, dp, _ = _bf16_setup("7.0", cuda_device, depth=1, c=2048)
    state = _batched_state(tc, 3, cuda_device, 4)
    toks = torch.tensor([3, 100, 3], device=cuda_device)
    state["heads"][2] = state["heads"][0]
    state["att_xx"][2], state["ffn_xx"][2] = state["att_xx"][0], state["ffn_xx"][0]
    x, new = TM.v7_decode_batched(dp, state, toks, tc)
    plan = dp["_plans"][(3, dp["_grid_batched"], None)]
    assert plan.place == "b" and plan.k_slice[0] < 2048
    x_ref, new_ref = TM.v7_decode_batched_ref(dp, state, toks, tc)
    assert _rel(x, x_ref) <= BF16_BAND
    for k in new:
        assert _rel(new[k], new_ref[k]) <= BF16_BAND, k
    assert torch.equal(x[0], x[2]) and torch.equal(new["heads"][0], new["heads"][2])


@pytest.mark.parametrize("c", [128, 768])
def test_bf16_batched_decode_kernel_same_bits_on_every_grid(cuda_device, c):
    """The bf16 form's row sums take an order fixed by K alone: x and
    state are bit-equal on grids of 132, 64, 33 and 7 blocks, in both
    placements (B = 8 in (a) and (b), B = 64 in (b)), and a sequence of the
    batch of 64 equals, bit for bit, its run alone and in a batch of 8."""
    tc, dp, _ = _bf16_setup("7.0", cuda_device, depth=1, c=c)
    state = _batched_state(tc, 64, cuda_device, 11)
    toks = torch.randint(0, tc.n_vocab, (64,), device=cuda_device,
                         generator=torch.Generator(device=cuda_device).manual_seed(4))
    TM.v7_decode_batched(dp, {k: v[:1] for k, v in state.items()}, toks[:1], tc)
    fn = TM.k4_function(dp)
    outs = {}
    for b, place in ((8, "a"), (8, "b"), (64, "b")):
        st = {k: v[:b].contiguous() for k, v in state.items()}
        for grid in (132, 64, 33, 7):
            x, new, _ = TM.batched_launch(fn, dp, st, toks[:b], tc, grid, place=place)
            outs[(b, place, grid)] = [x] + [new[k] for k in sorted(new)]
    ref = outs[(64, "b", 132)]
    for key, out in outs.items():
        for got, want in zip(out, ref):
            assert torch.equal(got, want[:key[0]]), key
    for b in (0, 9, 63):
        one = {k: v[b:b + 1].contiguous() for k, v in state.items()}
        x1, new1 = TM.v7_decode_batched(dp, one, toks[b:b + 1], tc)
        assert torch.equal(x1[0], ref[0][b]), b
        for got, k in zip(ref[1:], sorted(new1)):
            assert torch.equal(new1[k][0], got[b]), (b, k)


def test_batched_decode_plan_matches_the_python_plan(cuda_device):
    """The kernel's count of a plan's shared bytes (rwkv_v7_decode_batched_
    smem) is batched_plan's, in every form and each placement with a plan,
    at the tests' small width, the 169M width and the 1.5B width, B =
    1-256, on grids of 132, 64, 33 and 7 blocks (the bf16 form has a plan
    at every one)."""
    from rwkv_tpu_torch.ops import _cuda

    fn = _cuda.library("v7_decode_batched").rwkv_v7_decode_batched_smem
    fn.argtypes = [ctypes.c_int] * 14
    fn.restype = ctypes.c_longlong
    for c, f, d, s in ((128, 512, 32, 32), (768, 3072, 64, 64), (2048, 8192, 96, 64)):
        for form, code in TM.K4_FORM_CODE.items():
            for blocks in (132, 64, 33, 7):
                for b in (1, 3, 8, 9, 17, 64, 65, 128, 256):
                    plans = []
                    if form == "bf16":
                        plans.append(TM.batched_plan(form, b, c, f, d, head_size=s,
                                                     blocks=blocks))
                    for place in ("a", "b"):
                        try:
                            plans.append(TM.batched_plan(form, b, c, f, d, head_size=s,
                                                         blocks=blocks, place=place))
                        except ValueError:
                            continue
                    for p in plans:
                        got = fn(code, c, s, d, f, b, blocks, *p.ints()[:-1])
                        assert got == p.smem, (form, c, b, blocks, got, p)


def test_bf16_batched_decode_kernel_after_a_wider_model(cuda_device):
    """K4's bf16 form at C=768 (B=8: placement (a)), then at C=2048 (B=2:
    (b)), each plan within a few KB of the limit, then at C=768 again on
    its cached grid: the kernel's shared-memory limit is the device's, not
    the last launch's."""
    narrow, dp_n, _ = _bf16_setup("7.0", cuda_device, depth=1, c=768)
    wide, dp_w, _ = _bf16_setup("7.0", cuda_device, depth=1, c=2048)
    st_n = _batched_state(narrow, 8, cuda_device, 5)
    toks = torch.arange(8, device=cuda_device)
    x1, _ = TM.v7_decode_batched(dp_n, st_n, toks, narrow)
    TM.v7_decode_batched(dp_w, _batched_state(wide, 2, cuda_device, 6), toks[:2], wide)
    x2, _ = TM.v7_decode_batched(dp_n, st_n, toks, narrow)
    assert torch.equal(x1, x2)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("version", BF16_VERSIONS)
def test_card_bf16_serving_matches_cpu_and_goes_through_kernels(cuda_device, version,
                                                                 precision):
    """megakernel=True under bf16 / f32 on the card against the CPU: from
    the CPU's prefill state, 3 greedy B=1 steps through the bf16 form of
    K3 / K6 / K7 / K8 (and for v7 a B=2 step through K4's), within
    BF16_BAND of the scale."""
    s = 32 if version == "7.0" else 64
    tc = synth_config(version, 2, 128 if version == "7.0" else 256, 256, s)
    tp = synth_params(tc, seed=11, **({"lora_dim": 32} if version == "7.0" else {}))
    gpu = ServingModel((tc, tp), precision=precision, megakernel=True, device=cuda_device)
    cpu = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    step = _BF16_STEPS[tc.version_major][0]
    before = step.launches_by_form["bf16"]
    lc, sc = cpu.prefill(list(np.random.default_rng(0).integers(0, tc.n_vocab, 20)))
    sg = {k: v.to(cuda_device) for k, v in sc.items()}
    for _ in range(3):
        tok = [int(lc.argmax())]
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
        assert _rel(lg.cpu(), lc) <= BF16_BAND and int(lg.argmax()) == int(lc.argmax())
        for k in sc:
            assert _rel(sg[k].cpu(), sc[k]) <= BF16_BAND, k
    assert step.launches_by_form["bf16"] - before == 3
    if tc.version_major == 7:
        st2 = {k: torch.cat([v, v.flip(-1)]) for k, v in sc.items()}
        b4 = TM.v7_decode_batched.launches_by_form["bf16"]
        lg2, _ = gpu.decode([1, 2], {k: v.to(cuda_device) for k, v in st2.items()})
        lc2, _ = cpu.decode([1, 2], st2)
        assert TM.v7_decode_batched.launches_by_form["bf16"] == b4 + 1
        # the per-op bf16 head rounds x to bf16: a last-bit difference in x
        # can flip one rounding (f32: within the band)
        band = BF16_BAND if precision == "f32" else 2e-3
        assert _rel(lg2.cpu(), lc2) <= band


# -- K10-K15: the tensor-parallel shard kernels (tp=2 on one card) ------------

def _tp_packs(version: str, precision: str, dev, c: int = 256, n_layer: int = 2, tp: int = 2):
    from rwkv_tpu_torch.ops import megakernel_tp as TT
    from rwkv_tpu_torch.parallel.sharding import make_mesh

    tc = synth_config(version, n_layer, c, 256, 64)
    tp_ = synth_params(tc, seed=13, **({"lora_dim": 32} if version == "7.0" else {}))
    quant, w4 = precision != "bf16", precision == "w4a8"
    mesh = make_mesh(1, tp, devices=[dev] * tp)
    build, build_tp = {
        "7.0": (TM.build_mega_pack, TT.build_mega_pack_tp),
        "6.0": (TM.build_mega_pack_v6, TT.build_mega_pack_tp_v6),
        "5.2": (TM.build_mega_pack_v5, TT.build_mega_pack_tp_v5),
        "5.1": (TM.build_mega_pack_v5, TT.build_mega_pack_tp_v5),
        "4.0": (TM.build_mega_pack_v4, TT.build_mega_pack_tp_v4),
    }[version]
    return tc, build_tp(build(tp_, tc, w4=w4, quant=quant), tc, mesh)


def _tp_close(got, want, precision):
    """bf16: within 1e-4 of the scale (sums in another order); the int
    forms: within 2e-2 (an activation code may flip at a .5 boundary)."""
    for a, b in zip(got, want):
        if precision == "bf16":
            assert _rel(a, b) <= 1e-4
        else:
            torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("precision", ["w8a8", "w4a8", "bf16"])
@pytest.mark.parametrize("version", ["7.0", "6.0"])
def test_tp_shard_kernels_match_ref(cuda_device, version, precision):
    """K10 / K11 (v7) and K12 / K13 (v6) on both shards of a tp=2 mesh on
    one card, each layer, against their plain versions on the same CUDA
    tensors; one launch a call."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    tc, packs = _tp_packs(version, precision, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    c, s = tc.n_embed, tc.head_size
    h_loc = tc.head_count // 2
    x = torch.randn((c,), device=cuda_device, generator=gen) * 0.5
    xx = torch.randn((c,), device=cuda_device, generator=gen) * 0.3
    heads = torch.randn((h_loc, s, s), device=cuda_device, generator=gen) * 0.1
    vf = torch.randn((c // 2,), device=cuda_device, generator=gen) * 0.3
    for pk in packs:
        for l in range(tc.n_layer):
            if version == "7.0":
                n = TT.tp_att_layer.launches
                got = TT.tp_att_layer(pk, l, x, xx, heads, vf, l == 0, tc)
                assert TT.tp_att_layer.launches == n + 1
                _tp_close(got, TT.tp_att_layer_ref(pk, l, x, xx, heads, vf, l == 0, tc), precision)
                n = TT.tp_ffn_layer.launches
                got = TT.tp_ffn_layer(pk, l, x, xx, tc)
                assert TT.tp_ffn_layer.launches == n + 1
                _tp_close(got, TT.tp_ffn_layer_ref(pk, l, x, xx, tc), precision)
            else:
                n = TT.tp_att_layer_v6.launches_by_form[pk["form"]]
                got = TT.tp_att_layer_v6(pk, l, x, xx, heads, tc)
                assert TT.tp_att_layer_v6.launches_by_form[pk["form"]] == n + 1
                _tp_close(got, TT.tp_att_layer_v6_ref(pk, l, x, xx, heads, tc), precision)
                got = TT.tp_ffn_layer_v6(pk, l, x, xx, tc)
                _tp_close(got, TT.tp_ffn_layer_v6_ref(pk, l, x, xx, tc), precision)


def test_tp_ffn_kernel_with_two_tiles(cuda_device):
    """K11 at C=2048, F=8192, tp=2, where the FFN runs in nf=2 tiles, each
    quantized with its own scale."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    tc, packs = _tp_packs("7.0", "w8a8", cuda_device, c=2048)
    assert packs[0]["nf"] == 2
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((2048,), device=cuda_device, generator=gen) * 0.5
    xx = torch.randn((2048,), device=cuda_device, generator=gen) * 0.3
    for pk in packs:
        _tp_close(TT.tp_ffn_layer(pk, 0, x, xx, tc), TT.tp_ffn_layer_ref(pk, 0, x, xx, tc), "w8a8")


# (version, C, tp) of the K12 / K13 grid tests: the small width, and the
# 1.6B (v6) / World 1.5B (v5.2, v4) width at tp = 2 (nf = 2 FFN tiles) and
# tp = 4 (nf = 1)
TP6_GRID_CASES = [("6.0", 256, 2), ("6.0", 2048, 2), ("6.0", 2048, 4), ("5.2", 2048, 2),
                  ("4.0", 2048, 4), ("4.0", 256, 2)]
_PRECISION = {"i8": "w8a8", "i4": "w4a8", "bf16": "bf16"}


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version, c, tp", TP6_GRID_CASES)
def test_tp_v6_kernels_same_bits_on_every_grid(cuda_device, version, c, tp, form):
    """K12 and K13 (v6) and K13's MIX45 form (v5.2, v4) deal each phase's
    rows over the grid but never change how a row is computed: every
    output bit-equal on grids of 132, 64, 33 and 7 blocks, on the first and
    the last shard of a one-layer pack; finite and within the plain
    versions' band (int forms 2e-2, bf16 1e-4 of the scale)."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    tc, packs = _tp_packs(version, _PRECISION[form], cuda_device, c=c, n_layer=1, tp=tp)
    assert packs[0]["nf"] == (2 if (c, tp) == (2048, 2) else 1)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x, xx, fxx = (torch.randn((c,), device=cuda_device, generator=gen) * a for a in (0.5, 0.3, 0.3))
    s = tc.head_size
    for pk in (packs[0], packs[-1]):
        kinds = ("att", "ffn") if version == "6.0" else ("ffn",)
        for kind in kinds:
            fn = TT.tp6_function(pk, kind)
            if kind == "att":
                heads = torch.randn((pk["c_loc"] // s, s, s), device=cuda_device,
                                    generator=gen) * 0.1
                outs = {g: TT.tp6_att_launch(fn, pk, 0, x, xx, heads, tc, g)
                        for g in (132, 64, 33, 7)}
                ref = TT.tp_att_layer_v6_ref(pk, 0, x, xx, heads, tc)
            else:
                outs = {g: TT.tp6_ffn_launch(fn, pk, 0, x, fxx, tc, g)
                        for g in (132, 64, 33, 7)}
                ref = TT.tp_ffn_layer_v6_ref(pk, 0, x, fxx, tc, mix45=version != "6.0")
            for g, out in outs.items():
                assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), (kind, g)
            assert all(bool(torch.isfinite(t).all()) for t in outs[132])
            _tp_close(outs[132], ref, _PRECISION[form])


def test_tp_v6_plan_matches_the_python_plan(cuda_device):
    """K12's, K13's and K11's own stream plans (rwkv_tp_v6_plan: shared
    bytes, stage bytes and count, a block's pieces, the kernel's static
    shared bytes, vector rows a piece) are tp_v6_stream_plan's, in every
    form, at the small width, C=768 and C=2048 at tp = 2 and 4 (nf = 1 and
    2), on several grids."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    for c, tp in ((256, 2), (768, 2), (2048, 2), (2048, 4)):
        c_loc, f_loc = c // tp, 4 * c // tp
        for nf in sorted({TT._ffn_tiles(c, f_loc), 2}):
            for form in TM.FORMS:
                for kind in ("att", "ffn", "ffn7"):
                    for blocks in (132, 64, 33, 7):
                        plan = TT.tp_v6_stream_plan(form, c, c_loc, f_loc, nf, 32, 64, 64, blocks,
                                                    kind)
                        for b in sorted({0, 5, blocks - 1}):
                            got = TT.tp_v6_kernel_plan(form, kind, c, c_loc, f_loc, nf, 32, 64,
                                                       64, blocks, b)
                            assert got == (plan.smem_bytes, plan.stage_bytes, plan.n_stages,
                                           plan.layer_pieces(b), TT.TP6_STATIC_SMEM,
                                           plan.vec_rows), (c, tp, nf, form, kind, blocks, b)


# (version, C, tp) of the K10 / K15 grid tests: the small width, and the
# World 1.5B width at tp = 2 and 4 (v5.1 at tp=4)
TP_ATT_GRID_CASES = [("7.0", 256, 2), ("7.0", 2048, 2), ("7.0", 2048, 4), ("5.2", 256, 2),
                     ("5.2", 2048, 2), ("5.1", 2048, 4)]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version, c, tp", TP_ATT_GRID_CASES)
def test_tp_stream_att_kernels_same_bits_on_every_grid(cuda_device, version, c, tp, form):
    """K10 (v7; reading v_first and writing it) and K15 (v5.2, v5.1) deal
    each phase's rows over the grid but never change how a row is
    computed: every output bit-equal on grids of 132, 64, 33 and 7 blocks,
    on the first and the last shard of a one-layer pack; finite and within
    the plain versions' band (int forms 2e-2, bf16 1e-4 of the scale)."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    # a one-layer pack (v7: two, whose packs take a later layer's value-residual LoRA)
    tc, packs = _tp_packs(version, _PRECISION[form], cuda_device, c=c,
                          n_layer=2 if version == "7.0" else 1, tp=tp)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, xx = (torch.randn((c,), device=cuda_device, generator=gen) * a for a in (0.5, 0.3))
    s = tc.head_size
    for pk in (packs[0], packs[-1]):
        fn = TT.tp6_function(pk, "att")
        heads = torch.randn((pk["c_loc"] // s, s, s), device=cuda_device, generator=gen) * 0.1
        vf = torch.randn((pk["c_loc"],), device=cuda_device, generator=gen) * 0.3
        for first in ((False, True) if version == "7.0" else (None,)):
            if first is None:
                outs = {g: TT.tp5_att_launch(fn, pk, 0, x, xx, heads, tc, g)
                        for g in (132, 64, 33, 7)}
                ref = TT.tp_att_layer_v5_ref(pk, 0, x, xx, heads, tc)
            else:
                outs = {g: TT.tp7_att_launch(fn, pk, 0, x, xx, heads, vf, first, tc, g)
                        for g in (132, 64, 33, 7)}
                ref = TT.tp_att_layer_ref(pk, 0, x, xx, heads, vf, first, tc)
            for g, out in outs.items():
                assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), (first, g)
            assert all(bool(torch.isfinite(t).all()) for t in outs[132])
            _tp_close(outs[132], ref, _PRECISION[form])


def test_tp_stream_att_plan_matches_the_python_plan(cuda_device):
    """K10's own stream plan (rwkv_tp_v7_plan: shared bytes, stage bytes
    and count, a block's pieces, the kernel's static shared bytes, vector
    rows and lora2 runs a piece), K15's (rwkv_tp_v6_plan kinds 2 and 3) and
    K14's (rwkv_tp_v4_plan) are tp_v6_stream_plan's, in every form, at the
    small width, C=768 and C=2048 at tp = 2 and 4, d_lora 32 and 96, v5.1
    and v5.2, on several grids."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    for c, tp in ((256, 2), (768, 2), (2048, 2), (2048, 4)):
        c_loc = c // tp
        for form in TM.FORMS:
            for kind, kw in (("att7", {"d_lora": 32}), ("att7", {"d_lora": 96}),
                             ("att5", {"n_mix": 3}), ("att5", {"n_mix": 4}), ("att4", {})):
                for blocks in (132, 64, 33, 7):
                    plan = TT.tp_v6_stream_plan(form, c, c_loc, 0, 0, 0, 0, 64, blocks, kind, **kw)
                    for b in sorted({0, 5, blocks - 1}):
                        got = TT.tp_v6_kernel_plan(form, kind, c, c_loc, 0, 0, 0, 0, 64, blocks, b,
                                                   **kw)
                        assert got == TT.tp_plan_want(plan, b), (c, tp, form, kind, kw, blocks, b)


# (version, C, tp) of the K11 / K14 grid tests: the small width, and the
# World 1.5B width at tp = 2 (K11: nf = 2 FFN tiles) and tp = 4
TP_K11_K14_GRID_CASES = [("7.0", 256, 2), ("7.0", 2048, 2), ("7.0", 2048, 4), ("4.0", 256, 2),
                         ("4.0", 2048, 2), ("4.0", 2048, 4)]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version, c, tp", TP_K11_K14_GRID_CASES)
def test_tp_k11_k14_same_bits_on_every_grid(cuda_device, version, c, tp, form):
    """K11 (v7's FFN) and K14 (v4's attention, from a seeded and a blank
    state) deal each phase's rows over the grid but never change how a row
    is computed: every output bit-equal on grids of 132, 64, 33 and 7
    blocks, on the first and the last shard of a one-layer pack (v7: two,
    whose packs take a later layer's value-residual LoRA); finite and
    within the plain versions' band (int forms 2e-2, bf16 1e-4 of the
    scale)."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    tc, packs = _tp_packs(version, _PRECISION[form], cuda_device, c=c,
                          n_layer=2 if version == "7.0" else 1, tp=tp)
    if version == "7.0":
        assert packs[0]["nf"] == (2 if (c, tp) == (2048, 2) else 1)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x, xx = (torch.randn((c,), device=cuda_device, generator=gen) * a for a in (0.5, 0.3))
    for pk in (packs[0], packs[-1]):
        c_loc = pk["c_loc"]
        if version == "7.0":
            fn = TT.tp6_function(pk, "ffn")
            runs = [(lambda g: TT.tp7_ffn_launch(fn, pk, 0, x, xx, tc, g),
                     TT.tp_ffn_layer_ref(pk, 0, x, xx, tc))]
        else:
            fn = TT.tp6_function(pk, "att")
            seeded = (torch.randn((c_loc,), device=cuda_device, generator=gen) * 0.3,
                      torch.randn((c_loc,), device=cuda_device, generator=gen).abs() + 1.0,
                      torch.randn((c_loc,), device=cuda_device, generator=gen) * 0.5)
            zero = torch.zeros((c_loc,), device=cuda_device)
            blank = (zero, zero, torch.full((c_loc,), -1e30, device=cuda_device))
            runs = [(lambda g, st=st: TT.tp4_att_launch(fn, pk, 0, x, xx, *st, tc, g),
                     TT.tp_att_layer_v4_ref(pk, 0, x, xx, *st, tc)) for st in (seeded, blank)]
        for run, ref in runs:
            outs = {g: run(g) for g in (132, 64, 33, 7)}
            for g, out in outs.items():
                assert all(torch.equal(a, b) for a, b in zip(out, outs[132])), g
            assert all(bool(torch.isfinite(t).all()) for t in outs[132])
            _tp_close(outs[132], ref, _PRECISION[form])


def _tp45_inputs(tc, dev, seed: int):
    """x, att_xx, ffn_xx and the shard's part of the state (v4: aa, bb, pp
    of c_loc channels, pp of a seeded state; v5: its heads) at tp=2."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, c_loc = tc.n_embed, tc.n_embed // 2
    x, xx, fxx = (torch.randn((c,), device=dev, generator=gen) * a for a in (0.5, 0.3, 0.3))
    if tc.version_major == 4:
        own = (torch.randn((c_loc,), device=dev, generator=gen) * 0.3,
               torch.randn((c_loc,), device=dev, generator=gen).abs() + 1.0,
               torch.randn((c_loc,), device=dev, generator=gen) * 0.5)
    else:
        s = tc.head_size
        own = (torch.randn((c_loc // s, s, s), device=dev, generator=gen) * 0.1,)
    return x, xx, fxx, own


@pytest.mark.parametrize("precision", ["w8a8", "w4a8", "bf16"])
@pytest.mark.parametrize("version", ["5.2", "5.1", "4.0"])
def test_tp_v45_shard_kernels_match_ref(cuda_device, version, precision):
    """K15 (v5.2, v5.1) or K14 (v4) and K13's MIX45 form on both shards of
    a tp=2 mesh on one card (C=256), each layer, against their plain
    versions on the same CUDA tensors (v4 also from a blank state, pp =
    -1e30); one launch a call, two launches bit-identical."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT

    tc, packs = _tp_packs(version, precision, cuda_device)
    x, xx, fxx, own = _tp45_inputs(tc, cuda_device, 1)
    att, att_ref = ((TT.tp_att_layer_v4, TT.tp_att_layer_v4_ref) if version == "4.0"
                    else (TT.tp_att_layer_v5, TT.tp_att_layer_v5_ref))
    states = [own]
    if version == "4.0":
        c_loc = tc.n_embed // 2
        zero = torch.zeros((c_loc,), device=cuda_device)
        states.append((zero, zero, torch.full((c_loc,), -1e30, device=cuda_device)))
    for pk in packs:
        for l in range(tc.n_layer):
            for st in states:
                n = att.launches_by_form[pk["form"]]
                got = att(pk, l, x, xx, *st, tc)
                assert att.launches_by_form[pk["form"]] == n + 1
                assert all(bool(torch.isfinite(t).all()) for t in got)
                _tp_close(got, att_ref(pk, l, x, xx, *st, tc), precision)
                again = att(pk, l, x, xx, *st, tc)
                assert all(torch.equal(a, b) for a, b in zip(got, again))
            n = TT.tp_ffn_layer_v45.launches_by_form[pk["form"]]
            got = TT.tp_ffn_layer_v45(pk, l, x, fxx, tc)
            assert TT.tp_ffn_layer_v45.launches_by_form[pk["form"]] == n + 1
            _tp_close(got, TT.tp_ffn_layer_v6_ref(pk, l, x, fxx, tc, mix45=True), precision)
            again = TT.tp_ffn_layer_v45(pk, l, x, fxx, tc)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("version", ["7.0", "6.0", "5.2", "4.0"])
def test_card_tp_serving_matches_cpu(cuda_device, version):
    """ServingModel(mesh=make_mesh(1, 2, devices=[cuda, cuda]),
    megakernel=True) against the same model on a CPU mesh: from the CPU's
    prefill state, 3 greedy B=1 steps, each launching the attention and
    FFN kernels once per shard and layer (2 layers)."""
    from rwkv_tpu_torch.ops import megakernel_tp as TT
    from rwkv_tpu_torch.parallel.sharding import make_mesh

    tc = synth_config(version, 2, 256, 256, 64)
    tp = synth_params(tc, seed=17, **({"lora_dim": 32} if version == "7.0" else {}))
    gpu = ServingModel((tc, tp), precision="w8a8", megakernel=True,
                       mesh=make_mesh(1, 2, devices=[cuda_device] * 2))
    cpu = ServingModel((tc, tp), precision="w8a8", megakernel=True,
                       mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    att, ffn = {"7.0": (TT.tp_att_layer, TT.tp_ffn_layer),
                "6.0": (TT.tp_att_layer_v6, TT.tp_ffn_layer_v6),
                "5.2": (TT.tp_att_layer_v5, TT.tp_ffn_layer_v45),
                "4.0": (TT.tp_att_layer_v4, TT.tp_ffn_layer_v45)}[version]
    before = (att.launches, ffn.launches)
    lc, sc = cpu.prefill(list(np.random.default_rng(0).integers(0, tc.n_vocab, 20)))
    sg = {k: v.to(cuda_device) for k, v in sc.items()}
    for _ in range(3):
        tok = [int(lc.argmax())]
        lg, sg = gpu.decode(tok, sg)
        lc, sc = cpu.decode(tok, sc)
        lg, lc = lg[0], lc[0]
        torch.testing.assert_close(lg.cpu(), lc, rtol=2e-2, atol=2e-2)
        assert int(lg.argmax()) == int(lc.argmax())
    for k in sc:
        torch.testing.assert_close(sg[k].cpu(), sc[k], rtol=2e-2, atol=2e-2)
    assert (att.launches - before[0], ffn.launches - before[1]) == (3 * 2 * 2, 3 * 2 * 2)


def test_card_tp_serving_on_two_cards(cuda_device):
    """make_mesh(1, 2) on two distinct cards (the default mesh): the shard
    packs land on cuda:0 and cuda:1, the all-reduce copies across them, and
    decode gives bit for bit the logits and state of the same shards on one
    card (the same kernels on the same inputs, summed in the same order)."""
    from rwkv_tpu_torch.parallel.sharding import make_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    tc = synth_config("7.0", 2, 256, 256, 64)
    tp = synth_params(tc, seed=19, lora_dim=32)
    two = ServingModel((tc, tp), precision="w8a8", megakernel=True, mesh=make_mesh(1, 2))
    one = ServingModel((tc, tp), precision="w8a8", megakernel=True,
                       mesh=make_mesh(1, 2, devices=["cuda:0", "cuda:0"]))
    assert [pk["rvecs"].device.index for pk in two._mega_tp] == [0, 1]
    s2, s1 = two.init_state(1), one.init_state(1)
    for tok in (3, 77, 200):
        l2, s2 = two.decode([tok], s2)
        l1, s1 = one.decode([tok], s1)
        assert torch.equal(l2, l1) and all(torch.equal(s2[k], s1[k]) for k in s1)


# -- speculative decoding and the pack cache ----------------------------------

@pytest.mark.parametrize("precision", ["w8a8", "bf16", "f32"])
@pytest.mark.parametrize("version", ["7.0", "6.0", "4.0"])
def test_card_score_and_score_trace_match_cpu(cuda_device, version, precision):
    """score (two sequences of 5 tokens: K1 and K2 / K5 under w8a8) and
    score_trace (K1) on the card against the same calls on the CPU, from
    the CPU's prefill state: logits and states within 2e-2 element-wise
    under w8a8 (an activation code may flip), 1e-4 of the scale under f32
    (sums in another order) and 5e-3 under bf16 (a last-bit difference can
    flip the bf16 rounding of an activation: the band of the CPU tests
    against JAX, tests/test_torch_speculative.py), argmax equal."""
    shape = SMALL if version == "7.0" else (version, 2, 256, 256, 64)
    tc = synth_config(*shape)
    tp = synth_params(tc, seed=23, **({"lora_dim": 32} if version == "7.0" else {}))
    gpu = ServingModel((tc, tp), precision=precision, device=cuda_device)
    cpu = ServingModel((tc, tp), precision=precision, device="cpu")
    _, sc = cpu.prefill(list(range(1, 21)))
    seqs = [[7, 8, 9, 10, 11], [11, 10, 9, 8, 7]]
    two = {k: torch.cat([v, v]) for k, v in sc.items()}
    before = TK.quant_matmul.launches

    def close(a, b):
        if precision == "w8a8":
            torch.testing.assert_close(a.cpu(), b, rtol=2e-2, atol=2e-2)
        else:
            assert _rel(a.cpu(), b) <= (1e-4 if precision == "f32" else 5e-3)

    lg, sg = gpu.score(seqs, {k: v.to(cuda_device) for k, v in two.items()})
    lc, sc2 = cpu.score(seqs, two)
    close(lg, lc)
    assert lg.argmax(-1).tolist() == lc.argmax(-1).tolist()
    for k in sc2:
        close(sg[k], sc2[k])
    tg, trg = gpu.score_trace(seqs[0], {k: v.to(cuda_device) for k, v in sc.items()})
    tcpu, trc = cpu.score_trace(seqs[0], sc)
    close(tg, tcpu)
    assert tg.argmax(-1).tolist() == tcpu.argmax(-1).tolist()
    for k in trc:
        close(trg[k], trc[k])
    if precision == "w8a8":
        assert TK.quant_matmul.launches > before


@pytest.mark.parametrize("precision", ["w8a8", "bf16"])
@pytest.mark.parametrize("loop", ["host", "device"])
def test_card_speculative_greedy_is_exact(cuda_device, loop, precision):
    """Both greedy loops on the card, weak and perfect draft, 32 tokens:
    the target's own greedy stream on the card, K2 launched (the score,
    commit and trace passes' wkv, the chain's too) and under w8a8 K1."""
    from rwkv_tpu_torch.models import speculative as S

    tc = synth_config(*SMALL)
    target = ServingModel((tc, synth_params(tc, seed=3, lora_dim=32)), precision=precision,
                          device=cuda_device)
    dc = synth_config("7.0", 2, 64, 256, 32)
    draft = ServingModel((dc, synth_params(dc, seed=4, lora_dim=32)), precision=precision,
                         device=cuda_device)
    want, _, _ = target.generate(list(range(16)), 32, temperature=0.0)
    fn = S.speculative_generate if loop == "host" else S.speculative_generate_device
    k1, k2 = TK.quant_matmul.launches, TC.wkv7_recurrence.launches
    got, stats = fn(target, draft, list(range(16)), 32, k=4)
    assert got.tolist() == want.tolist(), (got.tolist(), want.tolist(), stats)
    assert TC.wkv7_recurrence.launches > k2
    if precision == "w8a8":
        assert TK.quant_matmul.launches > k1
    got, stats = fn(target, target, list(range(16)), 32, k=4)
    assert got.tolist() == want.tolist() and stats["acceptance_rate"] == 1.0


def test_card_small_passes_give_a_row_the_bits_it_gets_alone(cuda_device):
    """What the speculative loops' exactness rests on: dense products of
    up to 16 rows (``parity.ROW_INVARIANT_ROWS``) give each row the bits
    it gets alone, in f32 and against bf16 weights, stacked too; K2 and K5
    give five tokens in one launch the bits of five one-token launches."""
    from rwkv_tpu_torch.ops.parity import bmm, mm

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(9, 768, generator=gen).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        w = (torch.randn(3, 3072, 768, generator=gen) * 0.02).to(cuda_device, dtype)
        alone = torch.cat([mm(x[i:i + 1], w[0]) for i in range(9)])
        assert torch.equal(mm(x, w[0]), alone) and torch.equal(mm(x[:5], w[0]), alone[:5])
        stacked = torch.cat([bmm(torch.stack([x[i:i + 1]] * 3), w)[2] for i in range(9)])
        assert torch.equal(bmm(torch.stack([x] * 3), w)[2], stacked)
    h, s = 12, 64
    st = torch.randn(h, s, s, generator=gen).to(cuda_device) * 0.1
    r, k, v, b, tf = (torch.randn(5, h, s, generator=gen).to(cuda_device) * 0.1 for _ in range(5))
    w = (torch.rand(5, h, s, generator=gen) * 0.3 + 0.6).to(cuda_device)
    a = -torch.nn.functional.normalize(torch.randn(5, h, s, generator=gen), dim=-1).to(cuda_device)
    for fn, ops, extra in ((TC.wkv7_recurrence, (r, w, k, v, a, b), ()),
                           (TC.wkv6_recurrence, (r, k, v, w), (tf[0],))):
        y5, s5 = fn(st, *ops, *extra)
        ys, s1 = [], st
        for t in range(5):
            y, s1 = fn(s1, *(o[t:t + 1] for o in ops), *extra)
            ys.append(y)
        assert torch.equal(torch.cat(ys), y5) and torch.equal(s1, s5)


@pytest.mark.parametrize("precision", ["w8a8", "w4a8", "bf16"])
def test_card_pack_cache_round_trip_through_k3(cuda_device, tmp_path, precision):
    """A model built with mega_pack_cache writes the pack; a second one
    reads it; both decode through K3 to the same bits."""
    tc = synth_config("7.0", 2, 128, 256, 32)
    tp = synth_params(tc, seed=29, lora_dim=32)
    cache = str(tmp_path / "mega.npz")
    a = ServingModel((tc, tp), precision=precision, megakernel=True, device=cuda_device,
                     mega_pack_cache=cache)
    b = ServingModel((tc, tp), precision=precision, megakernel=True, device=cuda_device,
                     mega_pack_cache=cache)
    assert a._mega_k3 and b._mega_k3
    before = TM.v7_decode_step.launches
    sa, sb = a.init_state(1), b.init_state(1)
    for tok in (3, 77):
        la, sa = a.decode([tok], sa)
        lb, sb = b.decode([tok], sb)
        assert torch.equal(la, lb)
    assert TM.v7_decode_step.launches == before + 4
