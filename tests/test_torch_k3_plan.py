"""K3's stream plan (``ops/megakernel.py::v7_stream_plan``, the kernel's
Layout7 / Plan7 / piece_copy in ``csrc/v7_decode.cu``) on the CPU: every
phase's rows, each head's lora2 rows and the head's V rows are covered once
over the grid, each head goes to one block, every copy is a 16-byte
multiple from a 16-byte aligned offset that fits its stage, shared memory
stays within the block's limit, the copies land on the pack's rows, the
widths K3 takes are the ones it took before it streamed its inputs, and a
published amax (the max of per-block partial maxima, in any order)
quantizes the lora downs, xo and the relu^2 keys exactly as the plain
quantizer does. The card tests compare the kernel's own plan with this one
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops.kernels import quantize_act_plain, unpack_int4

# (C, F, d_lora, H, S, V): the 169M width and the tests' small v7 width
WIDTHS = {"169M": (768, 3072, 64, 12, 64, 65536), "SMALL": (128, 512, 32, 4, 32, 256)}
GRIDS = (1, 7, 33, 66, 114, 132)


def _plan(width, form, blocks, vocab=None):
    c, f, d, h, s, v = WIDTHS[width]
    return TM.v7_stream_plan(form, c, f, d, h, s, vocab or v, blocks)


def _rows_of(name, width, vocab=None):
    c, f, d, _, _, v = WIDTHS[width]
    return {"rkv": 3 * c, "lora1": 4 * d, "out": c, "fk": f, "fv": c,
            "head": vocab or v}[name]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k3_plan_covers_every_row_once(width, form):
    """Over each grid, the blocks' ranges of every phase's rows (and the
    head's V rows, with V a multiple of 4 and not) tile [0, N) in order,
    each in whole 4-row groups, the pieces of a range tile it, and the head
    rows past the last 4-row group are the last block's; phase C's heads go
    to one block each and the lora2 copies of a head cover its 4 S rows
    once; the vector runs of phases A and E cover their rows once,
    vec_rows a piece."""
    c, _, d, h, s, v = WIDTHS[width]
    rb = TM._form_bytes(TM._small_form(form), d)
    for vocab in (v, v + 3):
        for blocks in GRIDS:
            plan = _plan(width, form, blocks, vocab)
            for name in TM.V7_STREAMED:
                seen = np.zeros(_rows_of(name, width, vocab), np.int32)
                for b in range(blocks):
                    r = plan.rows(name, b)
                    assert r.r0 % 4 == 0 and r.r1 % 4 == 0 and r.n >= 1
                    assert r.rb % (16 * r.lpr) == 0
                    for k in range(r.pieces()):
                        c0, c1 = r.piece(k)
                        assert r.r0 <= c0 < c1 <= r.r1
                        seen[c0:c1] += 1
                    if name == "head":
                        t0, t1 = plan.head_tail(b)
                        seen[t0:t1] += 1
                assert (seen == 1).all(), (name, vocab, blocks)
            heads = sorted(x for b in range(blocks) for x in plan.block_heads(b))
            assert heads == list(range(h)), blocks
            b = blocks - 1 if blocks < h else 0
            per = 1 + plan.lora2_pieces()
            assert plan.count("heads", b) == per * len(plan.block_heads(b))
            l2 = np.zeros(4 * c, np.int32)  # the head's lora2 rows, by row of [4C, d]
            for idx in range(1, per):
                for cp in plan.copies(b, 0, "heads", idx):
                    if cp.array == "mats":
                        row0 = (cp.offset - _lora2_at(plan, 0)) // rb
                        l2[row0:row0 + cp.nbytes // rb] += 1
            hh = plan.block_heads(b)[0]
            want = np.zeros(4 * c, np.int32)
            for q in range(4):
                want[q * c + hh * s:q * c + (hh + 1) * s] = 1
            np.testing.assert_array_equal(l2, want)
            for seg, n_rows in (("vec_a", 9), ("vec_e", 4)):
                run = [len(plan.copies(0, 0, seg, i)) for i in range(plan.count(seg, 0))]
                assert sum(run) == n_rows and max(run) <= plan.vec_rows, (seg, run)


def _lora2_at(plan, layer):
    """Byte offset of layer `layer`'s lora2 rows in the flat mats buffer."""
    mo = TM.v7_mat_offsets(plan.form, plan.c, plan.d_lora, plan.f_dim)
    return layer * mo["layer"] + mo["lora2"]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k3_plan_copies_are_aligned_and_fit_their_stage(width, form):
    """Every bulk copy (two layers and the head, three blocks of every
    grid) moves a 16-byte multiple from a 16-byte aligned offset into a
    16-byte aligned place of its stage, within the stage, 32 copies a piece
    at most, and the copies of a piece do not overlap; the ring and the rest
    of the block's shared memory stay within the opt-in limit, less K3's
    static bytes; the ring holds the pieces the consumers hold at once
    (phase A's vector pieces; a head's state and lora2 pieces)."""
    for blocks in GRIDS:
        plan = _plan(width, form, blocks)
        assert plan.smem_bytes <= TM.STREAM_SMEM_LIMIT - TM.V7_STATIC_SMEM
        assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
        assert TM.STREAM_MIN_STAGES <= plan.n_stages <= TM.STREAM_MAX_STAGES
        assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
        assert plan.act_off % 16 == 0 and 2 <= plan.vec_rows <= TM.V7_MAX_VEC_ROWS
        assert 1 <= plan.l2_runs <= 4
        assert max(plan.count("vec_a", 0), 1 + plan.lora2_pieces()) <= plan.n_stages
        for b in sorted({0, blocks // 2, blocks - 1}):
            n = 0
            for _, seg, _, copies in plan.stream(b, 2):
                assert 1 <= len(copies) <= 32
                spans = []
                for cp in copies:
                    assert cp.offset % 16 == 0 and cp.nbytes % 16 == 0, seg
                    assert cp.dst % 16 == 0, seg
                    assert cp.nbytes > 0 and cp.dst + cp.nbytes <= plan.stage_bytes, seg
                    spans.append((cp.dst, cp.dst + cp.nbytes))
                spans.sort()
                assert all(a[1] <= b_[0] for a, b_ in zip(spans, spans[1:])), seg
                n += 1
            assert n == 2 * plan.layer_pieces(b) + plan.head_pieces(b)


def test_k3_plan_at_its_widest():
    """At the widest rows K3 takes (C=1024, F=4096, a lora of 128), the bf16
    form's lora2 runs (16 KB each) go two a piece behind the head's state
    piece, the int forms' four in one; every form keeps four stages and
    phase A's nine vector rows in one piece."""
    for form, runs in (("i8", 4), ("i4", 4), ("bf16", 2)):
        plan = TM.v7_stream_plan(form, 1024, 4096, 128, 16, 64, 65536, 132)
        assert plan.l2_runs == runs and plan.lora2_pieces() == 4 // runs, form
        assert plan.n_stages == 4 and plan.vec_rows == 9 and plan.count("vec_a", 0) == 1
    plan = TM.v7_stream_plan("i8", 768, 3072, 64, 12, 64, 65536, 132)
    assert (plan.n_stages, plan.vec_rows, plan.l2_runs) == (4, 9, 4)


def test_k3_plan_refuses_a_ring_too_small():
    """A width whose pieces leave fewer than STREAM_MIN_STAGES stages is
    refused by the plan (K3's launch refuses it too)."""
    with pytest.raises(ValueError, match="stages"):
        TM.v7_stream_plan("bf16", 16384, 65536, 64, 256, 64, 65536, 132)


# (C, F, d_lora, S, bf16, w4): every width K3 took before it streamed its
# inputs is taken, every other refused, for the same reason
SHAPES = [(768, 3072, 64, 64, False, False), (768, 3072, 64, 64, True, False),
          (768, 3072, 64, 64, False, True), (128, 512, 32, 32, False, False),
          (1024, 4096, 128, 64, True, False), (1024, 4096, 128, 64, False, True),
          (2048, 8192, 64, 64, False, False), (768, 3072, 256, 64, False, False),
          (768, 8192, 64, 64, True, False), (256, 1024, 32, 128, False, False)]


@pytest.mark.parametrize("c,f,d,s,bf16,w4", SHAPES)
def test_k3_takes_the_widths_it_took(c, f, d, s, bf16, w4):
    """decode_shape_error: the 169M and the tests' widths and the widest
    rows of each kind are taken; wider rows than a lane's registers held
    (C=2048, which ServingModel sends to K4 at B=1, d_lora 256, F=8192)
    and heads of 128 are refused with the messages they had."""
    cfg = synth_config("7.0", 1, c, 65536, s)
    err = TM.decode_shape_error(cfg, d, f, w4, bf16=bf16)
    wide = c > 1024 or d > 128 or f > 4096
    if s > 64:
        assert "head sizes" in err
    elif wide:
        assert "16-byte chunks per lane" in err
    else:
        assert err is None


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.mark.parametrize("form", TM.FORMS)
def test_k3_plan_copies_land_on_the_pack_rows(form):
    """Over 7 blocks at the small width (2 layers), the bytes each copy of
    the last layer and the head reads from the flat buffers are the rows
    ``_codes`` gives (int4 unpacked), their row scales -- whole 16-byte
    windows around pieces of any row count --, the ln1 / ln2 / coeff / xk
    vectors, att_in / ffn_in rows, a head's state with its w0, a0, v0, kk,
    ka, ln_x and r_k slices, and its lora2 rows with their scales."""
    tc = synth_config("7.0", 2, 128, 256, 32)
    tp = synth_params(tc, seed=5, lora_dim=32)
    pack = TM.build_mega_pack(tp, tc, w4=form == "i4", quant=form != "bf16")
    dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    c, s, h, d, n_layer = tc.n_embed, tc.head_size, tc.head_count, dp["d_lora"], tc.n_layer
    gen = torch.Generator().manual_seed(1)
    state = {"att_xx": torch.randn((n_layer, c), generator=gen),
             "ffn_xx": torch.randn((n_layer, c), generator=gen),
             "heads": torch.randn((n_layer, h, s, s), generator=gen)}
    flat = {"mats": _bytes(dp["mats"]), "vecs": _bytes(dp["vecs"]),
            "head": _bytes(dp["headbf16" if form == "bf16" else "head8"]),
            "ln_out": _bytes(dp["ln_out"]), "att_in": _bytes(state["att_xx"]),
            "ffn_in": _bytes(state["ffn_xx"]), "heads_in": _bytes(state["heads"])}
    if form != "bf16":
        flat["scales"], flat["head_d"] = _bytes(dp["scales"]), _bytes(dp["head_d"])
    plan = TM.v7_stream_plan(form, c, dp["f_dim"], d, h, s, tc.n_vocab, 7)
    layer = n_layer - 1
    names = {"rkv": "rkv", "lora1": "lora1", "out": "out", "fk": "fk", "fv": "fv"}

    def read(cp):
        return flat[cp.array][cp.offset:cp.offset + cp.nbytes]

    def f32(raw):
        return raw.copy().view(np.float32)

    def as_rows(raw, n, name):
        if form == "bf16":
            return torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(n, -1)
        rows = torch.from_numpy(raw.copy()).view(torch.int8).reshape(n, -1)
        return unpack_int4(rows) if form == "i4" and name in TM.W4_MATS else rows

    vec_rows = {"vec_a": [dp["ln1.weight"][layer], dp["ln1.bias"][layer]]
                + [dp["coeff"][layer, m] for m in range(6)] + [state["att_xx"][layer]],
                "vec_e": [dp["ln2.weight"][layer], dp["ln2.bias"][layer], dp["ffn.x_k"][layer],
                          state["ffn_xx"][layer]]}
    head_vecs = [dp[k][layer] for k in TM.V7_HEAD_VECS]
    n_l2 = 0
    for b in range(7):
        for lay, seg, idx, copies in plan.stream(b, n_layer):
            if lay < layer:
                continue
            if seg in TM.V7_STREAMED:
                c0, c1 = plan.rows(seg, b).piece(idx)
                w0, w1 = c0 & ~3, (c1 + 3) & ~3
                window = copies[1] if len(copies) > 1 else None
                assert (window is not None) == (form != "bf16")
                if seg == "head":
                    want = dp["headbf16" if form == "bf16" else "head8"][c0:c1]
                    got = torch.from_numpy(read(copies[0]).copy()).view(want.dtype)
                    assert torch.equal(got.reshape(c1 - c0, -1), want)
                    if window is not None:
                        np.testing.assert_array_equal(f32(read(window)),
                                                      dp["head_d"][w0:w1].numpy())
                    continue
                got = as_rows(read(copies[0]), c1 - c0, seg)
                assert torch.equal(got, TM._codes(dp, names[seg], layer)[c0:c1]), (seg, b, idx)
                if window is not None:
                    np.testing.assert_array_equal(f32(read(window)),
                                                  dp[seg + "_d"][layer][w0:w1].numpy())
            elif seg == "heads":
                per = 1 + plan.lora2_pieces()
                hh, k = plan.block_heads(b)[idx // per], idx % per
                sl = slice(hh * s, (hh + 1) * s)
                if k == 0:
                    np.testing.assert_array_equal(f32(read(copies[0])).reshape(s, s),
                                                  state["heads"][layer, hh].numpy())
                    for i, (cp, row) in enumerate(zip(copies[1:], head_vecs)):
                        assert cp.dst == 4 * s * s + 4 * s * i
                        np.testing.assert_array_equal(f32(read(cp)), row[sl].numpy())
                    continue
                runs = [q for q in range(4)][(k - 1) * plan.l2_runs:k * plan.l2_runs]
                for j, q in enumerate(runs):
                    want = TM._codes(dp, "lora2", layer)[q * c + hh * s:q * c + (hh + 1) * s]
                    got = as_rows(read(copies[j]), s, "lora2")
                    assert torch.equal(got, want), (b, hh, q)
                    if form != "bf16":
                        np.testing.assert_array_equal(
                            f32(read(copies[len(runs) + j])),
                            dp["lora2_d"][layer][q * c + hh * s:q * c + (hh + 1) * s].numpy())
                    n_l2 += 1
            elif seg in vec_rows:
                want = vec_rows[seg][idx * plan.vec_rows:(idx + 1) * plan.vec_rows]
                for i, (cp, row) in enumerate(zip(copies, want)):
                    assert cp.dst == 4 * c * i
                    np.testing.assert_array_equal(f32(read(cp)), row.numpy(), err_msg=seg)
            else:
                np.testing.assert_array_equal(f32(read(copies[0])),
                                              dp["ln_out"].reshape(-1).numpy())
    assert n_l2 == 4 * h


def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernel's one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    q = np.clip(np.rint(x * inv), -127, 127).astype(np.float32)
    return q, dx


def _published(x: np.ndarray, shares, blocks: int, rng) -> np.float32:
    """The amax a slot holds after every block's atomicMax of its share's
    |x| (as the bits of non-negative floats), in a random order."""
    partial = [max([np.abs(x[a:e]).view(np.uint32).max(initial=0) for a, e in shares(b)],
                   default=np.uint32(0)) for b in range(blocks)]
    slot = np.uint32(0)
    for i in rng.permutation(blocks):
        slot = max(slot, partial[i])
    return np.array([slot], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("blocks", GRIDS)
def test_k3_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """K3's published vectors at the 169M width: each of the four lora
    downs (d=64; each block's share its lora1 rows of the plan; tanh(w) and
    sigmoid(g) bounded), xo (C=768, the heads dealt one a block) and the
    relu^2 keys (F=3072, all non-negative; each block's fk rows): the max
    of per-block partial amaxes equals the whole vector's amax, and the
    codes and scale it gives are bit-equal to ``quantize_act_plain``'s,
    for vectors with zeros, tiny and large values, and an all-zero one."""
    rng = np.random.default_rng(blocks)
    plan = TM.v7_stream_plan("i8", 768, 3072, 64, 12, 64, 65536, blocks)
    d = 64

    def lora1_share(part):
        def share(b):
            r = plan.rows("lora1", b)
            a, e = max(r.r0, part * d), min(r.r1, (part + 1) * d)
            return [(a - part * d, e - part * d)] if a < e else []
        return share

    vectors = [(d, lora1_share(p), p) for p in range(4)]
    vectors.append((768, lambda b: [(hh * 64, hh * 64 + 64) for hh in plan.block_heads(b)],
                    "xo"))
    vectors.append((3072, lambda b: [(plan.rows("fk", b).r0, plan.rows("fk", b).r1)], "fk"))
    for n, share, kind in vectors:
        cases = [rng.standard_normal(n).astype(np.float32),
                 (rng.standard_normal(n) * 1e-38).astype(np.float32), np.zeros(n, np.float32)]
        spiky = rng.standard_normal(n).astype(np.float32)
        spiky[rng.integers(0, n, 7)] = [-0.0, 3e4, -3e4, 1e-45, 0.0, -1e-45, 5.5]
        cases.append(spiky)
        if kind == 0:
            cases = [np.tanh(x) for x in cases]
        elif kind == 2:
            cases = [(1 / (1 + np.exp(-x.astype(np.float64)))).astype(np.float32) for x in cases]
        elif kind == "fk":
            cases = [np.square(np.maximum(x, 0)) for x in cases]
        for x in cases:
            amax = _published(x, share, blocks, rng)
            assert amax == np.abs(x).max(), kind
            q, dx = _codes_from_amax(x, amax)
            q_ref, dx_ref = quantize_act_plain(torch.from_numpy(x)[None])
            assert np.float32(dx) == dx_ref.numpy()[0, 0]
            np.testing.assert_array_equal(q, q_ref.numpy()[0])
