"""K7's stream plan (``ops/megakernel.py::v5_stream_plan``, the kernel's
Layout5 / Plan5 / piece_copy in ``csrc/v5_decode.cu``) on the CPU, for v5.2
(four attention projections) and v5.1 (three): every phase's rows and the
head's are covered once over the grid, every copy is a 16-byte multiple
from a 16-byte aligned offset that fits its stage, shared memory stays
within the block's limit, the ring refuses a width it cannot hold, the
copies land on the pack's rows, and a published amax (the max of per-block
partial maxima, in any order) quantizes exactly as the plain quantizer
does. The card tests compare the kernel's own plan with this one
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops.kernels import quantize_act_plain, unpack_int4

# (C, F, H, S, V): the World 1.5B width, C=768, the tests' small v5 width
WIDTHS = {"1.5B": (2048, 8192, 32, 64, 65536), "C768": (768, 3072, 12, 64, 65536),
          "SMALL5": (256, 1024, 4, 64, 256)}
GRIDS = (1, 7, 33, 66, 114, 132)
N_ATT = (4, 3)  # v5.2, v5.1


def _rows_of(name, width, n_att):
    c, f, _, _, v = WIDTHS[width]
    return {"att": n_att * c, "out": c, "fk": f, "fr": c, "fv": c, "head": v}[name]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k7_plan_covers_every_row_once(width, form):
    """Over each grid, the blocks' ranges of every phase's rows (and the
    head's V rows) tile [0, N) in order, each in whole 4-row groups, and the
    pieces of a range tile it; phase C's heads go to one block each; the
    vector runs of phases A and E cover their rows once, vec_rows a piece."""
    c, f, h, s, v = WIDTHS[width]
    for n_att in N_ATT:
        for blocks in GRIDS:
            plan = TM.v5_stream_plan(form, c, f, h, s, v, blocks, n_att)
            for name in TM.V5_STREAMED:
                seen = np.zeros(_rows_of(name, width, n_att), np.int32)
                for b in range(blocks):
                    r = plan.rows(name, b)
                    assert r.r0 % 4 == 0 and r.r1 % 4 == 0 and r.n >= 1
                    assert r.rb % (16 * r.lpr) == 0
                    for k in range(r.pieces()):
                        c0, c1 = r.piece(k)
                        assert r.r0 <= c0 < c1 <= r.r1
                        seen[c0:c1] += 1
                assert (seen == 1).all(), (name, n_att, blocks)
            heads = sorted(x for b in range(blocks) for x in plan.block_heads(b))
            assert heads == list(range(h)), blocks
            for seg, n_rows in (("vec_a", 3 + n_att), ("vec_e", TM.V5_VEC_E)):
                run = [len(plan.copies(0, 0, seg, i)) for i in range(plan.count(seg, 0))]
                assert sum(run) == n_rows and max(run) <= plan.vec_rows, (seg, run)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k7_plan_copies_are_aligned_and_fit_their_stage(width, form):
    """Every bulk copy (two layers and the head, every block of every grid)
    moves a 16-byte multiple from a 16-byte aligned offset into a 16-byte
    aligned place of its stage, within the stage, 32 copies a piece at
    most; the ring and the rest of the block's shared memory stay within
    the opt-in limit, less K7's static bytes; the ring holds the pieces the
    consumers hold at once (phase A's vector pieces where it folds the
    mixes' amax into the layer norm, at most three otherwise)."""
    c, f, h, s, v = WIDTHS[width]
    for n_att in N_ATT:
        for blocks in GRIDS:
            plan = TM.v5_stream_plan(form, c, f, h, s, v, blocks, n_att)
            assert plan.smem_bytes <= TM.STREAM_SMEM_LIMIT - TM.V5_STATIC_SMEM
            assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
            assert TM.STREAM_MIN_STAGES <= plan.n_stages <= TM.STREAM_MAX_STAGES
            assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
            assert plan.act_off % 16 == 0 and 2 <= plan.vec_rows <= TM.V5_MAX_VEC_ROWS
            held_a = plan.count("vec_a", 0) - (0 if plan.phase_a_fused() else 1)
            assert max(held_a, plan.count("vec_e", 0)) <= plan.n_stages
            largest = 0
            for b in sorted({0, blocks // 2, blocks - 1}):
                n = 0
                for _, seg, _, copies in plan.stream(b, 2):
                    assert 1 <= len(copies) <= 32
                    for cp in copies:
                        assert cp.offset % 16 == 0 and cp.nbytes % 16 == 0, seg
                        assert cp.dst % 16 == 0, seg
                        assert cp.nbytes > 0 and cp.dst + cp.nbytes <= plan.stage_bytes, seg
                        largest = max(largest, cp.nbytes)
                    n += 1
                assert n == 2 * plan.layer_pieces(b) + plan.head_pieces(b)
            assert largest <= plan.stage_bytes


def test_k7_plan_refuses_a_ring_too_small():
    """A width whose pieces leave fewer than STREAM_MIN_STAGES stages is
    refused by the plan and by v5_decode_shape_error (K7's launch refuses
    it too); C=4096 in bf16 still runs, phase A then releasing ln1's piece
    before the mixes' amax in v5.2; a vocabulary that is no multiple of 4
    is refused."""
    with pytest.raises(ValueError, match="stages"):
        TM.v5_stream_plan("bf16", 16384, 65536, 256, 64, 65536, 132)
    cfg = synth_config("5.2", 1, 16384, 256, 64)
    assert "stages" in TM.v5_decode_shape_error(cfg, 65536, form="bf16")
    wide = TM.v5_stream_plan("bf16", 4096, 14336, 64, 64, 65536, 132)
    assert wide.n_stages == 3 and wide.vec_rows == 2 and not wide.phase_a_fused()
    assert TM.v5_stream_plan("bf16", 4096, 14336, 64, 64, 65536, 132, 3).phase_a_fused()
    cfg = synth_config("5.2", 1, 256, 255, 64)
    assert "vocabulary" in TM.v5_decode_shape_error(cfg, 1024)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version", ["5.2", "5.1"])
def test_k7_plan_copies_land_on_the_pack_rows(version, form):
    """Over 7 blocks, at C=256 (2 layers) and C=1024 (1 layer), the bytes
    each copy reads from the flat buffers (the last layer and the head) are
    the rows ``_codes`` gives (int4 unpacked), their row scales -- whole
    16-byte windows around pieces of any row count --, the ln1 / ln2 /
    ln_x / td / tf / attention and FFN mix vectors, att_in / ffn_in rows
    and the head's state."""
    for c, n_layer in ((256, 2), (1024, 1)):
        tc = synth_config(version, n_layer, c, 256, 64)
        tp = synth_params(tc, seed=5)
        pack = TM.build_mega_pack_v5(tp, tc, w4=form == "i4", quant=form != "bf16")
        dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
        s, h, n_att = tc.head_size, tc.head_count, 4 if dp["has_gate"] else 3
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
        plan = TM.v5_stream_plan(form, c, dp["f_dim"], h, s, tc.n_vocab, 7, n_att)
        layer = n_layer - 1

        def read(cp):
            return flat[cp.array][cp.offset:cp.offset + cp.nbytes]

        def f32(raw):
            return raw.copy().view(np.float32)

        def as_rows(raw, n):
            if form == "bf16":
                return torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(n, -1)
            rows = torch.from_numpy(raw.copy()).view(torch.int8).reshape(n, -1)
            return unpack_int4(rows) if form == "i4" else rows

        vec_rows = {"vec_a": [dp["ln1.weight"][layer], dp["ln1.bias"][layer]]
                    + [dp["amix"][layer, m] for m in range(n_att)] + [state["att_xx"][layer]],
                    "vec_e": [dp["ln2.weight"][layer], dp["ln2.bias"][layer], dp["fmix"][layer, 0],
                              dp["fmix"][layer, 1], state["ffn_xx"][layer]]}
        for b in range(7):
            for lay, seg, idx, copies in plan.stream(b, n_layer):
                if lay < layer:
                    continue
                if seg in TM.V5_STREAMED:
                    c0, c1 = plan.rows(seg, b).piece(idx)
                    w0, w1 = c0 & ~3, (c1 + 3) & ~3
                    window = copies[1] if len(copies) > 1 else None
                    assert (window is not None) == (form != "bf16")
                    if seg == "head":
                        want = dp["headbf16" if form == "bf16" else "head8"][c0:c1]
                        raw = read(copies[0])
                        got = (torch.from_numpy(raw.copy()).view(want.dtype).reshape(c1 - c0, -1))
                        assert torch.equal(got, want)
                        if window is not None:
                            np.testing.assert_array_equal(f32(read(window)),
                                                          dp["head_d"][w0:w1].numpy())
                        continue
                    name = "rkvg" if seg == "att" else seg
                    got = as_rows(read(copies[0]), c1 - c0)
                    assert torch.equal(got, TM._codes(dp, name, layer)[c0:c1]), (seg, b, idx)
                    if window is not None:
                        np.testing.assert_array_equal(f32(read(window)),
                                                      dp[name + "_d"][layer][w0:w1].numpy())
                elif seg == "heads":
                    hh = plan.block_heads(b)[idx]
                    np.testing.assert_array_equal(f32(read(copies[0])).reshape(s, s),
                                                  state["heads"][layer, hh].numpy())
                    for cp, key in zip(copies[1:], ("td", "tf", "att.ln_x.weight",
                                                    "att.ln_x.bias")):
                        np.testing.assert_array_equal(
                            f32(read(cp)), dp[key][layer][hh * s:(hh + 1) * s].numpy())
                elif seg in vec_rows:
                    want = vec_rows[seg][idx * plan.vec_rows:(idx + 1) * plan.vec_rows]
                    for i, (cp, row) in enumerate(zip(copies, want)):
                        assert cp.dst == 4 * c * i
                        np.testing.assert_array_equal(f32(read(cp)), row.numpy(), err_msg=seg)
                else:
                    np.testing.assert_array_equal(f32(read(copies[0])),
                                                  dp["ln_out"].reshape(-1).numpy())


def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernel's one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    q = np.clip(np.rint(x * inv), -127, 127).astype(np.float32)
    return q, dx


@pytest.mark.parametrize("blocks", GRIDS)
def test_k7_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """K7's published vectors (xo, C=2048; the relu^2 keys, F=8192, all
    non-negative): the max of per-block partial amaxes -- |x| as the bits
    of non-negative floats, combined in a random order, each block's share
    its rows of the plan (``out`` for xo's heads dealt one a block, ``fk``
    for the keys) -- equals the whole vector's amax, and the codes and scale
    it gives are bit-equal to ``quantize_act_plain``'s, for vectors with
    zeros, tiny and large values, and an all-zero one."""
    rng = np.random.default_rng(blocks)
    plan = TM.v5_stream_plan("i8", 2048, 8192, 32, 64, 65536, blocks)
    for n, share in ((2048, lambda b: [(hh * 64, hh * 64 + 64) for hh in plan.block_heads(b)]),
                     (8192, lambda b: [(plan.rows("fk", b).r0, plan.rows("fk", b).r1)])):
        cases = [rng.standard_normal(n).astype(np.float32),
                 (rng.standard_normal(n) * 1e-38).astype(np.float32), np.zeros(n, np.float32)]
        spiky = rng.standard_normal(n).astype(np.float32)
        spiky[rng.integers(0, n, 7)] = [-0.0, 3e4, -3e4, 1e-45, 0.0, -1e-45, 5.5]
        cases.append(spiky)
        if n == 8192:  # relu^2 keys
            cases = [np.square(np.maximum(x, 0)) for x in cases]
        for x in cases:
            partial = [max([np.abs(x[a:e]).view(np.uint32).max(initial=0) for a, e in share(b)],
                           default=np.uint32(0)) for b in range(blocks)]
            slot = np.uint32(0)
            for i in rng.permutation(blocks):
                slot = max(slot, partial[i])
            amax = np.array([slot], np.uint32).view(np.float32)[0]
            assert amax == np.abs(x).max()
            q, dx = _codes_from_amax(x, amax)
            q_ref, dx_ref = quantize_act_plain(torch.from_numpy(x)[None])
            assert np.float32(dx) == dx_ref.numpy()[0, 0]
            np.testing.assert_array_equal(q, q_ref.numpy()[0])
