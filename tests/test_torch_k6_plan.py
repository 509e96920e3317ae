"""K6's stream plan (``ops/megakernel.py::v6_stream_plan``, the kernel's
Layout6 / Plan6 / piece_copy in ``csrc/v6_decode.cu``) on the CPU: every
phase's rows and the head's are covered once over the grid, every copy is a
16-byte multiple from a 16-byte aligned offset that fits its stage, shared
memory stays within the block's limit, the copies land on the pack's rows,
and a published amax (the max of per-block partial maxima, in any order)
quantizes exactly as the plain quantizer does. The card tests compare the
kernel's own plan with this one (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops.kernels import quantize_act_plain, unpack_int4

# (C, F, d_maa, d_dec, H, S, V): the 1.6B width, C=768, the tests' SMALL6
WIDTHS = {"1.6B": (2048, 8192, 32, 64, 32, 64, 65536), "C768": (768, 3072, 32, 64, 12, 64, 65536),
          "SMALL6": (256, 1024, 32, 64, 4, 64, 256)}
GRIDS = (1, 7, 33, 66, 114, 132)


def _rows_of(name, width):
    c, f, dm, dd, _, _, v = WIDTHS[width]
    return {"maa1": 5 * dm, "maa2": 5 * c, "rkvg": 4 * c, "dw1": dd, "out": c, "fk": f,
            "fr": c, "fv": c, "head": v}[name]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k6_plan_covers_every_row_once(width, form):
    """Over each grid, the blocks' ranges of every phase's rows (and the
    head's V rows) tile [0, N) in order, each in whole 4-row groups, and the
    pieces of a range tile it; phase C's heads go to one block each."""
    c, f, dm, dd, h, s, v = WIDTHS[width]
    for blocks in GRIDS:
        plan = TM.v6_stream_plan(form, c, f, dm, dd, h, s, v, blocks)
        for name in TM.V6_STREAMED:
            seen = np.zeros(_rows_of(name, width), np.int32)
            for b in range(blocks):
                r = plan.rows(name, b)
                assert r.r0 % 4 == 0 and r.r1 % 4 == 0 and r.n >= 1
                assert r.rb % (16 * r.lpr) == 0
                for k in range(r.pieces()):
                    c0, c1 = r.piece(k)
                    assert r.r0 <= c0 < c1 <= r.r1
                    seen[c0:c1] += 1
            assert (seen == 1).all(), (name, blocks)
        heads = sorted(x for b in range(blocks) for x in plan.block_heads(b))
        assert heads == list(range(h)), blocks


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k6_plan_copies_are_aligned_and_fit_their_stage(width, form):
    """Every bulk copy (two layers and the head, every block of every grid)
    moves a 16-byte multiple from a 16-byte aligned offset into a 16-byte
    aligned place of its stage, within the stage; the ring and the rest of
    the block's shared memory stay within the opt-in limit, less K6's
    static bytes; a stage holds the largest single copy."""
    c, f, dm, dd, h, s, v = WIDTHS[width]
    for blocks in GRIDS:
        plan = TM.v6_stream_plan(form, c, f, dm, dd, h, s, v, blocks)
        assert plan.smem_bytes <= TM.V6_SMEM_LIMIT - TM.V6_STATIC_SMEM
        assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
        assert TM.V6_MIN_STAGES <= plan.n_stages <= TM.V6_MAX_STAGES
        assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
        largest = 0
        for b in sorted({0, blocks // 2, blocks - 1}):
            n = 0
            for _, seg, _, copies in plan.stream(b, 2):
                for cp in copies:
                    assert cp.offset % 16 == 0 and cp.nbytes % 16 == 0 and cp.dst % 16 == 0, seg
                    assert cp.nbytes > 0 and cp.dst + cp.nbytes <= plan.stage_bytes, seg
                    largest = max(largest, cp.nbytes)
                n += 1
            assert n == 2 * plan.layer_pieces(b) + plan.head_pieces(b)
        assert largest <= plan.stage_bytes


def test_k6_plan_refuses_a_ring_too_small():
    """A width whose pieces leave fewer than V6_MIN_STAGES stages is
    refused by the plan and by v6_decode_shape_error (K6's launch refuses
    it too)."""
    with pytest.raises(ValueError, match="stages"):
        TM.v6_stream_plan("bf16", 16384, 65536, 32, 64, 256, 64, 65536, 132)
    cfg = synth_config("6.0", 1, 256, 255, 64)
    assert "vocabulary" in TM.v6_decode_shape_error(cfg, 32, 64, 1024)


def _small_dev_pack(form, c, n_layer):
    tc = synth_config("6.0", n_layer, c, 256, 64)
    tp = synth_params(tc, seed=5)
    pack = TM.build_mega_pack_v6(tp, tc, w4=form == "i4", quant=form != "bf16")
    return tc, TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("c, n_layer", [(256, 2), (1024, 1)])
def test_k6_plan_copies_land_on_the_pack_rows(c, n_layer, form):
    """Over 7 blocks, the bytes each copy reads from the flat buffers (the
    last layer and the head) are the rows ``_codes`` gives (int4
    unpacked), their row scales -- whole 16-byte windows around pieces of
    any row count (C=1024's hold 6 fv rows) --, maa2 rows, maa5 / ln /
    ln_x / tdecay / tf vectors, att_in / ffn_in rows and the head's
    state."""
    tc, dp = _small_dev_pack(form, c, n_layer)
    s, h = tc.head_size, tc.head_count
    gen = torch.Generator().manual_seed(1)
    state = {"att_xx": torch.randn((n_layer, c), generator=gen),
             "ffn_xx": torch.randn((n_layer, c), generator=gen),
             "heads": torch.randn((n_layer, h, s, s), generator=gen)}
    flat = {"mats": _bytes(dp["mats"]), "vecs": _bytes(dp["vecs"]), "maa2": _bytes(dp["maa2"]),
            "head": _bytes(dp["headbf16" if form == "bf16" else "head8"]),
            "ln_out": _bytes(dp["ln_out"]), "att_in": _bytes(state["att_xx"]),
            "ffn_in": _bytes(state["ffn_xx"]), "heads_in": _bytes(state["heads"])}
    if form != "bf16":
        flat["scales"], flat["head_d"] = _bytes(dp["scales"]), _bytes(dp["head_d"])
    plan = TM.v6_stream_plan(form, c, dp["f_dim"], dp["d_maa"], dp["d_dec"], h, s, tc.n_vocab, 7)
    layer = n_layer - 1

    def read(cp):
        return flat[cp.array][cp.offset:cp.offset + cp.nbytes]

    def as_rows(raw, name, n):
        if form == "bf16":
            return torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(n, -1)
        rows = torch.from_numpy(raw.copy()).view(torch.int8).reshape(n, -1)
        return unpack_int4(rows) if form == "i4" and name in TM.V6_W4_MATS else rows

    def f32(raw):
        return raw.copy().view(np.float32)

    for b in range(7):
        for lay, seg, idx, copies in plan.stream(b, n_layer):
            if lay < layer:
                continue
            if seg in TM.V6_STREAMED:
                c0, c1 = plan.rows(seg, b).piece(idx)
                w0, w1 = c0 & ~3, (c1 + 3) & ~3
                rows = read(copies[0])
                window = copies[1] if len(copies) > 1 else None
                assert (window is not None) == (form != "bf16" or seg == "maa2")
                if seg == "maa2":
                    want = dp["maa2"][layer][c0:c1].numpy()
                    np.testing.assert_array_equal(f32(rows).reshape(c1 - c0, -1), want)
                    np.testing.assert_array_equal(
                        f32(read(window)), dp["maa5"][layer].reshape(-1)[w0:w1].numpy())
                    continue
                if seg == "head":
                    want = dp["headbf16" if form == "bf16" else "head8"][c0:c1]
                    assert torch.equal(as_rows(rows, seg, c1 - c0), want)
                    if window is not None:
                        np.testing.assert_array_equal(f32(read(window)),
                                                      dp["head_d"][w0:w1].numpy())
                    continue
                got = as_rows(rows, seg, c1 - c0)
                assert torch.equal(got, TM._codes(dp, seg, layer)[c0:c1]), (seg, b, idx)
                if window is not None:
                    np.testing.assert_array_equal(f32(read(window)),
                                                  dp[seg + "_d"][layer][w0:w1].numpy())
            elif seg == "heads":
                hh = plan.block_heads(b)[idx // 2]
                if idx % 2:
                    np.testing.assert_array_equal(f32(read(copies[0])).reshape(s, s),
                                                  state["heads"][layer, hh].numpy())
                    continue
                got = as_rows(read(copies[0]), "dw2", s)
                assert torch.equal(got, TM._codes(dp, "dw2", layer)[hh * s:(hh + 1) * s])
                vecs = [f32(read(cp)) for cp in copies[1:]]
                if form != "bf16":
                    np.testing.assert_array_equal(
                        vecs.pop(0), dp["dw2_d"][layer][hh * s:(hh + 1) * s].numpy())
                for got_v, key in zip(vecs, ("tdecay", "tf", "att.ln_x.weight", "att.ln_x.bias")):
                    np.testing.assert_array_equal(got_v, dp[key][layer][hh * s:(hh + 1) * s].numpy())
            else:
                got = np.concatenate([f32(read(cp)) for cp in copies])
                want = {"ln1": ("ln1.weight", "ln1.bias"), "ln2": ("ln2.weight", "ln2.bias"),
                        "mix_e": ("ffn.time_maa_k", "ffn.time_maa_r"),
                        "mix_a": ("att.time_maa_x",), "ffn_in": (), "ln_out": ()}[seg]
                parts = [dp[k][layer].numpy() for k in want]
                if seg == "mix_a":
                    parts.append(state["att_xx"][layer].numpy())
                elif seg == "ffn_in":
                    parts.append(state["ffn_xx"][layer].numpy())
                elif seg == "ln_out":
                    parts = [dp["ln_out"].reshape(-1).numpy()]
                np.testing.assert_array_equal(got, np.concatenate(parts), err_msg=seg)



def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernel's one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    q = np.clip(np.rint(x * inv), -127, 127).astype(np.float32)
    return q, dx


@pytest.mark.parametrize("blocks", GRIDS)
def test_k6_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """The max of per-block partial amaxes -- |x| as the bits of
    non-negative floats, combined in a random order -- equals the whole
    vector's amax, and the codes and scale it gives are bit-equal to
    ``quantize_act_plain``'s, for vectors with zeros, -0.0, tiny and large
    values, and an all-zero one."""
    rng = np.random.default_rng(blocks)
    n = 8192
    cases = [rng.standard_normal(n).astype(np.float32),
             (rng.standard_normal(n) * 1e-38).astype(np.float32),
             np.zeros(n, np.float32)]
    spiky = rng.standard_normal(n).astype(np.float32)
    spiky[rng.integers(0, n, 7)] = [-0.0, 3e4, -3e4, 1e-45, 0.0, -1e-45, 5.5]
    cases.append(spiky)
    for x in cases:
        g = n // 4
        bounds = [4 * (g * i // blocks) for i in range(blocks + 1)]
        partial = [np.abs(x[a:b]).view(np.uint32).max(initial=0)
                   for a, b in zip(bounds[:-1], bounds[1:])]
        slot = np.uint32(0)
        for i in rng.permutation(blocks):
            slot = max(slot, partial[i])
        amax = np.array([slot], np.uint32).view(np.float32)[0]
        assert amax == np.abs(x).max()
        q, dx = _codes_from_amax(x, amax)
        q_ref, dx_ref = quantize_act_plain(torch.from_numpy(x)[None])
        assert np.float32(dx) == dx_ref.numpy()[0, 0]
        np.testing.assert_array_equal(q, q_ref.numpy()[0])
