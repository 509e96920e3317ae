"""K8's stream plan (``ops/megakernel.py::v4_stream_plan``, the kernel's
Layout4 / Plan4 / piece_copy in ``csrc/v4_decode.cu``) on the CPU: every
phase's rows, the state's channels and the head's V rows are covered once
over the grid, every copy is a 16-byte multiple from a 16-byte aligned
offset that fits its stage, shared memory stays within the block's limit,
the ring holds the vector pieces each phase holds at once, the widths K8
took before it streamed its inputs are still taken, the copies land on the
pack's rows and the state, a published amax (the max of per-block partial
maxima, in any order) quantizes the relu^2 keys exactly as the plain
quantizer does, and the scratch has the kernel's layout. The card tests
compare the kernel's own plan with this one (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops.kernels import quantize_act_plain, unpack_int4

# (C, F, V): the tests' small v4 width, the World 0.1B width, the 1.5B width
# and C=4096 (bf16: two vector rows a stage)
WIDTHS = {"C256": (256, 1024, 256), "0.1B": (768, 3072, 65536), "1.5B": (2048, 8192, 65536),
          "C4096": (4096, 16384, 65536)}
GRIDS = (1, 7, 33, 64, 114, 132)


def _rows_of(name, width, vocab):
    c, f, _ = WIDTHS[width]
    return {"att": 3 * c, "out": c, "fk": f, "fr": c, "fv": c, "head": vocab}[name]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k8_plan_covers_every_row_once(width, form):
    """Over each grid, the blocks' ranges of every phase's rows (and the
    head's V rows, with V a multiple of 4 and not) tile [0, N) in order,
    each in whole 4-row groups, the pieces of a range tile it, and the head
    rows past the last 4-row group are the last block's; phase B's state
    channels tile [0, C) in 4-channel groups; the vector runs of phases A,
    B and E cover their rows once, vec_rows a piece (B's td slice only
    where the block has channels)."""
    c, f, v = WIDTHS[width]
    for vocab in (v, v + 3):
        for blocks in GRIDS:
            plan = TM.v4_stream_plan(form, c, f, vocab, blocks)
            for name in TM.V4_STREAMED:
                seen = np.zeros(_rows_of(name, width, vocab), np.int32)
                for b in range(blocks):
                    r = plan.rows(name, b)
                    assert r.r0 % 4 == 0 and r.r1 % 4 == 0 and r.n >= 1
                    assert r.rb % (16 * r.lpr) == 0
                    for k in range(r.pieces()):
                        c0, c1 = r.piece(k)
                        assert r.r0 <= c0 < c1 <= r.r1
                        seen[c0:c1] += 1
                    t0, t1 = plan.head_tail(b) if name == "head" else (0, 0)
                    seen[t0:t1] += 1
                assert (seen == 1).all(), (name, vocab, blocks)
            channels = np.zeros(c, np.int32)
            for b in range(blocks):
                s0, s1 = plan.channels(b)
                assert s0 % 4 == 0 and s1 % 4 == 0
                channels[s0:s1] += 1
                run = [plan.copies(b, 0, "vec_b", i) for i in range(plan.count("vec_b", b))]
                assert sum(len(cp) for cp in run) == 4 + (s1 > s0)
                assert all(1 <= len(cp) <= plan.vec_rows for cp in run)
            assert (channels == 1).all(), blocks
            for seg, n_rows in (("vec_a", 6), ("vec_e", 5)):
                run = [len(plan.copies(0, 0, seg, i)) for i in range(plan.count(seg, 0))]
                assert sum(run) == n_rows and max(run) <= plan.vec_rows, (seg, run)


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("width", WIDTHS)
def test_k8_plan_copies_are_aligned_and_fit_their_stage(width, form):
    """Every bulk copy (two layers and the head, the first, middle and last
    block of every grid) moves a 16-byte multiple from a 16-byte aligned
    offset into a 16-byte aligned place of its stage, within the stage, 32
    copies a piece at most; the ring and the rest of the block's shared
    memory stay within the opt-in limit, less K8's static bytes; the ring
    holds the vector pieces each of phases A, B and E holds at once."""
    c, f, v = WIDTHS[width]
    for blocks in GRIDS:
        plan = TM.v4_stream_plan(form, c, f, v, blocks)
        assert plan.smem_bytes <= TM.STREAM_SMEM_LIMIT - TM.V4_STATIC_SMEM
        assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
        assert TM.STREAM_MIN_STAGES <= plan.n_stages <= TM.STREAM_MAX_STAGES
        assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
        assert plan.act_off % 16 == 0 and 2 <= plan.vec_rows <= TM.V4_MAX_VEC_ROWS
        assert max(plan.count(s, 0) for s in ("vec_a", "vec_b", "vec_e")) <= plan.n_stages
        for b in sorted({0, blocks // 2, blocks - 1}):
            n = 0
            for _, seg, _, copies in plan.stream(b, 2):
                assert 1 <= len(copies) <= 32
                for cp in copies:
                    assert cp.offset % 16 == 0 and cp.nbytes % 16 == 0, seg
                    assert cp.dst % 16 == 0, seg
                    assert cp.nbytes > 0 and cp.dst + cp.nbytes <= plan.stage_bytes, seg
                n += 1
            assert n == 2 * plan.layer_pieces(b) + plan.head_pieces(b)


def test_k8_plan_refuses_a_ring_too_small_and_takes_the_widths_it_took():
    """A width whose pieces leave fewer than STREAM_MIN_STAGES stages is
    refused by the plan and by v4_decode_shape_error (K8's launch refuses
    it too); every width and vocabulary K8 took before it streamed its
    inputs (C a multiple of 16, or of 32 under int4, any V) is still taken
    in every form, C=4096 in bf16 at two vector rows a piece."""
    with pytest.raises(ValueError, match="stages"):
        TM.v4_stream_plan("bf16", 16384, 65536, 65536, 132)
    cfg = synth_config("4.0", 1, 16384, 256, 64)
    assert "stages" in TM.v4_decode_shape_error(cfg, 65536, form="bf16")
    for c, f in ((16, 64), (256, 1024), (768, 3072), (2048, 8192), (2560, 10240),
                 (4096, 16384)):
        for vocab in (256, 258, 50277, 65536):
            cfg = synth_config("4.0", 1, c, vocab, 64)
            for form in TM.FORMS:
                w4 = form == "i4"
                err = TM.v4_decode_shape_error(cfg, f, w4, form)
                assert err is None or (w4 and c % 32), (c, vocab, form, err)
    wide = TM.v4_stream_plan("bf16", 4096, 16384, 65536, 132)
    assert wide.vec_rows == 2 and wide.count("vec_a", 0) == 3 <= wide.n_stages


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


@pytest.mark.parametrize("form", TM.FORMS)
def test_k8_plan_copies_land_on_the_pack_rows(form):
    """Over 7 blocks, at C=256 (2 layers) and C=1024 (1 layer), the bytes
    each copy reads from the flat buffers (the last layer and the head) are
    the rows ``_codes`` gives (int4 unpacked), their row scales -- whole
    16-byte windows around pieces of any row count --, the ln1 / ln2 /
    attention and FFN mix vectors, tf, td at the block's channels, and the
    att_in / ffn_in / aa / bb / pp rows of the state."""
    for c, n_layer in ((256, 2), (1024, 1)):
        tc = synth_config("4.0", n_layer, c, 256, 64)
        tp = synth_params(tc, seed=5)
        pack = TM.build_mega_pack_v4(tp, tc, w4=form == "i4", quant=form != "bf16")
        dp = TM.device_pack(pack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
        gen = torch.Generator().manual_seed(1)
        state = {k: torch.randn((n_layer, c), generator=gen) for k in TM.V4_STATE_KEYS}
        flat = {"mats": _bytes(dp["mats"]), "vecs": _bytes(dp["vecs"]),
                "head": _bytes(dp["headbf16" if form == "bf16" else "head8"]),
                "ln_out": _bytes(dp["ln_out"]), "att_in": _bytes(state["att_xx"]),
                "ffn_in": _bytes(state["ffn_xx"]), "aa_in": _bytes(state["aa"]),
                "bb_in": _bytes(state["bb"]), "pp_in": _bytes(state["pp"])}
        if form != "bf16":
            flat["scales"], flat["head_d"] = _bytes(dp["scales"]), _bytes(dp["head_d"])
        plan = TM.v4_stream_plan(form, c, dp["f_dim"], tc.n_vocab, 7)
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

        for b in range(7):
            s0, s1 = plan.channels(b)
            vec_rows = {
                "vec_a": [dp["ln1.weight"][layer], dp["ln1.bias"][layer]]
                + [dp["amix"][layer, m] for m in range(3)] + [state["att_xx"][layer]],
                "vec_b": ([dp["td"][layer][s0:s1]] if s1 > s0 else [])
                + [dp["tf"][layer], state["aa"][layer], state["bb"][layer], state["pp"][layer]],
                "vec_e": [dp["ln2.weight"][layer], dp["ln2.bias"][layer], dp["fmix"][layer, 0],
                          dp["fmix"][layer, 1], state["ffn_xx"][layer]]}
            got_vec = {k: [] for k in vec_rows}
            for lay, seg, idx, copies in plan.stream(b, n_layer):
                if lay < layer:
                    continue
                if seg in TM.V4_STREAMED:
                    c0, c1 = plan.rows(seg, b).piece(idx)
                    w0, w1 = c0 & ~3, (c1 + 3) & ~3
                    window = copies[1] if len(copies) > 1 else None
                    assert (window is not None) == (form != "bf16")
                    if seg == "head":
                        want = dp["headbf16" if form == "bf16" else "head8"][c0:c1]
                        raw = read(copies[0])
                        got = torch.from_numpy(raw.copy()).view(want.dtype).reshape(c1 - c0, -1)
                        assert torch.equal(got, want)
                        if window is not None:
                            np.testing.assert_array_equal(f32(read(window)),
                                                          dp["head_d"][w0:w1].numpy())
                        continue
                    name = "rkv" if seg == "att" else seg
                    got = as_rows(read(copies[0]), c1 - c0)
                    assert torch.equal(got, TM._codes(dp, name, layer)[c0:c1]), (seg, b, idx)
                    if window is not None:
                        np.testing.assert_array_equal(f32(read(window)),
                                                      dp[name + "_d"][layer][w0:w1].numpy())
                elif seg in vec_rows:
                    for cp in copies:
                        assert cp.dst % (4 * c) == 0 and cp.dst < 4 * c * plan.vec_rows
                        got_vec[seg].append(f32(read(cp)))
                else:
                    np.testing.assert_array_equal(f32(read(copies[0])),
                                                  dp["ln_out"].reshape(-1).numpy())
            for seg, rows in vec_rows.items():
                assert len(got_vec[seg]) == len(rows), (seg, b)
                for got, want in zip(got_vec[seg], rows):
                    np.testing.assert_array_equal(got, want.numpy(), err_msg=seg)


def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernel's one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    q = np.clip(np.rint(x * inv), -127, 127).astype(np.float32)
    return q, dx


@pytest.mark.parametrize("blocks", GRIDS)
def test_k8_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """K8's published vector, the relu^2 keys (F=3072, all non-negative):
    the max of per-block partial amaxes -- |x| as the bits of non-negative
    floats, combined in a random order, each block's share its fk rows of
    the plan -- equals the whole vector's amax, and the codes and scale it
    gives are bit-equal to ``quantize_act_plain``'s, for vectors with
    zeros, tiny and large values, and an all-zero one."""
    rng = np.random.default_rng(blocks)
    plan = TM.v4_stream_plan("i8", 768, 3072, 65536, blocks)
    n = 3072
    cases = [rng.standard_normal(n).astype(np.float32),
             (rng.standard_normal(n) * 1e-19).astype(np.float32), np.zeros(n, np.float32)]
    spiky = rng.standard_normal(n).astype(np.float32)
    spiky[rng.integers(0, n, 7)] = [-0.0, 3e4, -3e4, 1e-45, 0.0, -1e-45, 5.5]
    cases.append(spiky)
    for x in [np.square(np.maximum(x, 0)) for x in cases]:
        partial = [np.abs(x[plan.rows("fk", b).r0:plan.rows("fk", b).r1]).view(np.uint32)
                   .max(initial=0) for b in range(blocks)]
        slot = np.uint32(0)
        for i in rng.permutation(blocks):
            slot = max(slot, partial[i])
        amax = np.array([slot], np.uint32).view(np.float32)[0]
        assert amax == np.abs(x).max()
        q, dx = _codes_from_amax(x, amax)
        q_ref, dx_ref = quantize_act_plain(torch.from_numpy(x)[None])
        assert np.float32(dx) == dx_ref.numpy()[0, 0]
        np.testing.assert_array_equal(q, q_ref.numpy()[0])


def test_k8_scratch_floats_match_the_layout():
    """``v45_scratch_floats(4, C, F, L)``: x, sigmoid(r) | k | v, sigmoid(fr)
    (5C) and the relu^2 keys (F), then ``V4_AMAX_SLOTS`` slots a layer,
    padded to an even count so the timing build's 8-byte stamps behind them
    stay aligned; the activations alone (L=0) as before K8 published its
    amax."""
    for c, f in ((256, 1024), (768, 3072), (2048, 8192)):
        assert TM.v45_scratch_floats(4, c, f) == 5 * c + f
        for n_layer in (1, 2, 3, 12, 24):
            n = TM.v45_scratch_floats(4, c, f, n_layer)
            assert n % 2 == 0
            assert n - (5 * c + f) == TM.V4_AMAX_SLOTS * n_layer + n_layer % 2
