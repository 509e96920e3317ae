"""The stream plans of the TP shard kernels K12, K13, K15, K10, K11 and K14
(``ops/megakernel_tp.py::tp_v6_stream_plan``, kinds "att", "ffn", "att5",
"att7", "ffn7", "att4"; the kernels' AttLayout / AttPlan / att_copy and
FfnLayout / FfnPlan / ffn_copy in ``csrc/tp_v6.cu``, K10's in
``csrc/tp_v7.cu``, K14's Att4Layout / Att4Plan / att4_copy in
``csrc/tp_v45.cu``) on the CPU: every phase's rows are covered once over
the grid in whole 4-row groups, the per-head phase's heads go one to a
block (K14: its channels in 4-channel groups), every copy is a 16-byte
multiple from a 16-byte aligned offset that fits its stage, shared memory
stays within the block's limit, the copies land on the shard pack's rows
(v6, v7, v5.1 / v5.2, v4, and the v5.2 / v4 packs K13's MIX45 form reads),
a published amax (per-block partial maxima in any order) quantizes exactly
as the plain quantizer does, the ctypes argument counts are the C entries'
and the plans refuse what the kernels refuse. The card tests compare the
kernels' own plans with these (``tests/test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops import megakernel_tp as TT
from rwkv_tpu_torch.ops.kernels import quantize_act_plain, unpack_int4
from rwkv_tpu_torch.parallel.sharding import make_mesh

# (C, F, d_maa, d_dec, S): the v6 1.6B width (the v5.2 / v4 World 1.5B FFN
# width is the same C and F), C=768, the tests' small width
WIDTHS = {"1.6B": (2048, 8192, 32, 64, 64), "C768": (768, 3072, 32, 64, 64),
          "SMALL": (256, 1024, 32, 64, 64)}
GRIDS = (1, 7, 33, 66, 132)
KINDS = ("att", "ffn", "att5", "att7", "ffn7", "att4")
FFN_KINDS = ("ffn", "ffn7")
HEAD_KINDS = ("att", "att5", "att7")
# K15's mixes (v5.1, v5.2) and K10's LoRA widths (the tests', World 1.5B's)
EXTRA = {"att5": [{"n_mix": 3}, {"n_mix": 4}], "att7": [{"d_lora": 32}, {"d_lora": 96}]}


def _plans(width: str, tp: int, kind: str, form: str):
    """The plan on every grid: K12 / K13 / K11 / K14 at the shard's own
    tile count and at nf=2, K15 with 3 and 4 mixes, K10 at d_lora 32 and
    96."""
    c, f, dm, dd, s = WIDTHS[width]
    c_loc, f_loc = c // tp, f // tp
    for nf in sorted({TT._ffn_tiles(c, f_loc), 2}):
        for kw in EXTRA.get(kind, [{}]):
            for blocks in GRIDS:
                yield TT.tp_v6_stream_plan(form, c, c_loc, f_loc, nf, dm, dd, s, blocks, kind,
                                           **kw)
        if kind in EXTRA:
            break


def _n_rows(plan, name: str) -> int:
    return plan._spec(name)[0]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("width", WIDTHS)
def test_tp6_plan_covers_every_row_once(width, tp, kind, form):
    """Over each grid, the blocks' ranges of every phase's rows tile
    [0, N) in order, each in whole 4-row groups, and the pieces of a range
    tile it (K13's and K11's fv rows once a tile); K12's, K15's and K10's
    heads go one to a block, each head to exactly one, with its pieces;
    K14's channels (whose state a block writes) tile [0, C/tp) in whole
    4-channel groups."""
    for plan in _plans(width, tp, kind, form):
        names = plan.STREAMED + (("fv",) if kind in FFN_KINDS else ())
        for name in names:
            seen = np.zeros(_n_rows(plan, name), np.int32)
            for b in range(plan.blocks):
                r = plan.rows(name, b)
                assert r.r0 % 4 == 0 and r.r1 % 4 == 0 and r.n >= 1
                assert r.rb % (16 * r.lpr) == 0
                for k in range(r.pieces()):
                    c0, c1 = r.piece(k)
                    assert r.r0 <= c0 < c1 <= r.r1
                    seen[c0:c1] += 1
            assert (seen == 1).all(), (name, plan.blocks)
        if kind == "att4":
            seen = np.zeros(plan.c_loc, np.int32)
            for b in range(plan.blocks):
                s0, s1 = plan.channels(b)
                assert s0 % 4 == 0 and s1 % 4 == 0 and s0 <= s1
                seen[s0:s1] += 1
            assert (seen == 1).all() and plan.n_heads == 0
        elif kind in HEAD_KINDS:
            heads = [h for b in range(plan.blocks) for h in plan.block_heads(b)]
            assert sorted(heads) == list(range(plan.n_heads))
            per = 1 + -(-4 // plan.l2_runs) if kind == "att7" else {"att": 2, "att5": 1}[kind]
            assert all(plan.count("heads", b) == per * len(plan.block_heads(b))
                       for b in range(plan.blocks))
        else:
            assert all(plan.count("fv", b) == plan.nf * plan.rows("fv", b).pieces()
                       for b in range(plan.blocks))


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("width", WIDTHS)
def test_tp6_plan_copies_are_aligned_and_fit_their_stage(width, tp, kind, form):
    """Every bulk copy of every piece (the first, a middle and the last
    block of each grid) moves a 16-byte multiple from a 16-byte aligned
    offset into a 16-byte aligned place of its stage, within the stage;
    every piece has at least one copy; the ring and the rest of the block's
    shared memory stay within the opt-in limit, less the kernels' static
    bytes; phase A's vector pieces fit the ring at once, and so do a
    head's pieces (K10: its state piece and its lora2 runs)."""
    for plan in _plans(width, tp, kind, form):
        assert plan.smem_bytes <= TM.STREAM_SMEM_LIMIT - TT.TP6_STATIC_SMEM
        assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
        assert TM.STREAM_MIN_STAGES <= plan.n_stages <= TM.STREAM_MAX_STAGES
        assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
        assert plan.act_off % 16 == 0 and plan.bar_off % 16 == 0
        assert 2 <= plan.vec_rows and plan.count("vec", 0) <= plan.n_stages
        assert plan.head_pieces <= plan.n_stages and (kind != "att7" or 1 <= plan.l2_runs <= 4)
        for b in sorted({0, plan.blocks // 2, plan.blocks - 1}):
            n = 0
            for _, seg, _, copies in plan.stream(b, 1):
                assert copies, seg
                for cp in copies:
                    assert cp.offset % 16 == 0 and cp.nbytes % 16 == 0 and cp.dst % 16 == 0, seg
                    assert cp.nbytes > 0 and cp.dst + cp.nbytes <= plan.stage_bytes, seg
                n += 1
            assert n == plan.layer_pieces(b)


def test_tp6_plan_refuses_what_the_kernels_refuse():
    """Widths whose pieces leave fewer than the ring's minimum stages, more
    FFN tiles than K13 publishes an amax for, or a head size K12's phase C
    cannot take are refused by the plan and by the shape errors that
    build_mega_pack_tp_v6 / _v5 / _v4 call."""
    with pytest.raises(ValueError, match="stages"):
        TT.tp_v6_stream_plan("bf16", 16384, 8192, 32768, 8, 32, 64, 64, 132, "ffn")
    with pytest.raises(ValueError, match="tiles"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, TT.TP6_MAX_TILES * 2, 32, 64, 64, 132, "ffn")
    with pytest.raises(ValueError, match="head size"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 32, 64, 128, 132, "att")
    cfg = synth_config("6.0", 1, 16384, 256, 64)
    assert "stages" in TT.tp_shape_error_v6(cfg, 1, 32, 64, 4 * 16384, form="bf16")
    cfg = synth_config("4.0", 1, 16384, 256, 64)
    assert "tiles" in TT.tp_shape_error_v4(cfg, 4, 4 * 16384, form="bf16")
    assert TT.tp_shape_error_v6(synth_config("6.0", 1, 2048, 256, 64), 2, 32, 64, 8192) is None


@pytest.mark.parametrize("kind", ("att5", "att7"))
def test_tp_stream_att_plans_refuse_what_the_kernels_refuse(kind):
    """K15 and K10: a head size their per-head phase cannot take, K15 with
    other than 3 or 4 mixes, K10 with a LoRA width off the 16-byte rows,
    and widths whose activations leave the ring too few stages (in bf16 at
    C=16384, on one shard) are refused by the plans and by the shape errors
    that build_mega_pack_tp / _v5 call; the World 1.5B widths pass."""
    kw = {"n_mix": 4} if kind == "att5" else {"d_lora": 96}
    with pytest.raises(ValueError, match="head size"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 0, 0, 0, 0, 128, 132, kind, **kw)
    with pytest.raises(ValueError, match="mixes" if kind == "att5" else "d_lora"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 0, 0, 0, 0, 64, 132, kind,
                             **({"n_mix": 5} if kind == "att5" else {"d_lora": 24}))
    with pytest.raises(ValueError, match="stages"):
        TT.tp_v6_stream_plan("bf16", 16384, 16384, 0, 0, 0, 0, 64, 132, kind, **kw)
    if kind == "att5":
        cfg = synth_config("5.2", 1, 16384, 256, 64)
        assert "stages" in TT.tp_shape_error_v5(cfg, 1, 4 * 16384, form="bf16")
        assert TT.tp_shape_error_v5(synth_config("5.1", 1, 2048, 256, 64), 2, 8192) is None
    else:
        cfg = synth_config("7.0", 1, 16384, 256, 64)
        assert "stages" in TT.tp_shape_error(cfg, 1, 96, 4 * 16384, form="bf16")
        assert TT.tp_shape_error(synth_config("7.0", 1, 2048, 256, 64), 2, 96, 8192) is None


def test_tp_ffn7_and_att4_plans_refuse_what_the_kernels_refuse():
    """K11 (the v7 FFN) refuses as K13 does: more tiles than it publishes an
    amax for, tiles off the 16-byte rows, activations that leave the ring
    too few stages; K14 refuses a shard width off the 16-byte rows, wider
    than C, and activations that leave too few stages (bf16 at C=8192);
    the shape errors build_mega_pack_tp / _v4 call report them, and the
    World 1.5B widths pass."""
    with pytest.raises(ValueError, match="tiles"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, TT.TP6_MAX_TILES * 2, 0, 0, 64, 132, "ffn7")
    with pytest.raises(ValueError, match="tiles"):
        TT.tp_v6_stream_plan("i8", 2048, 1024, 4104, 1, 0, 0, 64, 132, "ffn7")
    with pytest.raises(ValueError, match="stages"):
        TT.tp_v6_stream_plan("bf16", 16384, 8192, 32768, 8, 0, 0, 64, 132, "ffn7")
    with pytest.raises(ValueError, match="stages"):
        TT.tp_v6_stream_plan("bf16", 8192, 2048, 0, 0, 0, 0, 0, 132, "att4")
    for c, c_loc in ((2048, 1000), (1024, 2048)):
        with pytest.raises(ValueError, match="K14 cannot take"):
            TT.tp_v6_stream_plan("i8", c, c_loc, 0, 0, 0, 0, 0, 132, "att4")
    assert "tiles" in TT.tp_shape_error(synth_config("7.0", 1, 2048, 256, 64), 2, 96, 262144)
    assert "stages" in TT.tp_shape_error_v4(synth_config("4.0", 1, 8192, 256, 64), 4, 32768,
                                            form="bf16")
    assert TT.tp_shape_error(synth_config("7.0", 1, 2048, 256, 64), 2, 96, 8192) is None
    assert TT.tp_shape_error_v4(synth_config("4.0", 1, 2048, 256, 64), 2, 8192) is None


def _shard_packs(version: str, form: str, nf, monkeypatch):
    """Both shards of a one-layer C=256 model (v7: two, the packs take the
    value-residual LoRA of a later layer) at tp=2 on the CPU, cut into `nf`
    FFN tiles (None: the shard's own count)."""
    if nf is not None:
        monkeypatch.setattr(TT, "_ffn_tiles", lambda c, f_loc: nf)
    tc = synth_config(version, 2 if version == "7.0" else 1, 256, 256, 64)
    params = synth_params(tc, seed=5, **({"lora_dim": 32} if version == "7.0" else {}))
    build = {"7.0": TM.build_mega_pack, "6.0": TM.build_mega_pack_v6,
             "5.2": TM.build_mega_pack_v5, "5.1": TM.build_mega_pack_v5,
             "4.0": TM.build_mega_pack_v4}[version]
    build_tp = {"7.0": TT.build_mega_pack_tp, "6.0": TT.build_mega_pack_tp_v6,
                "5.2": TT.build_mega_pack_tp_v5, "5.1": TT.build_mega_pack_tp_v5,
                "4.0": TT.build_mega_pack_tp_v4}[version]
    base = build(params, tc, w4=form == "i4", quant=form != "bf16")
    return tc, build_tp(base, tc, make_mesh(1, 2, devices=["cpu", "cpu"]))


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy().reshape(-1)


def _as_rows(raw, pk, name: str, n: int, form: str):
    """Raw bytes of n rows of matrix `name` as ``_codes`` gives them."""
    if form == "bf16":
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(n, -1)
    rows = torch.from_numpy(raw.copy()).view(torch.int8).reshape(n, -1)
    if pk["w4"] and name in TT._W4_MATS[pk["version"]]:
        return unpack_int4(rows)
    return rows


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("version, kind, nf", [("6.0", "att", None), ("6.0", "ffn", None),
                                               ("6.0", "ffn", 2), ("5.2", "ffn", 2),
                                               ("4.0", "ffn", None), ("7.0", "att7", None),
                                               ("5.2", "att5", None), ("5.1", "att5", None),
                                               ("7.0", "ffn7", None), ("7.0", "ffn7", 2),
                                               ("4.0", "att4", None)])
def test_tp6_plan_copies_land_on_the_shard_rows(version, kind, nf, form, monkeypatch):
    """Over 7 blocks, the bytes each copy reads from layer 0 of a shard
    pack's tensors (and the launch's inputs) are the rows ``_codes`` gives
    (int4 unpacked) of every streamed matrix and fv tile, their row scales'
    16-byte windows, maa2 rows with their maa5 window, the vector rows of
    phase A (v6's ln / mixes, v7's ln1 and six coefficient rows, v7's ln2
    and x_k (K11), v5's and v4's ln1 and attention mixes, and for v5.2 / v4
    the ln2 and FFN mix rows K13's MIX45 form reads at RVec6's rows), each
    head's dw2 rows, scales, decay / bonus / ln_x slices and state (K12),
    state with td / tf / ln_x slices (K15), state with its eight slices and
    v_first (unless written: K10 with `first`), K10's lora2 runs with their
    scales, and K14's phase-B rows: td at the block's channels, tf and the
    old aa, bb, pp."""
    tc, packs = _shard_packs(version, form, nf, monkeypatch)
    c, s = tc.n_embed, tc.head_size
    gen = torch.Generator().manual_seed(1)
    x_in = torch.randn((c,), generator=gen)
    for pk in packs:
        c_loc, f_loc = pk["c_loc"], pk["f_dim"] // pk["tp"]
        plan = TT.tp_pack_plan(pk, "ffn" if kind in FFN_KINDS else "att", tc, 7)
        assert plan.kind == kind
        heads = torch.randn((max(c_loc // max(s, 1), 1), s, s), generator=gen)
        vf = torch.randn((c_loc,), generator=gen)
        state = {k: torch.randn((c_loc,), generator=gen) for k in ("aa_in", "bb_in", "pp_in")}
        mats = (TT._ATT6_MATS + TT._FFN6_MATS + TT._ATT7_MATS + TT._ATT5_MATS + TT._FFN7_MATS
                + TT._ATT4_MATS)
        flat = {k: _bytes(v[0]) for k, v in pk.items()
                if isinstance(v, torch.Tensor) and v.dim() >= 1 and k in mats and v is not None}
        flat.update(att_in=_bytes(x_in), ffn_in=_bytes(x_in), heads_in=_bytes(heads),
                    vf=_bytes(vf), **{k: _bytes(v) for k, v in state.items()})
        for plan in [plan] + ([dataclasses.replace(plan, first=True)] if kind == "att7" else []):
            _land_on_rows(plan, pk, kind, form, x_in, heads, vf, s, f_loc, flat, state)


def _land_on_rows(plan, pk, kind, form, x_in, heads, vf, s, f_loc, flat, state):
    """The checks of test_tp6_plan_copies_land_on_the_shard_rows on one
    shard pack's plan."""

    def read(cp):
        return flat[cp.array][cp.offset:cp.offset + cp.nbytes]

    def f32(raw):
        return raw.copy().view(np.float32)

    ft = f_loc // pk["nf"]
    for b in range(7):
        fv_seen = 0
        for _, seg, idx, copies in plan.stream(b, 1):
            if seg == "vec":
                got = np.concatenate([f32(read(cp)) for cp in copies])
                keys = plan.vecs[idx * plan.vec_rows:(idx + 1) * plan.vec_rows]
                want = [x_in.numpy() if row is None else pk["rvecs"][0, row].numpy()
                        for _, row in keys]
                np.testing.assert_array_equal(got, np.concatenate(want))
                continue
            if seg == "vec_b":  # K14: td[s0:s1], tf, aa, bb, pp at slots 4 c j
                s0, s1 = plan.channels(b)
                rows = [pk["td"][0][s0:s1], pk["tf"][0]] + [state[k] for k in
                                                              ("aa_in", "bb_in", "pp_in")]
                run = range(idx * plan.vec_rows, min((idx + 1) * plan.vec_rows, len(rows)))
                want = [(rows[j].numpy(), 4 * plan.c * (j - idx * plan.vec_rows)) for j in run
                        if rows[j].numel()]
                assert len(copies) == len(want)
                for cp, (w, dst) in zip(copies, want):
                    assert cp.dst == dst
                    np.testing.assert_array_equal(f32(read(cp)), w)
                continue
            if seg == "heads" and kind != "att":
                _head_copies(plan, pk, kind, form, b, idx, copies, heads, vf, s, read)
                continue
            if seg == "heads":
                h = plan.block_heads(b)[idx // 2]
                if idx % 2:
                    np.testing.assert_array_equal(f32(read(copies[0])).reshape(s, s),
                                                  heads[h].numpy())
                    continue
                got = _as_rows(read(copies[0]), pk, "dw2", s, form)
                assert torch.equal(got, TT._codes(pk, "dw2", 0)[h * s:(h + 1) * s])
                vecs = [f32(read(cp)) for cp in copies[1:]]
                if form != "bf16":
                    np.testing.assert_array_equal(
                        vecs.pop(0), pk["dw2_d"][0][h * s:(h + 1) * s].numpy())
                for got_v, key in zip(vecs, ("tdecay", "tf", "att.ln_x.weight",
                                             "att.ln_x.bias")):
                    np.testing.assert_array_equal(got_v, pk[key][0][h * s:(h + 1) * s].numpy())
                continue
            if seg == "fv":
                r = plan.rows("fv", b)
                t, k = divmod(idx, r.pieces())
                c0, c1 = r.piece(k)
                codes = TT._codes(pk, "fv", 0)[t][c0:c1]
                fv_seen += 1
            else:
                c0, c1 = plan.rows(seg, b).piece(idx)
                codes = None
            w0, w1 = c0 & ~3, (c1 + 3) & ~3
            window = copies[1] if len(copies) > 1 else None
            assert (window is not None) == (form != "bf16" or seg == "maa2")
            if seg == "maa2":
                np.testing.assert_array_equal(f32(read(copies[0])).reshape(c1 - c0, -1),
                                              pk["maa2"][0][c0:c1].numpy())
                maa5 = pk["rvecs"][0, 7:12].reshape(-1)
                np.testing.assert_array_equal(f32(read(window)), maa5[w0:w1].numpy())
                continue
            if codes is None:
                codes = TT._codes(pk, seg, 0).reshape(-1, TT._codes(pk, seg, 0).shape[-1])
                codes = codes[c0:c1]
            got = _as_rows(read(copies[0]), pk, seg, c1 - c0, form)
            assert torch.equal(got, codes), (seg, b, idx)
            if window is not None:
                np.testing.assert_array_equal(f32(read(window)),
                                              pk[seg + "_d"][0].reshape(-1)[w0:w1].numpy())
        if kind in FFN_KINDS:
            assert fv_seen == pk["nf"] * plan.rows("fv", b).pieces()
    assert ft * pk["nf"] == f_loc


def _head_copies(plan, pk, kind, form, b, idx, copies, heads, vf, s, read):
    """Piece idx of block b's heads segment of K15 ("att5": the state, then
    td, tf, ln_x w, ln_x b) or K10 ("att7": the state, its eight vector
    slices, v_first unless `first`; then its lora2 runs and their scales)."""
    def f32(raw):
        return raw.copy().view(np.float32)

    h, k = divmod(idx, plan.head_pieces)
    h = plan.block_heads(b)[h]
    ch = slice(h * s, (h + 1) * s)
    if k == 0:
        np.testing.assert_array_equal(f32(read(copies[0])).reshape(s, s), heads[h].numpy())
        keys = TT.TP5_LVECS if kind == "att5" else TT.TP_LVECS
        want = [pk[key][0][ch].numpy() for key in keys]
        if kind == "att7" and not plan.first:
            want.append(vf[ch].numpy())
        assert len(copies) == 1 + len(want)
        for cp, w in zip(copies[1:], want):
            np.testing.assert_array_equal(f32(read(cp)), w)
        return
    q0 = (k - 1) * plan.l2_runs
    q1 = min(q0 + plan.l2_runs, 4)
    rows = TT._codes(pk, "lora2", 0)
    assert len(copies) == (q1 - q0) * (1 if form == "bf16" else 2)
    for j, q in enumerate(range(q0, q1)):
        got = _as_rows(read(copies[j]), pk, "lora2", s, form)
        assert torch.equal(got, rows[q, ch]), (b, idx, q)
        if form != "bf16":
            np.testing.assert_array_equal(f32(read(copies[q1 - q0 + j])),
                                          pk["lora2_d"][0][q, ch].numpy())


def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernels' one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    return np.clip(np.rint(x * inv), -127, 127).astype(np.float32), dx


@pytest.mark.parametrize("blocks", GRIDS)
def test_tp6_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """K13's and K11's relu^2 keys (two tiles at the 1.6B / World 1.5B
    width, tp=2), K12's five mixes, K10's four lora downs (d_lora 96, rows
    dealt from the last block) and the xo of K10's / K15's heads: each
    block's partial amax
    over the rows (heads) its plan gives it (a block's fk rows may straddle
    two tiles), as float bits combined in a random order per slot, equals
    the tile's / mix's / down's / xo's amax, and the codes and scale it
    gives are bit-equal to ``quantize_act_plain``'s (vectors with zeros,
    -0.0, tiny and large values)."""
    rng = np.random.default_rng(blocks)
    ffn = TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 32, 64, 64, blocks, "ffn")
    att = TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 32, 64, 64, blocks, "att")
    att7 = TT.tp_v6_stream_plan("i8", 2048, 1024, 0, 0, 0, 0, 64, blocks, "att7", d_lora=96)
    att5 = TT.tp_v6_stream_plan("i8", 2048, 1024, 0, 0, 0, 0, 64, blocks, "att5", n_mix=4)
    ffn7 = TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 0, 0, 64, blocks, "ffn7")
    keys = np.square(np.maximum(rng.standard_normal(4096), 0)).astype(np.float32)
    keys[rng.integers(0, 4096, 5)] = [0.0, 3e4, 1e-45, 5.5, 0.0]
    mixes = rng.standard_normal(5 * 2048).astype(np.float32)
    mixes[rng.integers(0, 5 * 2048, 6)] = [-0.0, 3e4, -3e4, 1e-45, -1e-45, 0.0]
    downs = np.tanh(rng.standard_normal(4 * 96)).astype(np.float32)
    downs[rng.integers(0, 4 * 96, 4)] = [-0.0, 1.0, -1e-45, 0.0]
    xo = (rng.standard_normal(1024) * 3).astype(np.float32)
    xo[rng.integers(0, 1024, 3)] = [-0.0, 1e-45, -2e3]
    cases = ((ffn, keys, "fk", 2048), (att, mixes, "maa2", 2048), (att7, downs, "lora1", 96),
             (att7, xo, "heads", 1024), (att5, xo, "heads", 1024), (ffn7, keys, "fk", 2048))
    for plan, vec, name, n in cases:
        slots = vec.size // n
        partial = np.zeros((blocks, slots), np.uint32)
        for b in range(blocks):
            if name == "heads":
                s = plan.head_size
                rows = [c for h in plan.block_heads(b) for c in range(h * s, (h + 1) * s)]
            else:
                r = plan.rows(name, b)
                rows = range(r.r0, r.r1)
            for row in rows:
                bits = np.abs(vec[row:row + 1]).view(np.uint32)[0]
                partial[b, row // n] = max(partial[b, row // n], bits)
        for m in range(slots):
            slot = np.uint32(0)
            for b in rng.permutation(blocks):
                slot = max(slot, partial[b, m])
            amax = np.array([slot], np.uint32).view(np.float32)[0]
            part = vec[m * n:(m + 1) * n]
            assert amax == np.abs(part).max()
            q, dx = _codes_from_amax(part, amax)
            q_ref, dx_ref = quantize_act_plain(torch.from_numpy(part)[None])
            assert np.float32(dx) == dx_ref.numpy()[0, 0]
            np.testing.assert_array_equal(q, q_ref.numpy()[0])


@pytest.mark.parametrize("kind", KINDS)
def test_tp6_argument_counts_match_the_c_entries(kind):
    """TP_ARGS (the ctypes signature of the stream kernels' C launch
    entries: pointers, then ints with the grid, then the stream) count the
    parameters of the entries of ``csrc/tp_v6.cu`` (K12, K13, K15, K11),
    ``csrc/tp_v7.cu`` (K10) and ``csrc/tp_v45.cu`` (K14)."""
    from rwkv_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / {"att7": "tp_v7.cu", "att4": "tp_v45.cu"}.get(kind, "tp_v6.cu"))
    src = src.read_text()
    macro = {"att": "RWKV_TP_V6_ATT", "ffn": "RWKV_TP_V6_FFN", "att5": "RWKV_TP_V5_ATT",
             "att7": "RWKV_TP_V7_ATT", "ffn7": "RWKV_TP_V7_FFN", "att4": "RWKV_TP_V4_ATT"}[kind]
    macro = f"#define {macro}_PARAMS"
    body = src[src.index(macro) + len(macro):].split("#define", 1)[0]
    params = [p.strip() for p in body.replace("\\", " ").split(",")]
    assert params[-1] == "void *stream"
    n_ptr = sum(1 for p in params[:-1] if "*" in p)
    n_int = sum(1 for p in params[:-1] if p.startswith("int "))
    assert n_ptr + n_int == len(params) - 1
    assert (n_ptr, n_int) == TT.TP_ARGS[kind]


def test_part_refuses_rows_past_its_32_bit_range():
    """The header's part deals rows in 32-bit ints, so rows / 4 x blocks
    must stay below 2^31; the widest matrix the stream kernels take (the
    v7 head's 65536 rows over 132 blocks) is far inside."""
    with pytest.raises(ValueError, match="32-bit"):
        TM._part(1 << 26, 132, 0, False, 16, False, 4096, 32)
    last = TM._part(65536, 132, 131, False, 16, False, 4096, 32)
    assert last.r1 == 65536
