"""K12's and K13's stream plans (``ops/megakernel_tp.py::tp_v6_stream_plan``,
the kernels' AttLayout / AttPlan / att_copy and FfnLayout / FfnPlan /
ffn_copy in ``csrc/tp_v6.cu``) on the CPU: every phase's rows are covered
once over the grid in whole 4-row groups, phase C's heads go one to a
block, every copy is a 16-byte multiple from a 16-byte aligned offset that
fits its stage, shared memory stays within the block's limit, the copies
land on the shard pack's rows (v6, and the v5.2 / v4 packs K13's MIX45 form
reads), and a published amax (per-block partial maxima in any order)
quantizes exactly as the plain quantizer does. The card tests compare the
kernels' own plans with these (``tests/test_torch_cuda.py``)."""

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
KINDS = ("att", "ffn")


def _plans(width: str, tp: int, kind: str, form: str):
    """The plan on every grid, at the shard's own tile count and at nf=2."""
    c, f, dm, dd, s = WIDTHS[width]
    c_loc, f_loc = c // tp, f // tp
    for nf in sorted({TT._ffn_tiles(c, f_loc), 2}):
        for blocks in GRIDS:
            yield TT.tp_v6_stream_plan(form, c, c_loc, f_loc, nf, dm, dd, s, blocks, kind)


def _n_rows(plan, name: str) -> int:
    return plan._spec(name)[0]


@pytest.mark.parametrize("form", TM.FORMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("width", WIDTHS)
def test_tp6_plan_covers_every_row_once(width, tp, kind, form):
    """Over each grid, the blocks' ranges of every phase's rows tile
    [0, N) in order, each in whole 4-row groups, and the pieces of a range
    tile it (K13's fv rows once a tile); K12's heads go one to a block, each
    head to exactly one."""
    for plan in _plans(width, tp, kind, form):
        names = plan.STREAMED + (("fv",) if kind == "ffn" else ())
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
        if kind == "att":
            heads = [h for b in range(plan.blocks) for h in plan.block_heads(b)]
            assert sorted(heads) == list(range(plan.n_heads))
            assert all(plan.count("heads", b) == 2 * len(plan.block_heads(b))
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
    bytes; phase A's vector pieces fit the ring at once."""
    for plan in _plans(width, tp, kind, form):
        assert plan.smem_bytes <= TM.STREAM_SMEM_LIMIT - TT.TP6_STATIC_SMEM
        assert plan.smem_bytes == plan.ring_off + plan.n_stages * plan.stage_bytes
        assert TM.STREAM_MIN_STAGES <= plan.n_stages <= TM.STREAM_MAX_STAGES
        assert plan.ring_off % 128 == 0 and plan.stage_bytes % 16 == 0
        assert plan.act_off % 16 == 0 and plan.bar_off % 16 == 0
        assert 2 <= plan.vec_rows and plan.count("vec", 0) <= plan.n_stages
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


def _shard_packs(version: str, form: str, nf, monkeypatch):
    """Both shards of a one-layer C=256 model at tp=2 on the CPU, cut into
    `nf` FFN tiles (None: the shard's own count)."""
    if nf is not None:
        monkeypatch.setattr(TT, "_ffn_tiles", lambda c, f_loc: nf)
    tc = synth_config(version, 1, 256, 256, 64)
    params = synth_params(tc, seed=5)
    build = {"6.0": TM.build_mega_pack_v6, "5.2": TM.build_mega_pack_v5,
             "4.0": TM.build_mega_pack_v4}[version]
    build_tp = {"6.0": TT.build_mega_pack_tp_v6, "5.2": TT.build_mega_pack_tp_v5,
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
                                               ("4.0", "ffn", None)])
def test_tp6_plan_copies_land_on_the_shard_rows(version, kind, nf, form, monkeypatch):
    """Over 7 blocks, the bytes each copy reads from layer 0 of a shard
    pack's tensors (and the launch's inputs) are the rows ``_codes`` gives
    (int4 unpacked) of every streamed matrix and fv tile, their row scales'
    16-byte windows, maa2 rows with their maa5 window, the vector rows of
    phase A (v6's ln / mixes, and for v5.2 / v4 the ln2 and FFN mix rows
    K13's MIX45 form reads at RVec6's rows), each head's dw2 rows, scales,
    decay / bonus / ln_x slices and state."""
    tc, packs = _shard_packs(version, form, nf, monkeypatch)
    c, s = tc.n_embed, tc.head_size
    gen = torch.Generator().manual_seed(1)
    x_in = torch.randn((c,), generator=gen)
    for pk in packs:
        c_loc, f_loc = pk["c_loc"], pk["f_dim"] // pk["tp"]
        plan = TT.tp_v6_stream_plan(form, c, c_loc, f_loc, pk["nf"], pk.get("d_maa", 0),
                                    pk.get("d_dec", 0), s, 7, kind)
        heads = torch.randn((max(c_loc // max(s, 1), 1), s, s), generator=gen)
        flat = {k: _bytes(v[0]) for k, v in pk.items()
                if isinstance(v, torch.Tensor) and v.dim() >= 1 and k in
                TT._ATT6_MATS + TT._FFN6_MATS and v is not None}
        flat.update(att_in=_bytes(x_in), ffn_in=_bytes(x_in), heads_in=_bytes(heads))

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
            if kind == "ffn":
                assert fv_seen == pk["nf"] * plan.rows("fv", b).pieces()
        assert ft * pk["nf"] == f_loc


def _codes_from_amax(x: np.ndarray, amax: np.float32):
    """Codes and dx as the kernels' one-pass preamble computes them from a
    published amax (``act_published``, decode_stream.cuh)."""
    dx = np.float32(amax) / np.float32(127.0)
    inv = np.float32(1.0) / np.maximum(dx, np.float32(1e-30)) if dx > 0 else np.float32(0.0)
    return np.clip(np.rint(x * inv), -127, 127).astype(np.float32), dx


@pytest.mark.parametrize("blocks", GRIDS)
def test_tp6_published_amax_quantizes_as_the_plain_quantizer(blocks):
    """K13's relu^2 keys (two tiles at the 1.6B width, tp=2) and K12's five
    mixes: each block's partial amax over the rows its plan gives it (a
    block's fk rows may straddle two tiles), as float bits combined in a
    random order per slot, equals the tile's / mix's amax, and the codes
    and scale it gives are bit-equal to ``quantize_act_plain``'s (vectors
    with zeros, -0.0, tiny and large values)."""
    rng = np.random.default_rng(blocks)
    ffn = TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 32, 64, 64, blocks, "ffn")
    att = TT.tp_v6_stream_plan("i8", 2048, 1024, 4096, 2, 32, 64, 64, blocks, "att")
    keys = np.square(np.maximum(rng.standard_normal(4096), 0)).astype(np.float32)
    keys[rng.integers(0, 4096, 5)] = [0.0, 3e4, 1e-45, 5.5, 0.0]
    mixes = rng.standard_normal(5 * 2048).astype(np.float32)
    mixes[rng.integers(0, 5 * 2048, 6)] = [-0.0, 3e4, -3e4, 1e-45, -1e-45, 0.0]
    for plan, vec, name, n in ((ffn, keys, "fk", 2048), (att, mixes, "maa2", 2048)):
        slots = vec.size // n
        partial = np.zeros((blocks, slots), np.uint32)
        for b in range(blocks):
            r = plan.rows(name, b)
            for row in range(r.r0, r.r1):
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
    """TP6_ATT_ARGS / TP6_FFN_ARGS (the ctypes signature of K12's / K13's
    C launch entries: pointers, then ints with the grid, then the stream)
    count the parameters of ``csrc/tp_v6.cu``'s entries."""
    from rwkv_tpu_torch.ops import _cuda

    src = (_cuda.CSRC / "tp_v6.cu").read_text()
    macro = f"#define RWKV_TP_V6_{kind.upper()}_PARAMS"
    body = src[src.index(macro) + len(macro):].split("#define", 1)[0]
    params = [p.strip() for p in body.replace("\\", " ").split(",")]
    assert params[-1] == "void *stream"
    n_ptr = sum(1 for p in params[:-1] if "*" in p)
    n_int = sum(1 for p in params[:-1] if p.startswith("int "))
    assert n_ptr + n_int == len(params) - 1
    assert (n_ptr, n_int) == (TT.TP6_ATT_ARGS if kind == "att" else TT.TP6_FFN_ARGS)


def test_part_refuses_rows_past_its_32_bit_range():
    """The header's part deals rows in 32-bit ints, so rows / 4 x blocks
    must stay below 2^31; the widest matrix the stream kernels take (the
    v7 head's 65536 rows over 132 blocks) is far inside."""
    with pytest.raises(ValueError, match="32-bit"):
        TM._part(1 << 26, 132, 0, False, 16, False, 4096, 32)
    last = TM._part(65536, 132, 131, False, 16, False, 4096, 32)
    assert last.r1 == 65536
