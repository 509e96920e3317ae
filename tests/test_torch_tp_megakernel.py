"""The port's tensor-parallel decode (``ops/megakernel_tp.py``,
``parallel/sharding.py``) against the JAX package's ``megakernel_tp``:
the shard packs bit for bit (v7 and v6; w8a8, w4a8 and bf16; tp = 2 and 4;
v7 at C=2048 with nf=2 FFN tiles), each shard kernel's plain version against
JAX's per-layer Pallas kernel in interpret mode on one shard's local
arrays, and the TP step against ``tp_decode_step`` / ``_v6`` on the
conftest's virtual CPU mesh."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu.ops import megakernel_tp as JT
from rwkv_tpu.parallel.sharding import make_mesh as j_make_mesh
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops import megakernel_tp as TT
from rwkv_tpu_torch.ops.kernels import unpack_int4
from rwkv_tpu_torch.parallel.sharding import make_mesh
from test_torch_megakernel import jax_tree_to_numpy

ROOT = Path(__file__).resolve().parent.parent
PRECISIONS = ("w8a8", "w4a8", "bf16")
# bands against JAX: the bf16 form only reorders f32 sums; the int forms may
# also flip an int8 activation code at a .5 boundary (test_torch_megakernel.py)
SHARD_REL = {"bf16": 1e-5, "int": 1e-4}
STEP_REL = {7: 1e-4, 6: 1e-3}
# The int forms' step at C=2048 against JAX from the seeded state below: one
# int8 activation code at a .5 boundary in layer 0 flips under a last-bit
# difference and moves x by 2.2% of its scale (seeds 0-2 read 2e-7 to 5e-7;
# bf16, which has no codes, 1.4e-6 to 2.7e-6 at all four). So that case is
# held to FLIP_REL of the scale with equal argmax; C=256 stays element-wise
# within 2e-2.
FLIP_REL = 5e-2


def _build(version: str, precision: str, c: int, tp: int, n_layer: int = 2, seed: int = 7):
    """(cfg, JAX TP pack, its mesh, the port's shard packs) of one seeded
    synth model."""
    s = 64 if c >= 512 else 32
    jc, tc = j_synth_config(version, n_layer, c, 256, s), synth_config(version, n_layer, c, 256, s)
    kw = {"lora_dim": 32} if version == "7.0" else {}
    jp = j_synth_params(jc, seed=seed, **kw)
    tpar = params_from_numpy(tc, jax_tree_to_numpy(jp))
    quant, w4 = precision != "bf16", precision == "w4a8"
    mesh = j_make_mesh(1, tp, devices=jax.devices()[:tp])
    tmesh = make_mesh(1, tp, devices=["cpu"] * tp)
    if version == "7.0":
        jt = JT.build_mega_pack_tp(JM.build_mega_pack(jp, jc, quant=quant, w4=w4), jc, tp, mesh)
        tt = TT.build_mega_pack_tp(TM.build_mega_pack(tpar, tc, w4=w4, quant=quant), tc, tmesh)
    else:
        jt = JT.build_mega_pack_tp_v6(JM.build_mega_pack_v6(jp, jc, quant=quant, w4=w4), jc, tp,
                                      mesh)
        tt = TT.build_mega_pack_tp_v6(TM.build_mega_pack_v6(tpar, tc, w4=w4, quant=quant), tc,
                                      tmesh)
    return jc, tc, jt, mesh, tt


_CACHE = {}


def built(*key):
    if key not in _CACHE:
        _CACHE[key] = _build(*key)
    return _CACHE[key]


def jlocal(arr, mesh, i: int) -> np.ndarray:
    """Shard i's local array of a JAX array placed over `mesh`."""
    dev = mesh.devices[0, i]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


def split_half(b: np.ndarray) -> np.ndarray:
    """JAX's split-half biased-lo nibbles [..., K/2] -> int4 codes [..., K]."""
    b = b.astype(np.int32)
    lo = (b & 0xF) - 8
    hi = ((b & 0xF0) ^ 0x80) - 0x80 >> 4
    return np.concatenate([lo, hi], axis=-1).astype(np.int8)


def port_codes(pk: dict, name: str) -> np.ndarray:
    w4_mats = TT.TP6_W4_MATS if pk["version"] == 6 else TT.TP_W4_MATS
    q = pk[name]
    if pk["w4"] and name in w4_mats:
        q = unpack_int4(q)
    return q.float().numpy() if q.dtype == torch.bfloat16 else q.numpy()


def jax_codes(jt: dict, name: str, mesh, i: int) -> np.ndarray:
    w4_mats = TT.TP6_W4_MATS if "rkvg" in jt else TT.TP_W4_MATS
    a = jlocal(jt[name], mesh, i)
    if jt["w4"] and name in w4_mats:
        return split_half(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


# port scale key -> JAX local array reshaped to the port's layout
def jax_scale(jt, name, mesh, i, L):
    a = jlocal(jt[name + "_d"], mesh, i)
    if name in ("fk",):
        return a[:, :, 0]  # [L, nf, 1, ft] -> [L, nf, ft]
    return a.reshape(L, *a.shape[1:-1]) if a.shape[-1] == 1 else a.reshape(L, -1)


def jax_vec(jt, name, mesh, i, L) -> np.ndarray:
    """A port vector row (TP_RVECS / TP_LVECS / TP6_*) from JAX's pack."""
    if name.startswith(("coeff.", "maa5.")):
        key, n = name.split(".")
        j = ("rwkvag" if key == "coeff" else "wkvrg").index(n)
        a = jlocal(jt[key], mesh, i).reshape(L, 6 if key == "coeff" else 5, -1)
        return a[:, j]
    return jlocal(jt[name], mesh, i).reshape(L, -1)


PACK_CASES = [("7.0", p, 256, tp) for p in PRECISIONS for tp in (2, 4)]
PACK_CASES += [("6.0", p, 256, tp) for p in PRECISIONS for tp in (2, 4)]
PACK_CASES += [("7.0", "w8a8", 2048, 2), ("7.0", "w4a8", 2048, 2)]


@pytest.mark.parametrize("version,precision,c,tp", PACK_CASES)
def test_tp_pack_bit_equal_jax(version, precision, c, tp):
    """Each shard's codes (int4 unpacked on both sides), row scales and
    vectors equal the matching shard of JAX's build_mega_pack_tp / _v6;
    the FFN tiling (nf) is JAX's: nf=2 at C=2048, F=8192, tp=2."""
    jc, tc, jt, mesh, tt = built(version, precision, c, tp)
    L = jc.n_layer
    assert [pk["nf"] for pk in tt] == [jt["nf"]] * tp
    if c == 2048:
        assert jt["nf"] == 2
    v6 = version == "6.0"
    mats = TT.TP6_MAT_KEYS if v6 else TT.TP_MAT_KEYS
    rvecs, lvecs = (TT.TP6_RVECS, TT.TP6_LVECS) if v6 else (TT.TP_RVECS, TT.TP_LVECS)
    for i, pk in enumerate(tt):
        assert pk["shard"] == i and pk["c_loc"] == c // tp
        for name in mats:
            want = jax_codes(jt, name, mesh, i)
            np.testing.assert_array_equal(port_codes(pk, name), want.reshape(pk[name].shape[:-1]
                                          + (-1,)), err_msg=f"shard {i} {name}")
            if precision != "bf16":
                np.testing.assert_array_equal(pk[name + "_d"].numpy(),
                                              jax_scale(jt, name, mesh, i, L),
                                              err_msg=f"shard {i} {name}_d")
            else:
                assert name + "_d" not in pk
        for name in rvecs + lvecs:
            np.testing.assert_array_equal(pk[name].numpy(), jax_vec(jt, name, mesh, i, L),
                                          err_msg=f"shard {i} {name}")
        if v6:
            np.testing.assert_array_equal(pk["maa2"].numpy(), jlocal(jt["maa2"], mesh, i))


def test_tp_w4_shards_are_slices_of_the_packed_rows():
    """Under w4a8 a K-split matrix's shard bytes are its slice of the whole
    row packed by pack_int4: 32-code blocks never straddle two shards."""
    _, _, _, _, tt = built("7.0", "w4a8", 256, 4)
    whole = TT.pack_int4(torch.cat([unpack_int4(pk["out"]) for pk in tt], dim=-1))
    assert torch.equal(torch.cat([pk["out"] for pk in tt], dim=-1), whole)


def _state(jc, seed: int):
    rng = np.random.default_rng(seed)
    L, h, s, c = jc.n_layer, jc.head_count, jc.head_size, jc.n_embed
    return {"x": (rng.normal(size=(c,)) * 0.3).astype(np.float32),
            "att_xx": (rng.normal(size=(L, c)) * 0.1).astype(np.float32),
            "ffn_xx": (rng.normal(size=(L, c)) * 0.1).astype(np.float32),
            "heads": (rng.normal(size=(L, h, s, s)) * 0.05).astype(np.float32)}


def _jax_layer(jt, mesh, i: int, l: int) -> dict:
    meta = ("quant", "w4", "d_lora", "d_maa", "d_dec", "f_dim", "tp", "nf")
    return {k: jnp.asarray(jlocal(v, mesh, i)[l]) for k, v in jt.items() if k not in meta}


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))


def _within(got: dict, want: dict, precision: str) -> None:
    band = SHARD_REL["bf16" if precision == "bf16" else "int"]
    for k in want:
        e = _rel(got[k], want[k])
        assert e < band, (k, e, band)


@pytest.mark.parametrize("version", ["7.0", "6.0"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_shard_kernels_ref_match_jax_layer_calls(version, precision):
    """On shard 1 of 2, layer 1: the plain K10 / K11 (v7) or K12 / K13 (v6)
    against JAX's _att_layer_call / _ffn_layer_call (_v6) in interpret mode
    on that shard's local arrays; v7 also at layer 0 (first: v_first is
    set). Partials, gate and states within SHARD_REL of their scale."""
    jc, tc, jt, mesh, tt = built(version, precision, 256, 2)
    st = _state(jc, 3)
    i, tp, s = 1, 2, jc.head_size
    h_loc, c_loc = jc.head_count // tp, jc.n_embed // tp
    quant, w4 = precision != "bf16", precision == "w4a8"
    x, pk = st["x"], tt[i]
    layers = (0, 1) if version == "7.0" else (1,)
    vf = (np.random.default_rng(4).normal(size=(c_loc,)) * 0.2).astype(np.float32)
    for l in layers:
        lyr = _jax_layer(jt, mesh, i, l)
        heads = st["heads"][l, i * h_loc : (i + 1) * h_loc]
        col = {k: jnp.asarray(st[k][l])[:, None] for k in ("att_xx", "ffn_xx")}
        jx, jh = jnp.asarray(x)[:, None], jnp.swapaxes(jnp.asarray(heads), -1, -2)
        if version == "7.0":
            first = l == 0
            jp, jaxx, jheads, jvf = JT._att_layer_call(
                lyr, jx, col["att_xx"], jh, jnp.asarray(vf)[:, None],
                jnp.full((1, 1), float(first), jnp.float32), jc, tp, quant, True, w4=w4)
            part, axx, nh, nvf = TT.tp_att_layer(pk, l, torch.from_numpy(x),
                                                 torch.from_numpy(st["att_xx"][l]),
                                                 torch.from_numpy(heads), torch.from_numpy(vf),
                                                 first, tc)
            _within({"part": part, "att_xx": axx, "vf": nvf},
                    {"part": jp[:, 0], "att_xx": jaxx[:, 0], "vf": jvf[:, 0]}, precision)
            fp, ffx = TT.tp_ffn_layer(pk, l, torch.from_numpy(x), torch.from_numpy(st["ffn_xx"][l]),
                                      tc)
            jfp, jffx = JT._ffn_layer_call(lyr, jx, col["ffn_xx"], jc, tp, quant, True, w4=w4)
            _within({"fp": fp, "ffx": ffx}, {"fp": jfp[:, 0], "ffx": jffx[:, 0]}, precision)
        else:
            jp, jaxx, jheads = JT._att_layer_call_v6(lyr, jx, col["att_xx"], jh, jc, tp, quant,
                                                     True, w4)
            part, axx, nh = TT.tp_att_layer_v6(pk, l, torch.from_numpy(x),
                                               torch.from_numpy(st["att_xx"][l]),
                                               torch.from_numpy(heads), tc)
            _within({"part": part, "att_xx": axx}, {"part": jp[:, 0], "att_xx": jaxx[:, 0]},
                    precision)
            fp, rg, ffx = TT.tp_ffn_layer_v6(pk, l, torch.from_numpy(x),
                                             torch.from_numpy(st["ffn_xx"][l]), tc)
            jfp, jrg, jffx = JT._ffn_layer_call_v6(lyr, jx, col["ffn_xx"], jc, tp, quant, True,
                                                   w4)
            _within({"fp": fp, "rg": rg, "ffx": ffx},
                    {"fp": jfp[:, 0], "rg": jrg[:, 0], "ffx": jffx[:, 0]}, precision)
        _within({"heads": nh}, {"heads": np.swapaxes(np.asarray(jheads), -1, -2)}, precision)
        assert nh.shape == (h_loc, s, s)


STEP_CASES = [("7.0", p, 256, 2) for p in PRECISIONS] + [("6.0", p, 256, 2) for p in PRECISIONS]
STEP_CASES += [("7.0", "w8a8", 256, 4), ("6.0", "w4a8", 256, 4), ("7.0", "w8a8", 2048, 2),
               ("7.0", "bf16", 2048, 2)]


@pytest.mark.parametrize("version,precision,c,tp", STEP_CASES)
def test_tp_decode_step_matches_jax(version, precision, c, tp):
    """The port's tp_decode_step / _v6 (the plain shard kernels, the
    all-reduce in shard order, v6's gathered gate) against JAX's on the
    virtual mesh at 2 layers: bf16 within STEP_REL of the scale (1e-4 v7,
    1e-3 v6), the int forms within 2e-2 (FLIP_REL of the scale at C=2048)
    with equal argmax of x; at C=2048 nf=2 FFN tiles."""
    jc, tc, jt, mesh, tt = built(version, precision, c, tp)
    st = _state(jc, 5)
    state_t = {"att_xx": jnp.asarray(st["att_xx"])[:, :, None],
               "ffn_xx": jnp.asarray(st["ffn_xx"])[:, :, None],
               "heads": jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)}
    step, tstep = ((JT.tp_decode_step, TT.tp_decode_step) if version == "7.0"
                   else (JT.tp_decode_step_v6, TT.tp_decode_step_v6))
    y, new_t = step(jt, state_t, jnp.asarray(st["x"])[:, None], jc, mesh, interpret=True)
    state = {k: torch.from_numpy(st[k]) for k in ("att_xx", "ffn_xx", "heads")}
    x, new = tstep(tt, state, torch.from_numpy(st["x"]), tc)
    want = {"x": np.asarray(y)[:, 0], "att_xx": np.asarray(new_t["att_xx"])[..., 0],
            "ffn_xx": np.asarray(new_t["ffn_xx"])[..., 0],
            "heads": np.swapaxes(np.asarray(new_t["heads"]), -1, -2)}
    got = {"x": x, **new}
    if precision == "bf16":
        for k in want:
            assert _rel(got[k], want[k]) < STEP_REL[int(version[0])], k
    elif c == 2048:
        for k in want:
            assert _rel(got[k], want[k]) < FLIP_REL, (k, _rel(got[k], want[k]))
        assert int(x.argmax()) == int(want["x"].argmax())
    else:
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-2, atol=2e-2, err_msg=k)
        assert int(x.argmax()) == int(want["x"].argmax())
    np.testing.assert_array_equal(state["heads"].numpy(), st["heads"])  # input untouched


def test_all_reduce_sums_in_shard_order():
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8, 1.0]), torch.tensor([1.0, 1e-8])]
    out = TT.all_reduce(parts, [torch.device("cpu")] * 3)
    assert len(out) == 3 and out[0] is out[1]
    assert torch.equal(out[0], (parts[0] + parts[1]) + parts[2])


def test_ffn_tiles_follow_jax_rule():
    # (C, F, tp) -> nf, JAX's while loop in build_mega_pack_tp
    for c, f, tp, nf in ((2048, 8192, 2, 2), (2048, 8192, 4, 1), (4096, 14336, 2, 7),
                         (768, 3072, 1, 1), (256, 1024, 2, 1)):
        assert TT._ffn_tiles(c, f // tp) == nf, (c, f, tp)


def test_make_mesh():
    mesh = make_mesh(1, 2, devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2} and mesh.tp == 2
    assert make_mesh(1, 2, devices=["cpu"] * 3).devices == (torch.device("cpu"),) * 2
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        make_mesh(2, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 2 devices"):
        make_mesh(1, 2, devices=["cpu"])


def test_make_mesh_without_enough_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
        make_mesh(1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 1"):
        make_mesh(1, 2)
    assert make_mesh(1, 1).devices == (torch.device("cuda", 0),)


def test_shape_errors():
    cfg = synth_config("7.0", 2, 256, 256, 32)
    assert TT.tp_shape_error(cfg, 2, 32, 1024) is None
    assert "split over tp=3" in TT.tp_shape_error(cfg, 3, 32, 1024)
    narrow = synth_config("7.0", 2, 256, 256, 16)
    assert TT.tp_shape_error(narrow, 16, 32, 1024) is None
    assert "C/tp" in TT.tp_shape_error(narrow, 16, 32, 1024, w4=True)
    assert "d_lora" in TT.tp_shape_error(cfg, 2, 24, 1024)
    cfg6 = synth_config("6.0", 2, 256, 256, 32)
    assert TT.tp_shape_error(cfg6, 2, 32, 1024) == "K10 / K11 decode RWKV v7 only"
    assert TT.tp_shape_error_v6(cfg6, 2, 32, 64, 1024) is None
    assert "d_maa" in TT.tp_shape_error_v6(cfg6, 2, 30, 64, 1024)


# the TP path's modules, relative to rwkv_tpu_torch/ (chip_smoke.py drives it)
@pytest.mark.parametrize("module", ["ops/megakernel_tp.py", "parallel/sharding.py",
                                    "models/serve.py", "tools/card.py", "../chip_smoke.py"])
def test_tp_modules_import_no_jax(module):
    src = (ROOT / "rwkv_tpu_torch" / module).read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, flags=re.M)
    assert imports and all(not m.startswith(("jax", "rwkv_tpu.")) and m != "rwkv_tpu"
                           for m in imports), imports
