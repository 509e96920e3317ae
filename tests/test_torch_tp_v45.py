"""The port's tensor-parallel decode of RWKV-5 (v5.1, v5.2) and RWKV-4
(``ops/megakernel_tp.py``: ``build_mega_pack_tp_v5`` / ``_v4``, K15, K14
and K13's MIX45 form, ``tp_decode_step_v5`` / ``_v4``) against the JAX
package's ``megakernel_tp`` on the conftest's virtual CPU mesh: the shard
packs bit for bit (w8a8, w4a8, bf16; tp = 2 and 4), the plain shard
kernels against JAX's per-layer Pallas kernels in interpret mode on one
shard's local arrays, the TP step against JAX's from a seeded and from a
blank state, and ``ServingModel(mesh=..., megakernel=True)`` against
JAX's TP serving route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu.ops import megakernel_tp as JT
from rwkv_tpu.parallel.sharding import make_mesh as j_make_mesh
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.ops import megakernel_tp as TT
from rwkv_tpu_torch.ops.kernels import unpack_int4
from rwkv_tpu_torch.ops.parity import layer_norm
from rwkv_tpu_torch.parallel.sharding import make_mesh
from test_torch_megakernel import jax_tree_to_numpy
from test_torch_tp_megakernel import jlocal, split_half

PRECISIONS = ("w8a8", "w4a8", "bf16")
VERSIONS = ("4.0", "5.1", "5.2")
# bands against JAX, as test_torch_tp_megakernel.py's: the bf16 form only
# reorders f32 sums; the int forms may also flip an int8 activation code at
# a .5 boundary
SHARD_REL = {"bf16": 1e-5, "int": 1e-4}
STEP_REL = 1e-4
# the int forms' step, where a code flips: element-wise within FLIP_ABS
# (test_torch_tp_megakernel.py's C=256 band) with equal argmax of x
FLIP_ABS = 2e-2


def _build(version: str, precision: str, tp: int, seed: int = 7):
    """(JAX cfg, port cfg, JAX TP pack, its mesh, the port's shard packs)
    of one seeded synth model at L=2, C=256, S=32, V=256."""
    jc, tc = j_synth_config(version, 2, 256, 256, 32), synth_config(version, 2, 256, 256, 32)
    jp = j_synth_params(jc, seed=seed)
    tpar = params_from_numpy(tc, jax_tree_to_numpy(jp))
    quant, w4 = precision != "bf16", precision == "w4a8"
    mesh = j_make_mesh(1, tp, devices=jax.devices()[:tp])
    tmesh = make_mesh(1, tp, devices=["cpu"] * tp)
    if version == "4.0":
        jt = JT.build_mega_pack_tp_v4(JM.build_mega_pack_v4(jp, jc, quant=quant, w4=w4), jc, tp,
                                      mesh)
        tt = TT.build_mega_pack_tp_v4(TM.build_mega_pack_v4(tpar, tc, w4=w4, quant=quant), tc,
                                      tmesh)
    else:
        jt = JT.build_mega_pack_tp_v5(JM.build_mega_pack_v5(jp, jc, quant=quant, w4=w4), jc, tp,
                                      mesh)
        tt = TT.build_mega_pack_tp_v5(TM.build_mega_pack_v5(tpar, tc, w4=w4, quant=quant), tc,
                                      tmesh)
    return jc, tc, jt, mesh, tt


_CACHE = {}


def built(*key):
    if key not in _CACHE:
        _CACHE[key] = _build(*key)
    return _CACHE[key]


def port_codes(pk: dict, name: str) -> np.ndarray:
    q = unpack_int4(pk[name]) if pk["w4"] else pk[name]
    return q.float().numpy() if q.dtype == torch.bfloat16 else q.numpy()


def jax_codes(jt: dict, name: str, mesh, i: int) -> np.ndarray:
    a = jlocal(jt[name], mesh, i)
    if jt["w4"]:
        return split_half(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def jax_scale(jt: dict, name: str, mesh, i: int, L: int) -> np.ndarray:
    a = jlocal(jt[name + "_d"], mesh, i)
    if name == "fk":
        return a[:, :, 0]  # [L, nf, 1, ft] -> [L, nf, ft]
    return a.reshape(L, *a.shape[1:-1]) if a.shape[-1] == 1 else a.reshape(L, -1)


def jax_vec(jt: dict, name: str, mesh, i: int, L: int, c: int) -> np.ndarray:
    """A port vector row (TP4_* / TP5_*) from JAX's pack."""
    if name.startswith("amix."):
        return jlocal(jt["amix"], mesh, i).reshape(L, -1, c)[:, "kvrg".index(name[-1])]
    key = {"fmix.k": "fmix_k", "fmix.r": "fmix_r"}.get(name, name)
    return jlocal(jt[key], mesh, i).reshape(L, -1)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("version", VERSIONS)
def test_tp45_pack_bit_equal_jax(version, precision, tp):
    """Each shard's codes (int4 unpacked on both sides), row scales and
    vectors equal the matching shard of JAX's build_mega_pack_tp_v5 / _v4;
    v5.1 has three mixes and no gate rows."""
    jc, tc, jt, mesh, tt = built(version, precision, tp)
    L, c = jc.n_layer, jc.n_embed
    v4 = version == "4.0"
    mats = TT.TP4_MAT_KEYS if v4 else TT.TP5_MAT_KEYS
    n_mix = 4 if version == "5.2" else 3
    rvecs = TT.TP5_RVECS if n_mix == 4 else TT.TP4_RVECS
    lvecs = TT.TP4_LVECS if v4 else TT.TP5_LVECS
    for i, pk in enumerate(tt):
        assert (pk["shard"], pk["c_loc"], pk["nf"], pk["n_mix"]) == (i, c // tp, jt["nf"], n_mix)
        assert pk[mats[0]].shape[:3] == (L, n_mix, c // tp)
        for name in mats:
            want = jax_codes(jt, name, mesh, i)
            np.testing.assert_array_equal(port_codes(pk, name),
                                          want.reshape(pk[name].shape[:-1] + (-1,)),
                                          err_msg=f"shard {i} {name}")
            if precision != "bf16":
                np.testing.assert_array_equal(pk[name + "_d"].numpy(),
                                              jax_scale(jt, name, mesh, i, L),
                                              err_msg=f"shard {i} {name}_d")
            else:
                assert name + "_d" not in pk
        assert pk["rvecs"].shape[1] == len(rvecs)
        for name in rvecs + lvecs:
            np.testing.assert_array_equal(pk[name].numpy(), jax_vec(jt, name, mesh, i, L, c),
                                          err_msg=f"shard {i} {name}")


def test_tp45_rvecs_put_the_ffn_rows_where_k13_reads_them():
    """K13 reads ln2 and the two FFN mixes at v6's rows of the replicated
    block (csrc/tp_v6.cu RVec6); the v4 / v5 blocks hold them there."""
    for name in ("ln2.weight", "ln2.bias"):
        assert TT.TP4_RVECS.index(name) == TT.TP6_RVECS.index(name)
    assert TT.TP4_RVECS.index("fmix.k") == TT.TP6_RVECS.index("ffn.time_maa_k")
    assert TT.TP4_RVECS.index("fmix.r") == TT.TP6_RVECS.index("ffn.time_maa_r")
    assert TT.TP5_RVECS[: len(TT.TP4_RVECS)] == TT.TP4_RVECS


def _state(jc, seed: int, blank: bool = False):
    """One sequence's state (numpy): seeded, or blank as init_state gives
    it (v4's pp at -1e30)."""
    rng = np.random.default_rng(seed)
    L, h, s, c = jc.n_layer, jc.head_count, jc.head_size, jc.n_embed
    st = {"x": (rng.normal(size=(c,)) * 0.3).astype(np.float32),
          "att_xx": (rng.normal(size=(L, c)) * 0.1).astype(np.float32),
          "ffn_xx": (rng.normal(size=(L, c)) * 0.1).astype(np.float32)}
    if jc.version_major == 4:
        st["aa"] = (rng.normal(size=(L, c)) * 0.3).astype(np.float32)
        st["bb"] = np.abs(rng.normal(size=(L, c)) + 1.0).astype(np.float32)
        st["pp"] = (rng.normal(size=(L, c)) * 0.5).astype(np.float32)
    else:
        st["heads"] = (rng.normal(size=(L, h, s, s)) * 0.05).astype(np.float32)
    if blank:
        for k in st:
            if k != "x":
                st[k] = np.zeros_like(st[k])
        if "pp" in st:
            st["pp"][:] = -1e30
    return st


def _jax_layer(jt, mesh, i: int, l: int) -> dict:
    meta = ("quant", "w4", "f_dim", "tp", "nf", "has_gate")
    return {k: jnp.asarray(jlocal(v, mesh, i)[l]) for k, v in jt.items() if k not in meta}


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(np.abs(b).max(), 1e-30))


def _within(got: dict, want: dict, precision: str) -> None:
    band = SHARD_REL["bf16" if precision == "bf16" else "int"]
    for k in want:
        e = _rel(got[k], want[k])
        assert e < band, (k, e, band)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("version", VERSIONS)
def test_tp45_shard_kernels_ref_match_jax_layer_calls(version, precision):
    """On shard 1 of 2, layer 1: the plain K14 (v4) or K15 (v5) and K13's
    MIX45 form against JAX's _att_layer_call_v4 / _v5 and
    _ffn_layer_call_v6(mix45=True) in interpret mode on that shard's local
    arrays; partials, gate and states within SHARD_REL of their scale."""
    jc, tc, jt, mesh, tt = built(version, precision, 2)
    st = _state(jc, 3)
    i, tp, l = 1, 2, 1
    c_loc, h_loc = jc.n_embed // tp, jc.head_count // tp
    quant, w4 = precision != "bf16", precision == "w4a8"
    pk, lyr = tt[i], _jax_layer(jt, mesh, i, l)
    x = torch.from_numpy(st["x"])
    jx = jnp.asarray(st["x"])[:, None]
    col = {k: jnp.asarray(st[k][l])[:, None] for k in ("att_xx", "ffn_xx")}
    axx = torch.from_numpy(st["att_xx"][l])
    if version == "4.0":
        own = {k: st[k][l, i * c_loc : (i + 1) * c_loc] for k in ("aa", "bb", "pp")}
        jout = JT._att_layer_call_v4(lyr, jx, col["att_xx"],
                                     *(jnp.asarray(own[k])[:, None] for k in ("aa", "bb", "pp")),
                                     jc, tp, quant, True, w4)
        got = TT.tp_att_layer_v4_ref(pk, l, x, axx, *(torch.from_numpy(own[k])
                                                      for k in ("aa", "bb", "pp")), tc)
        names = ("part", "att_xx", "aa", "bb", "pp")
        _within(dict(zip(names, got)), {n: np.asarray(j)[:, 0] for n, j in zip(names, jout)},
                precision)
    else:
        heads = st["heads"][l, i * h_loc : (i + 1) * h_loc]
        jp, jaxx, jheads = JT._att_layer_call_v5(
            lyr, jx, col["att_xx"], jnp.swapaxes(jnp.asarray(heads), -1, -2), jc, tp, quant, True,
            w4, version == "5.2")
        part, naxx, nh = TT.tp_att_layer_v5_ref(pk, l, x, axx, torch.from_numpy(heads), tc)
        _within({"part": part, "att_xx": naxx, "heads": nh},
                {"part": np.asarray(jp)[:, 0], "att_xx": np.asarray(jaxx)[:, 0],
                 "heads": np.swapaxes(np.asarray(jheads), -1, -2)}, precision)
    fp, rg, ffx = TT.tp_ffn_layer_v45(pk, l, x, torch.from_numpy(st["ffn_xx"][l]), tc)
    jfp, jrg, jffx = JT._ffn_layer_call_v6(lyr, jx, col["ffn_xx"], jc, tp, quant, True, w4,
                                           mix_keys=("fmix_k", "fmix_r"), mix45=True)
    _within({"fp": fp, "rg": rg, "ffx": ffx},
            {"fp": np.asarray(jfp)[:, 0], "rg": np.asarray(jrg)[:, 0],
             "ffx": np.asarray(jffx)[:, 0]}, precision)


def _state_keys(version: str) -> tuple:
    return ("att_xx", "ffn_xx") + (("aa", "bb", "pp") if version == "4.0" else ("heads",))


STEP_CASES = [(v, p, 2, b) for v in ("4.0", "5.2") for p in PRECISIONS for b in (False, True)]
STEP_CASES += [("5.1", "w8a8", 2, False), ("5.1", "bf16", 2, True), ("4.0", "w4a8", 4, False),
               ("5.2", "w8a8", 4, True)]


@pytest.mark.parametrize("version,precision,tp,blank", STEP_CASES)
def test_tp45_decode_step_matches_jax(version, precision, tp, blank):
    """The port's tp_decode_step_v4 / _v5 (the plain shard kernels, the
    all-reduce in shard order, the gathered gate) against JAX's on the
    virtual mesh at 2 layers, from a seeded state and from a blank one (v4:
    pp = -1e30, whose exp(pp - qq) must be 0): bf16 within STEP_REL of the
    scale; the int forms within STEP_REL, or element-wise within FLIP_ABS
    with equal argmax of x where an int8 code flips. Finite throughout."""
    jc, tc, jt, mesh, tt = built(version, precision, tp)
    st = _state(jc, 5, blank)
    keys = _state_keys(version)
    state_t = {k: jnp.asarray(st[k])[:, :, None] for k in keys if k != "heads"}
    step, tstep = ((JT.tp_decode_step_v4, TT.tp_decode_step_v4) if version == "4.0"
                   else (JT.tp_decode_step_v5, TT.tp_decode_step_v5))
    if "heads" in keys:
        state_t["heads"] = jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)
    y, new_t = step(jt, state_t, jnp.asarray(st["x"])[:, None], jc, mesh, interpret=True)
    state = {k: torch.from_numpy(st[k].copy()) for k in keys}
    x, new = tstep(tt, state, torch.from_numpy(st["x"]), tc)
    want = {"x": np.asarray(y)[:, 0]}
    for k in keys:
        want[k] = (np.swapaxes(np.asarray(new_t[k]), -1, -2) if k == "heads"
                   else np.asarray(new_t[k])[..., 0])
    got = {"x": x, **new}
    assert set(got) == set(want)
    for k in want:
        assert bool(torch.isfinite(got[k]).all()), k
        e = _rel(got[k], want[k])
        if precision == "bf16" or e < STEP_REL:
            assert e < STEP_REL, (k, e)
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=FLIP_ABS, atol=FLIP_ABS,
                                       err_msg=k)
    assert int(x.argmax()) == int(want["x"].argmax())
    for k in keys:
        np.testing.assert_array_equal(state[k].numpy(), st[k])  # input untouched


def test_tp45_blank_v4_state_gives_the_first_token_wkv():
    """From the blank state (aa = bb = 0, pp = -1e30) v4's wkv is v and
    the new state is (v, 1, k): the plain K14 on a one-shard mesh against
    those values."""
    tc = synth_config("4.0", 2, 256, 256, 32)
    tpar = params_from_numpy(tc, jax_tree_to_numpy(j_synth_params(
        j_synth_config("4.0", 2, 256, 256, 32), seed=7)))
    pk = TT.build_mega_pack_tp_v4(TM.build_mega_pack_v4(tpar, tc, quant=False), tc,
                                  make_mesh(1, 1, devices=["cpu"]))[0]
    c = tc.n_embed
    x = torch.from_numpy(_state(tc, 9)["x"])
    zeros = torch.zeros(c)
    part, _, aa, bb, pp = TT.tp_att_layer_v4_ref(pk, 0, x, zeros, zeros, zeros,
                                                 torch.full((c,), -1e30), tc)
    assert bool(torch.isfinite(part).all())
    xl = layer_norm(x[None], pk["ln1.weight"][0], pk["ln1.bias"][0])
    k = TT._mv(pk, "rkv", 0, TM._mix45(xl, zeros[None], pk["amix.k"][0]), rows=1)[0]
    v = TT._mv(pk, "rkv", 0, TM._mix45(xl, zeros[None], pk["amix.v"][0]), rows=2)[0]
    torch.testing.assert_close(aa, v, rtol=0, atol=0)
    torch.testing.assert_close(bb, torch.ones(c), rtol=0, atol=0)
    torch.testing.assert_close(pp, k, rtol=0, atol=0)


def _serving(version: str, precision: str):
    jc, tc = j_synth_config(version, 2, 128, 256, 32), synth_config(version, 2, 128, 256, 32)
    jp = j_synth_params(jc, seed=3)
    tpar = params_from_numpy(tc, jax_tree_to_numpy(jp))
    jm = JServingModel((jc, jp), precision=precision, mesh=j_make_mesh(1, 2, jax.devices()[:2]),
                       megakernel=True)
    tm = ServingModel((tc, tpar), precision=precision, megakernel=True, device="cpu",
                      mesh=make_mesh(1, 2, devices=["cpu"] * 2))
    return jm, tm


SERVE_CASES = [(v, p) for v in ("4.0", "5.2") for p in PRECISIONS] + [("5.1", "w8a8")]


@pytest.mark.parametrize("version,precision", SERVE_CASES)
def test_tp45_mesh_decode_matches_jax(version, precision, monkeypatch):
    """ServingModel(mesh=..., megakernel=True) for v4 / v5: B=1 decode
    through the TP step (counted) from init_state over three tokens, logits
    and state against JAX's TP route (bf16 within STEP_REL of the scale;
    the int forms element-wise within FLIP_ABS, equal argmax)."""
    jm, tm = _serving(version, precision)
    assert jm._mega_tp is not None and len(tm._mega_tp) == 2 and tm._mega is None
    step = "tp_decode_step_v4" if version == "4.0" else "tp_decode_step_v5"
    calls = []
    real = getattr(TT, step)
    monkeypatch.setattr(TT, step, lambda *a: calls.append(1) or real(*a))
    sj, st = jm.init_state(1), tm.init_state(1)
    for tok in (3, 77, 200):
        lj, sj = jm.decode(np.array([tok], np.int32), sj)
        lt, st = tm.decode(np.array([tok]), st)
        lj = np.asarray(lj)
        assert lt.shape == (1, 256)
        if precision == "bf16":
            assert _rel(lt.numpy(), lj) < STEP_REL
        else:
            np.testing.assert_allclose(lt.numpy(), lj, rtol=FLIP_ABS, atol=FLIP_ABS)
        assert int(lt.argmax()) == int(lj.argmax())
        assert set(st) == set(_state_keys(version))
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=FLIP_ABS,
                                       atol=FLIP_ABS, err_msg=k)
    assert len(calls) == 3


def test_tp45_shape_errors():
    """v4 asks only that C and F split over tp (no head rule); v5 also
    that the heads do; both the 16-byte / 32-code row rules."""
    cfg4 = synth_config("4.0", 2, 256, 256, 32)
    assert TT.tp_shape_error_v4(cfg4, 2, 1024) is None
    assert "split over tp=3" in TT.tp_shape_error_v4(cfg4, 3, 1024)
    assert "C (256) and F (1022)" in TT.tp_shape_error_v4(cfg4, 4, 1022)
    # 16 shards of C=256: 8 heads of 32 do not split, v4 has no heads
    assert TT.tp_shape_error_v4(cfg4, 16, 1024) is None
    assert "C/tp" in TT.tp_shape_error_v4(cfg4, 16, 1024, w4=True)
    assert TT.tp_shape_error_v4(synth_config("5.2", 2, 256, 256, 32), 2, 1024) == (
        "K14 / K13 decode RWKV v4 only")
    cfg5 = synth_config("5.2", 2, 256, 256, 32)
    assert TT.tp_shape_error_v5(cfg5, 2, 1024) is None
    assert "heads (8)" in TT.tp_shape_error_v5(cfg5, 16, 1024)
    assert "head sizes" in TT.tp_shape_error_v5(synth_config("5.1", 2, 256, 256, 128), 2, 1024)
    assert TT.tp_shape_error_v5(cfg4, 2, 1024) == "K15 / K13 decode RWKV v5 only"
    with pytest.raises(ValueError, match="split over tp=3"):
        TT.build_mega_pack_tp_v4(TM.build_mega_pack_v4(
            params_from_numpy(cfg4, jax_tree_to_numpy(j_synth_params(
                j_synth_config("4.0", 2, 256, 256, 32), seed=0))), cfg4),
            cfg4, make_mesh(1, 3, devices=["cpu"] * 3))
