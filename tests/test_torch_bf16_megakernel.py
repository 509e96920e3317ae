"""The port's bf16 decode packs (``quant=False``) and the plain versions of
the bf16 forms of K3, K4, K6, K7 and K8 against the JAX package's
``build_mega_pack*(quant=False, head=True)`` and its ``quant=False``
kernels, run in interpret mode: v7_decode_megakernel (a rowified pack with
the in-kernel bf16 head), v7_decode_megakernel_batched, _batched_packed and
_tiled; v6_decode_megakernel and _tiled; v5 / v4 _decode_megakernel and
_tiled with one FFN tile.

The bf16 form has no activation codes, so the two sides differ only in the
order of f32 sums: every output is held within BAND of its scale (max |x -
ref| over max(1, max |ref|)) with equal argmax, over 4 greedy steps, each
side carrying its own state from the same start."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu.ops.parity import layer_norm as j_layer_norm
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM
from test_torch_models import jax_tree_to_numpy

BAND = 1e-4
STEPS = 4
SMALL = {"7.0": ("7.0", 2, 128, 256, 32), "6.0": ("6.0", 2, 256, 256, 64),
         "5.1": ("5.1", 2, 256, 256, 64), "5.2": ("5.2", 2, 256, 256, 64),
         "4.0": ("4.0", 2, 256, 256, 64)}
_J_BUILD = {7: JM.build_mega_pack, 6: JM.build_mega_pack_v6, 5: JM.build_mega_pack_v5,
            4: JM.build_mega_pack_v4}
_T_BUILD = {7: TM.build_mega_pack, 6: TM.build_mega_pack_v6, 5: TM.build_mega_pack_v5,
            4: TM.build_mega_pack_v4}
_MAT_KEYS = {7: TM.MAT_KEYS, 6: TM.V6_MAT_KEYS, 5: TM.V5_MAT_KEYS, 4: TM.V4_MAT_KEYS}


def _model(version):
    jc, tc = j_synth_config(*SMALL[version]), synth_config(*SMALL[version])
    kw = {"lora_dim": 32} if version == "7.0" else {}
    jp = j_synth_params(jc, seed=13, **kw)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    major = tc.version_major
    jpack = _J_BUILD[major](jp, jc, quant=False, head=True)
    tpack = _T_BUILD[major](tp, tc, quant=False)
    return jc, tc, tp, jpack, tpack


@pytest.fixture(scope="module", params=tuple(SMALL))
def model(request):
    return _model(request.param)


def _bits(t):
    """bf16 (or f32) values as their bit patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def test_bf16_pack_bit_equal_jax(model):
    """Every matrix and headbf16 in the same bf16 bits, the vectors (and
    v6's f32 maa2) equal, no scales."""
    jc, tc, _, jpack, tpack = model
    assert tpack["form"] == "bf16" and not tpack["quant"] and not tpack["w4"]
    for name in _MAT_KEYS[tc.version_major] + ("headbf16",):
        assert tpack[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(_bits(tpack[name]), _bits(jpack[name]), err_msg=name)
        assert name + "_d" not in tpack
    assert "head8" not in tpack and "head_d" not in tpack
    for key in ("ln1.weight", "ln2.bias", "ln_out.weight", "ln_out.bias"):
        np.testing.assert_array_equal(tpack[key].numpy().reshape(-1),
                                      np.asarray(jpack[key]).reshape(-1), err_msg=key)
    if tc.version_major == 6:
        np.testing.assert_array_equal(tpack["maa2"].numpy(), np.asarray(jpack["maa2"]))
        assert tpack["maa2"].dtype == torch.float32
        np.testing.assert_array_equal(tpack["maa5"].numpy().reshape(jc.n_layer, -1),
                                      np.asarray(jpack["maa5"]).reshape(jc.n_layer, -1))
    if tc.version_major in (4, 5):
        for key in ("amix", "fmix", "td", "tf"):
            np.testing.assert_array_equal(tpack[key].numpy().reshape(jc.n_layer, -1),
                                          np.asarray(jpack[key]).reshape(jc.n_layer, -1),
                                          err_msg=key)
    if tc.version_major == 7:
        np.testing.assert_array_equal(tpack["coeff"].numpy().reshape(jc.n_layer, -1),
                                      np.asarray(jpack["coeff"]).reshape(jc.n_layer, -1))


def test_bf16_device_pack_holds_bf16_rows_and_no_scales(model):
    _, tc, tp, _, tpack = model
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    mats = _MAT_KEYS[tc.version_major]
    assert dp["mats"].dtype == torch.bfloat16 and "scales" not in dp
    assert dp["mats"].shape[1] == sum(tpack[k][0].numel() for k in mats)
    for name in mats:
        assert torch.equal(TM._codes(dp, name, 1), tpack[name][1]), name
        assert dp[name].untyped_storage().data_ptr() == dp["mats"].untyped_storage().data_ptr()
    assert torch.equal(dp["headbf16"], tpack["headbf16"]) and dp["form"] == "bf16"


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _hold(got: dict, ref: dict, what: str):
    for k in ref:
        assert np.isfinite(np.asarray(got[k])).all(), (what, k)
        r = _rel(got[k], ref[k])
        assert r <= BAND, f"{what} {k}: {r:.3e} of the scale (band {BAND})"


def _x0(tp, tokens):
    """ln0 of the bf16 embedding rows, as JAX serves them: [C, B]."""
    emb = np.asarray(jnp.asarray(np.asarray(tp["emb"]), jnp.bfloat16).astype(jnp.float32))
    ln0 = [jnp.asarray(x.numpy()) for x in tp["ln0"]]
    return j_layer_norm(jnp.asarray(emb[np.asarray(tokens)]), *ln0).T


def _rand_state(tc, seed, batch=None):
    rng = np.random.default_rng(seed)
    L, h, s, c = tc.n_layer, tc.head_count, tc.head_size, tc.n_embed
    lead = () if batch is None else (batch,)
    st = {"att_xx": rng.standard_normal(lead + (L, c)).astype(np.float32) * 0.5,
          "ffn_xx": rng.standard_normal(lead + (L, c)).astype(np.float32) * 0.5}
    if tc.version_major == 4:
        st.update(aa=rng.standard_normal(lead + (L, c)).astype(np.float32),
                  bb=(np.abs(rng.standard_normal(lead + (L, c))) + 0.5).astype(np.float32),
                  pp=rng.standard_normal(lead + (L, c)).astype(np.float32))
    else:
        st["heads"] = rng.standard_normal(lead + (L, h, s, s)).astype(np.float32) * 0.1
    return st


def _logits(tpack, x):
    """ln_out, then the bf16 head in f32 (JAX's per-op head of the tiled
    and batched routes, at full precision)."""
    xo = j_layer_norm(jnp.asarray(x), jnp.asarray(tpack["ln_out.weight"].numpy()),
                      jnp.asarray(tpack["ln_out.bias"].numpy()))
    return np.asarray(xo) @ tpack["headbf16"].float().numpy().T


_T_STEP = {7: TM.v7_decode_step, 6: TM.v6_decode_step, 5: TM.v5_decode_step,
           4: TM.v4_decode_step}
_T_LAYERS = {6: TM.v6_decode_layers_ref, 5: TM.v5_decode_layers_ref,
             4: TM.v4_decode_layers_ref}


def _port_b1(tc, tp, tpack):
    """The port's B=1 step on CPU tensors (the plain version): (state,
    token) -> (x, logits, new state), numpy in the serving layout."""
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    major = tc.version_major
    step = _T_STEP[major]

    def run(st, token):
        state = {k: torch.from_numpy(v) for k, v in st.items()}
        tok = torch.tensor([token])
        before = dict(step.launches_by_form)
        logits, new = step(dp, state, tok, tc)
        assert step.launches_by_form == before  # CPU: no launch
        if major == 7:
            x, _ = TM.v7_decode_batched_ref(dp, {k: v[None] for k, v in state.items()}, tok, tc)
            x = x[0]
        else:
            x, _ = _T_LAYERS[major](dp, state, tok, tc)
        return x.numpy(), logits.numpy(), {k: v.numpy() for k, v in new.items()}
    return run


def _greedy(j_run, t_run, st, token, what):
    """STEPS greedy steps of both sides from `st`, the tokens JAX's argmax."""
    jst = tst = st
    for step in range(STEPS):
        jx, jl, jst = j_run(jst, token)
        tx, tl, tst = t_run(tst, token)
        _hold({"x": tx, "logits": tl, **tst}, {"x": jx, "logits": jl, **jst}, f"{what} {step}")
        assert int(np.argmax(tl)) == int(np.argmax(jl)), (what, step)
        token = int(np.argmax(jl))


def _j_whole_layer(jc, tc, tp, jpack):
    """JAX's whole-layer kernel with its in-kernel bf16 head on a rowified
    pack, in interpret mode, as a (state, token) -> (x, logits, state)
    step in the serving layout."""
    major = tc.version_major
    rowify = {7: JM.rowify_mega_pack, 6: JM.rowify_mega_pack_v6, 5: JM.rowify_mega_pack_v5,
              4: JM.rowify_mega_pack_v4}[major]
    kernel = {7: JM.v7_decode_megakernel, 6: JM.v6_decode_megakernel,
              5: JM.v5_decode_megakernel, 4: JM.v4_decode_megakernel}[major]
    rows = rowify(jpack)

    def run(st, token):
        # v7 keeps the token-shift state in columns, v4-v6 in rows
        shift = (lambda a: a[:, :, None]) if major == 7 else (lambda a: a[:, None, :])
        state_t = {k: shift(jnp.asarray(v)) for k, v in st.items() if k != "heads"}
        if "heads" in st:
            state_t["heads"] = jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)
        y, new, logits = kernel(rows, state_t, _x0(tp, [token]), jc, interpret=True)
        out = {k: np.asarray(v).reshape(tc.n_layer, -1) for k, v in new.items() if k != "heads"}
        if "heads" in new:
            out["heads"] = np.swapaxes(np.asarray(new["heads"]), -1, -2)
        return np.asarray(y).reshape(-1), np.asarray(logits).reshape(-1), out
    return run


def test_bf16_b1_ref_matches_jax_whole_layer_kernel(model):
    """K3, K6, K7 or K8's plain version in the bf16 form against the TPU
    whole-layer kernel with quant=False and the bf16 head."""
    jc, tc, tp, jpack, tpack = model
    st = _rand_state(tc, 3)
    _greedy(_j_whole_layer(jc, tc, tp, jpack), _port_b1(tc, tp, tpack), st, 41,
            f"v{tc.version} whole-layer")


def _j_tiled(jc, tc, tp, jpack):
    """JAX's phase-tiled B=1 kernel (v6, v5, v4) on a retiled quant=False
    pack, its logits the per-op head in f32 (``_logits``)."""
    major = tc.version_major
    L, h, s = tc.n_layer, tc.head_count, tc.head_size
    nh = 1
    if major == 6:
        tiled = JM.retile_mega_pack_v6(jpack, jc)
        kernel = JM.v6_decode_megakernel_tiled
    elif major == 5:
        n_mix = 4 if tc.version_minor == 2 else 3
        nh = 2
        tiled = JM.retile_mega_pack_v5(jpack, jc, nh=2, nf=1, ng=2 * n_mix, no=2)
        tiled["nh"] = 2
        kernel = JM.v5_decode_megakernel_tiled
    else:
        tiled = JM.retile_mega_pack_v4(jpack, jc, nf=1, nr=6, no=2)
        kernel = JM.v4_decode_megakernel_tiled

    def run(st, token):
        state_t = {k: jnp.asarray(v)[..., None] for k, v in st.items() if k != "heads"}
        if "heads" in st:
            state_t["heads"] = jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2).reshape(
                L, nh, h // nh, s, s)
        y, new = kernel(tiled, state_t, _x0(tp, [token]), jc, interpret=True)
        y = np.asarray(y).reshape(-1)
        out = {k: np.asarray(v).reshape(L, -1) for k, v in new.items() if k != "heads"}
        if "heads" in new:
            out["heads"] = np.swapaxes(np.asarray(new["heads"]).reshape(L, h, s, s), -1, -2)
        return y, _logits_np(jpack, y), out
    return run


def _logits_np(jpack, y):
    xo = j_layer_norm(jnp.asarray(y), jnp.asarray(jpack["ln_out.weight"]).reshape(-1),
                      jnp.asarray(jpack["ln_out.bias"]).reshape(-1))
    head = np.asarray(jnp.asarray(jpack["headbf16"]).astype(jnp.float32))
    return np.asarray(xo, np.float32) @ head.T


@pytest.mark.parametrize("version", ["6.0", "5.1", "5.2", "4.0"])
def test_bf16_b1_ref_matches_jax_tiled_kernel(version):
    """K6, K7 or K8's plain version in the bf16 form against the TPU
    phase-tiled kernel with quant=False (v5 heads in two groups, att and
    out rows in tiles, one FFN tile); logits from the f32 head on both
    sides."""
    jc, tc, tp, jpack, tpack = _model(version)
    st = _rand_state(tc, 5)
    port = _port_b1(tc, tp, tpack)

    def t_run(st_, token):
        x, _, new = port(st_, token)
        return x, _logits_np(jpack, x), new
    _greedy(_j_tiled(jc, tc, tp, jpack), t_run, st, 100, f"v{version} tiled")


def _j_batched(variant, jc, jpack):
    """JAX's batched v7 kernels with quant=False in interpret mode on
    serving-layout state [B, L, ...]; returns (x [B, C], state)."""
    h, s = jc.head_count, jc.head_size

    def run(st, x0):
        b, L = st["att_xx"].shape[:2]
        cols = {k: jnp.transpose(jnp.asarray(st[k]), (1, 2, 0)) for k in ("att_xx", "ffn_xx")}
        heads = jnp.asarray(st["heads"])
        if variant == "batched":
            y, new = JM.v7_decode_megakernel_batched(
                jpack, {**cols, "heads": jnp.transpose(heads, (1, 2, 3, 4, 0))}, x0, jc,
                interpret=True)
            new_heads = jnp.transpose(new["heads"], (4, 0, 1, 2, 3))
        elif variant == "packed":
            y, new = JM.v7_decode_megakernel_batched_packed(
                JM.rowify_mega_pack(jpack), {**cols, "heads": JM.pack_batched_state(heads, h, s)},
                x0, jc, interpret=True)
            new_heads = JM.unpack_batched_state(new["heads"], b, h, s)
        else:  # tiled, lane-packed state
            pk = JM.retile_mega_pack(jpack, jc, 1, 1, 3, 1)
            hp = jnp.transpose(heads, (1, 2, 4, 3, 0)).reshape(L, 1, h, s, s * b)
            y, new = JM.v7_decode_megakernel_tiled(pk, {**cols, "heads": hp}, x0, jc,
                                                   interpret=True, packed=True)
            new_heads = jnp.transpose(new["heads"].reshape(L, h, s, s, b), (4, 0, 1, 3, 2))
        out = {k: np.transpose(np.asarray(new[k]), (2, 0, 1)) for k in ("att_xx", "ffn_xx")}
        out["heads"] = np.asarray(new_heads)
        return np.asarray(y).T, out
    return run


@pytest.mark.parametrize("variant,batch", [("batched", 3), ("packed", 2), ("tiled", 2)])
def test_bf16_k4_ref_matches_jax_batched_kernels(variant, batch):
    """K4's plain version in the bf16 form against
    v7_decode_megakernel_batched (B=3), _batched_packed (B=2) and
    _tiled(packed=True) (B=2) with quant=False, 4 greedy steps."""
    jc, tc, tp, jpack, tpack = _model("7.0")
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    j_run = _j_batched(variant, jc, jpack)
    jst = tst = _rand_state(tc, 11 + batch, batch)
    tokens = np.random.default_rng(batch).integers(0, tc.n_vocab, batch)
    for step in range(STEPS):
        jx, jst = j_run(jst, _x0(tp, tokens))
        before = TM.v7_decode_batched.launches_by_form["bf16"]
        tx, tnew = TM.v7_decode_batched(dp, {k: torch.from_numpy(v) for k, v in tst.items()},
                                        torch.from_numpy(tokens), tc)
        assert TM.v7_decode_batched.launches_by_form["bf16"] == before
        tst = {k: v.numpy() for k, v in tnew.items()}
        jl, tl = _logits_np(jpack, jx), _logits_np(jpack, tx.numpy())
        _hold({"x": tx.numpy(), "logits": tl, **tst}, {"x": jx, "logits": jl, **jst},
              f"{variant} B={batch} step {step}")
        assert tl.argmax(-1).tolist() == jl.argmax(-1).tolist()
        tokens = jl.argmax(-1)


def test_bf16_k4_ref_b1_matches_k3_ref():
    """K4's plain version at B=1 plus the bf16 head against K3's: one loop,
    within BAND."""
    _, tc, tp, _, tpack = _model("7.0")
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    st = {k: torch.from_numpy(v) for k, v in _rand_state(tc, 21, 1).items()}
    tok = torch.tensor([77])
    x, new = TM.v7_decode_batched(dp, st, tok, tc)
    logits, ref_new = TM.v7_decode_step(dp, {k: v[0] for k, v in st.items()}, tok, tc)
    _hold({"logits": TM.lm_head_ref(dp, x[0]), **{k: v[0] for k, v in new.items()}},
          {"logits": logits, **ref_new}, "K4 B=1 vs K3")


def test_bf16_form_takes_an_f32_embedding():
    """The f32 precision's pack embeds from its f32 table: the plain
    version reads the rows as they are."""
    _, tc, tp, _, tpack = _model("7.0")
    dp32 = TM.device_pack(tpack, tp["emb"].float(), tp["ln0"], "cpu")
    dp16 = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    st = {k: torch.from_numpy(v) for k, v in _rand_state(tc, 4).items()}
    l32, _ = TM.v7_decode_step(dp32, st, torch.tensor([5]), tc)
    l16, _ = TM.v7_decode_step(dp16, st, torch.tensor([5]), tc)
    assert dp32["emb"].dtype == torch.float32 and not torch.equal(l32, l16)
    TM._check_pack(dp32)
    with pytest.raises(TypeError):
        TM._check_pack({**dp32, "form": "i8"})


def test_k3_bf16_shape_rule_takes_169m_width_not_1_5b():
    """K3's bf16 form reads a row in up to 16 chunks a lane (two rounds):
    the 169M width (C=768, F=3072) fits, the 1.5B width goes to K4."""
    cfg = synth_config("7.0", 1, 768, 256, 64)
    assert TM.decode_shape_error(cfg, 64, 3072, bf16=True) is None
    assert "chunks" in TM.decode_shape_error(cfg, 64, 3072 * 2, bf16=True)
    wide = synth_config("7.0", 1, 2048, 256, 64)
    assert "16 16-byte chunks" in TM.decode_shape_error(wide, 64, 8192, bf16=True)
    assert TM.batched_shape_error(wide, 64, 8192) is None
