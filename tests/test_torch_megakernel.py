"""The port's decode pack and B=1 decode step (kernel K3's plain version)
against the JAX package's build_mega_pack and v7_decode_megakernel, run in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu.ops.parity import Weight, layer_norm as j_layer_norm
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM

SMALL = ("7.0", 2, 128, 256, 32)  # version, L, C, V, S (H = 4)


def jax_tree_to_numpy(tree):
    def leaf(x):
        return np.asarray(x.w if isinstance(x, Weight) else x, np.float32)

    return {
        "emb": leaf(tree["emb"]),
        "ln0": tuple(leaf(x) for x in tree["ln0"]),
        "ln_out": tuple(leaf(x) for x in tree["ln_out"]),
        "head": leaf(tree["head"]),
        "blocks": [{k: leaf(v) for k, v in b.items()} for b in tree["blocks"]],
    }


@pytest.fixture(scope="module")
def model():
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    jp = j_synth_params(jc, seed=7, lora_dim=32)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    jpack = JM.build_mega_pack(jp, jc, quant=True, head=True)
    tpack = TM.build_mega_pack(tp, tc)
    return jc, tc, jp, tp, jpack, tpack


def test_quantize_rows_bit_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 64)).astype(np.float32)
    w[1, 5] = 0.0
    jq, jd = JM._quantize_rows(w, False)
    tq, td = TM._quantize_rows(w)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[..., 0])


@pytest.mark.parametrize("name", TM.MAT_KEYS + ("head8",))
def test_mega_pack_codes_and_scales_bit_equal_jax(model, name):
    _, _, _, _, jpack, tpack = model
    np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]))
    dkey = "head_d" if name == "head8" else name + "_d"
    np.testing.assert_array_equal(tpack[dkey].numpy().reshape(-1), np.asarray(jpack[dkey]).reshape(-1))


def test_mega_pack_vectors_equal_jax(model):
    jc, _, _, _, jpack, tpack = model
    for key in TM.VEC_KEYS:
        np.testing.assert_array_equal(tpack[key].numpy(), np.asarray(jpack[key])[..., 0], err_msg=key)
    np.testing.assert_array_equal(tpack["coeff"].numpy().reshape(jc.n_layer, -1),
                                  np.asarray(jpack["coeff"])[..., 0])
    np.testing.assert_array_equal(tpack["r_k"].numpy().reshape(-1), np.asarray(jpack["r_k"]).reshape(-1))
    for key in ("ln_out.weight", "ln_out.bias"):
        np.testing.assert_array_equal(tpack[key].numpy(), np.asarray(jpack[key])[:, 0])


def test_device_pack_views_share_flat_buffers(model):
    _, tc, _, tp, _, tpack = model
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    for name in TM.MAT_KEYS:
        assert torch.equal(dp[name], tpack[name]) and torch.equal(dp[name + "_d"], tpack[name + "_d"])
        assert dp[name].untyped_storage().data_ptr() == dp["mats"].untyped_storage().data_ptr()
    c, d, f = tc.n_embed, tpack["d_lora"], tpack["f_dim"]
    assert dp["mats"].shape == (tc.n_layer, 4 * c * c + 8 * d * c + 2 * f * c)
    assert dp["scales"].shape == (tc.n_layer, 9 * c + 4 * d + f)
    assert dp["vecs"].shape == (tc.n_layer, len(TM.VEC_KEYS) + 7, c)


def test_decode_step_ref_matches_jax_megakernel(model):
    """One step from a random (nonzero) state: the port's plain K3 against
    the TPU kernel in interpret mode. Activation codes may flip at .5 under
    ulp-level differences, hence the test_megakernel.py band."""
    jc, tc, _, tp, jpack, tpack = model
    L, h, s, c = jc.n_layer, jc.head_count, jc.head_size, jc.n_embed
    rng = np.random.default_rng(1)
    att = rng.standard_normal((L, c)).astype(np.float32) * 0.5
    ffn = rng.standard_normal((L, c)).astype(np.float32) * 0.5
    heads = rng.standard_normal((L, h, s, s)).astype(np.float32) * 0.1
    token = 17
    emb_bf16 = np.asarray(jnp.asarray(np.asarray(tp["emb"]), jnp.bfloat16).astype(jnp.float32))
    x0 = j_layer_norm(jnp.asarray(emb_bf16[token]), *(jnp.asarray(x.numpy()) for x in tp["ln0"]))
    state_t = {"att_xx": jnp.asarray(att)[:, :, None], "ffn_xx": jnp.asarray(ffn)[:, :, None],
               "heads": jnp.swapaxes(jnp.asarray(heads), -1, -2)}
    _, j_new, j_logits = JM.v7_decode_megakernel(jpack, state_t, x0[:, None], jc, interpret=True)

    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    state = {"att_xx": torch.from_numpy(att), "ffn_xx": torch.from_numpy(ffn),
             "heads": torch.from_numpy(heads)}
    before = TM.v7_decode_step.launches
    logits, new = TM.v7_decode_step(dp, state, torch.tensor([token]), tc)
    assert TM.v7_decode_step.launches == before  # CPU: the plain version, no launch
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **tol)
    assert int(logits.argmax()) == int(np.argmax(np.asarray(j_logits)))
    np.testing.assert_allclose(new["att_xx"].numpy(), np.asarray(j_new["att_xx"])[..., 0], **tol)
    np.testing.assert_allclose(new["ffn_xx"].numpy(), np.asarray(j_new["ffn_xx"])[..., 0], **tol)
    np.testing.assert_allclose(new["heads"].numpy(), np.swapaxes(np.asarray(j_new["heads"]), -1, -2), **tol)
    # the input state is left as it was
    np.testing.assert_array_equal(state["heads"].numpy(), heads)


# -- w4a8 pack and K3-w4 ----------------------------------------------------


@pytest.fixture(scope="module")
def model_w4():
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    jp = j_synth_params(jc, seed=7, lora_dim=32)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    jpack = JM.build_mega_pack(jp, jc, quant=True, w4=True, head=True)
    tpack = TM.build_mega_pack(tp, tc, w4=True)
    return jc, tc, jp, tp, jpack, tpack


def test_quantize_rows_int4_bit_equal_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((2, 24, 96)).astype(np.float32)
    w[0, 3] = 0.0
    jq, jd = JM._quantize_rows(w, True)
    tq, td = TM._quantize_rows(w, four=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[..., 0])
    assert int(np.abs(tq.numpy()).max()) == 7


@pytest.mark.parametrize("name", TM.W4_MATS)
def test_w4_pack_codes_and_scales_bit_equal_jax(model_w4, name):
    _, _, _, _, jpack, tpack = model_w4
    assert tpack["w4"] and jpack["w4"]
    np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]))
    np.testing.assert_array_equal(tpack[name + "_d"].numpy().reshape(-1),
                                  np.asarray(jpack[name + "_d"]).reshape(-1))
    assert int(np.abs(tpack[name].numpy()).max()) <= 7


def test_w4_pack_keeps_lora_and_head_int8(model_w4):
    _, _, _, _, jpack, tpack = model_w4
    for name in ("lora1", "lora2", "head8"):
        np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]))
        assert int(np.abs(tpack[name].numpy()).max()) > 7


def test_int4_device_pack_round_trip(model_w4):
    """device_pack stores the int4 matrices two codes a byte; unpacking
    the flat buffer's views gives the codes back."""
    _, tc, _, tp, _, tpack = model_w4
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    c, d, f = tc.n_embed, tpack["d_lora"], tpack["f_dim"]
    assert dp["mats"].shape == (tc.n_layer, (4 * c * c + 2 * f * c) // 2 + 8 * d * c)
    for name in TM.MAT_KEYS:
        got = TM._codes(dp, name, 1)
        assert torch.equal(got, tpack[name][1]), name
    assert dp["rkv"].shape[-1] == c // 2 and dp["lora1"].shape[-1] == c


def _rand_state(jc, seed, batch=None):
    rng = np.random.default_rng(seed)
    L, h, s, c = jc.n_layer, jc.head_count, jc.head_size, jc.n_embed
    lead = () if batch is None else (batch,)
    return {"att_xx": rng.standard_normal(lead + (L, c)).astype(np.float32) * 0.5,
            "ffn_xx": rng.standard_normal(lead + (L, c)).astype(np.float32) * 0.5,
            "heads": rng.standard_normal(lead + (L, h, s, s)).astype(np.float32) * 0.1}


def _x0(tp, tokens):
    """ln0 of the bf16 embedding rows, as JAX serves them: [C, B]."""
    emb = np.asarray(jnp.asarray(np.asarray(tp["emb"]), jnp.bfloat16).astype(jnp.float32))
    ln0 = [jnp.asarray(x.numpy()) for x in tp["ln0"]]
    return j_layer_norm(jnp.asarray(emb[np.asarray(tokens)]), *ln0).T


def test_decode_step_ref_w4_matches_jax_megakernel(model_w4):
    """K3-w4's plain version against the TPU kernel's w4 path (a rowified
    pack: split-half nibbles, matv4) in interpret mode, 2e-2 with equal
    argmax, as the w8 case."""
    jc, tc, _, tp, jpack, tpack = model_w4
    st = _rand_state(jc, 5)
    token = 29
    rows = JM.rowify_mega_pack(jpack)
    state_t = {"att_xx": jnp.asarray(st["att_xx"])[:, :, None],
               "ffn_xx": jnp.asarray(st["ffn_xx"])[:, :, None],
               "heads": jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)}
    _, j_new, j_logits = JM.v7_decode_megakernel(rows, state_t, _x0(tp, [token]), jc,
                                                 interpret=True)
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    logits, new = TM.v7_decode_step(dp, state, torch.tensor([token]), tc)
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **tol)
    assert int(logits.argmax()) == int(np.argmax(np.asarray(j_logits)))
    np.testing.assert_allclose(new["att_xx"].numpy(), np.asarray(j_new["att_xx"])[..., 0], **tol)
    np.testing.assert_allclose(new["ffn_xx"].numpy(), np.asarray(j_new["ffn_xx"])[..., 0], **tol)
    np.testing.assert_allclose(new["heads"].numpy(), np.swapaxes(np.asarray(j_new["heads"]), -1, -2),
                               **tol)


# -- K4's plain version -------------------------------------------------------


def _jax_batched(variant, jc, jpack_w8, jpack_w4, st, x0):
    """The JAX package's batched kernels in interpret mode on serving-layout
    state `st` ([B, L, ...] numpy); returns (x [B, C], state [B, L, ...])."""
    h, s = jc.head_count, jc.head_size
    b, L = st["att_xx"].shape[:2]
    cols = {k: jnp.transpose(jnp.asarray(st[k]), (1, 2, 0)) for k in ("att_xx", "ffn_xx")}
    heads = jnp.asarray(st["heads"])
    if variant == "batched":
        y, new = JM.v7_decode_megakernel_batched(
            jpack_w8, {**cols, "heads": jnp.transpose(heads, (1, 2, 3, 4, 0))}, x0, jc,
            interpret=True)
        new_heads = jnp.transpose(new["heads"], (4, 0, 1, 2, 3))
    elif variant == "packed":
        y, new = JM.v7_decode_megakernel_batched_packed(
            JM.rowify_mega_pack(jpack_w8),
            {**cols, "heads": JM.pack_batched_state(heads, h, s)}, x0, jc, interpret=True)
        new_heads = JM.unpack_batched_state(new["heads"], b, h, s)
    else:  # tiled, w4, lane-packed state
        pk = JM.retile_mega_pack(jpack_w4, jc, 1, 1, 3, 1)
        hp = jnp.transpose(heads, (1, 2, 4, 3, 0)).reshape(L, 1, h, s, s * b)
        y, new = JM.v7_decode_megakernel_tiled(pk, {**cols, "heads": hp}, x0, jc,
                                               interpret=True, packed=True)
        new_heads = jnp.transpose(new["heads"].reshape(L, h, s, s, b), (4, 0, 1, 3, 2))
    out = {k: np.transpose(np.asarray(new[k]), (2, 0, 1)) for k in ("att_xx", "ffn_xx")}
    out["heads"] = np.asarray(new_heads)
    return np.asarray(y).T, out


@pytest.mark.parametrize("variant,batch", [("batched", 3), ("packed", 4), ("tiled_w4", 2)])
def test_batched_ref_matches_jax_batched_kernels(model, model_w4, variant, batch):
    """K4's plain version against v7_decode_megakernel_batched (B=3),
    _batched_packed (B=4, state through pack_batched_state) and
    _tiled(w4, packed=True) (B=2), interpret mode, 2e-2: activation codes
    may flip at .5 under ulp-level differences, as for K3."""
    jc, tc, _, tp, jpack, tpack = model
    jpack_w4, tpack_w4 = model_w4[4], model_w4[5]
    w4 = variant == "tiled_w4"
    st = _rand_state(jc, 11 + batch, batch)
    tokens = np.random.default_rng(batch).integers(0, tc.n_vocab, batch)
    y_ref, new_ref = _jax_batched(variant, jc, jpack, jpack_w4, st, _x0(tp, tokens))
    dp = TM.device_pack(tpack_w4 if w4 else tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    before = TM.v7_decode_batched.launches
    x, new = TM.v7_decode_batched(dp, state, torch.from_numpy(tokens), tc)
    assert TM.v7_decode_batched.launches == before  # CPU: the plain version
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(x.numpy(), y_ref, **tol)
    for k in new_ref:
        np.testing.assert_allclose(new[k].numpy(), new_ref[k], err_msg=k, **tol)
    np.testing.assert_array_equal(state["heads"].numpy(), st["heads"])  # input untouched


@pytest.mark.parametrize("w4", [False, True])
def test_batched_ref_b1_matches_decode_step_ref(model, model_w4, w4):
    """K4's plain version at B=1 plus ln_out and the head against K3's plain
    version: they share their arithmetic (about 1e-6 apart), held at 2e-2
    with equal argmax like the kernels."""
    _, tc, _, tp, _, tpack = model_w4 if w4 else model
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    st = {k: torch.from_numpy(v) for k, v in _rand_state(model[0], 21, 1).items()}
    tok = torch.tensor([77])
    x, new = TM.v7_decode_batched(dp, st, tok, tc)
    xo = TM.layer_norm(x, dp["ln_out"][0], dp["ln_out"][1])
    logits = TM._matvec(dp["head8"], dp["head_d"], xo)[0]
    ref_logits, ref_new = TM.v7_decode_step(dp, {k: v[0] for k, v in st.items()}, tok, tc)
    torch.testing.assert_close(logits, ref_logits, rtol=2e-2, atol=2e-2)
    assert int(logits.argmax()) == int(ref_logits.argmax())
    for k in ref_new:
        torch.testing.assert_close(new[k][0], ref_new[k], rtol=2e-2, atol=2e-2)


def test_batched_ref_identical_lanes_identical_outputs(model):
    _, tc, _, tp, _, tpack = model
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    one = _rand_state(model[0], 4, 1)
    st = {k: torch.from_numpy(np.repeat(v, 3, axis=0)) for k, v in one.items()}
    x, new = TM.v7_decode_batched(dp, st, torch.tensor([9, 9, 9]), tc)
    for t in [x] + list(new.values()):
        assert torch.equal(t[0], t[1]) and torch.equal(t[0], t[2])
