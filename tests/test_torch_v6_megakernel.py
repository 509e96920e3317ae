"""The port's v6 decode pack and B=1 decode step (kernel K6's plain
version) against the JAX package's build_mega_pack_v6, v6_decode_megakernel
(a rowified pack with the in-kernel head) and v6_decode_megakernel_tiled
(a retile_mega_pack_v6 pack, w8 and w4), run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu.ops.kernels import quantize_q8_serving
from rwkv_tpu.ops.parity import layer_norm as j_layer_norm
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.synth import synth_config
from rwkv_tpu_torch.ops import megakernel as TM
from test_torch_models import jax_tree_to_numpy

SMALL6 = ("6.0", 2, 256, 256, 64)  # version, L, C, V, S (H = 4)
TOL = dict(rtol=2e-2, atol=2e-2)  # int8 codes may flip at .5 under ulp-level differences


@pytest.fixture(scope="module")
def model6():
    jc, tc = j_synth_config(*SMALL6), synth_config(*SMALL6)
    jp = j_synth_params(jc, seed=9)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    packs = {}
    for w4 in (False, True):
        packs[w4] = (JM.build_mega_pack_v6(jp, jc, quant=True, w4=w4, head=True),
                     TM.build_mega_pack_v6(tp, tc, w4=w4))
    return jc, tc, jp, tp, packs


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("name", TM.V6_MAT_KEYS + ("head8",))
def test_v6_pack_codes_and_scales_bit_equal_jax(model6, name, w4):
    jpack, tpack = model6[4][w4]
    np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]))
    dkey = "head_d" if name == "head8" else name + "_d"
    np.testing.assert_array_equal(tpack[dkey].numpy().reshape(-1),
                                  np.asarray(jpack[dkey]).reshape(-1))
    four = w4 and name in TM.V6_W4_MATS
    assert (int(np.abs(tpack[name].numpy()).max()) <= 7) == four


def test_v6_pack_vectors_and_maa2_equal_jax(model6):
    jc, _, _, _, packs = model6
    jpack, tpack = packs[False]
    L = jc.n_layer
    for key in TM.V6_VEC_KEYS:
        np.testing.assert_array_equal(tpack[key].numpy(), np.asarray(jpack[key])[..., 0],
                                      err_msg=key)
    for key in ("maa5", "tdecay", "tf"):
        np.testing.assert_array_equal(tpack[key].numpy().reshape(L, -1),
                                      np.asarray(jpack[key]).reshape(L, -1), err_msg=key)
    np.testing.assert_array_equal(tpack["maa2"].numpy(), np.asarray(jpack["maa2"]))
    assert tpack["maa2"].dtype == torch.float32
    assert (tpack["d_maa"], tpack["d_dec"], tpack["f_dim"]) == (
        jpack["d_maa"], jpack["d_dec"], jpack["f_dim"])


@pytest.mark.parametrize("w4", [False, True])
def test_v6_device_pack_views_share_flat_buffers(model6, w4):
    _, tc, _, tp, packs = model6
    tpack = packs[w4][1]
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    c, f = tc.n_embed, tpack["f_dim"]
    dm, dd = tpack["d_maa"], tpack["d_dec"]
    big = 4 * c * c + 2 * c * c + 2 * f * c  # rkvg; out, fr; fk, fv
    small = 5 * dm * c + 2 * dd * c
    assert dp["mats"].shape == (tc.n_layer, (big // 2 if w4 else big) + small)
    assert dp["scales"].shape == (tc.n_layer, 4 * c + 5 * dm + dd + 4 * c + f)
    assert dp["vecs"].shape == (tc.n_layer, len(TM.V6_VEC_KEYS) + 7, c)
    for name in TM.V6_MAT_KEYS:
        assert torch.equal(TM._codes(dp, name, 1), tpack[name][1]), name
        assert torch.equal(dp[name + "_d"], tpack[name + "_d"])
        assert dp[name].untyped_storage().data_ptr() == dp["mats"].untyped_storage().data_ptr()
    for key in TM.V6_VEC_KEYS + ("maa5", "tdecay", "tf"):
        assert torch.equal(dp[key], tpack[key]), key
    assert dp["version"] == 6 and torch.equal(dp["maa2"], tpack["maa2"])


def _rand_state(jc, seed):
    rng = np.random.default_rng(seed)
    L, h, s, c = jc.n_layer, jc.head_count, jc.head_size, jc.n_embed
    return {"att_xx": rng.standard_normal((L, c)).astype(np.float32) * 0.5,
            "ffn_xx": rng.standard_normal((L, c)).astype(np.float32) * 0.5,
            "heads": rng.standard_normal((L, h, s, s)).astype(np.float32) * 0.1}


def _x0(tp, token):
    """ln0 of the bf16 embedding row, as JAX serves it: [C, 1]."""
    emb = np.asarray(jnp.asarray(np.asarray(tp["emb"]), jnp.bfloat16).astype(jnp.float32))
    ln0 = [jnp.asarray(x.numpy()) for x in tp["ln0"]]
    return j_layer_norm(jnp.asarray(emb[token]), *ln0)[:, None]


def _port_step(model6, w4, st, token):
    _, tc, _, tp, packs = model6
    dp = TM.device_pack(packs[w4][1], tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    before = TM.v6_decode_step.launches
    logits, new = TM.v6_decode_step(dp, state, torch.tensor([token]), tc)
    assert TM.v6_decode_step.launches == before  # CPU: the plain version, no launch
    x, _ = TM.v6_decode_layers_ref(dp, state, torch.tensor([token]), tc)
    np.testing.assert_array_equal(state["heads"].numpy(), st["heads"])  # input untouched
    return x, logits, new


def _hold(x, logits, new, y_ref, logits_ref, new_ref):
    np.testing.assert_allclose(x.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(logits.numpy(), logits_ref, **TOL)
    assert int(logits.argmax()) == int(np.argmax(logits_ref))
    for k in new_ref:
        np.testing.assert_allclose(new[k].numpy(), new_ref[k], err_msg=k, **TOL)


def test_v6_decode_step_ref_matches_jax_megakernel(model6):
    """w8a8 against v6_decode_megakernel on a rowified pack with the
    in-kernel head (row-layout token-shift state, transposed heads)."""
    jc, _, _, tp, packs = model6
    st = _rand_state(jc, 3)
    token = 41
    rows = JM.rowify_mega_pack_v6(packs[False][0])
    state_t = {"att_xx": jnp.asarray(st["att_xx"])[:, None, :],
               "ffn_xx": jnp.asarray(st["ffn_xx"])[:, None, :],
               "heads": jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)}
    y, j_new, j_logits = JM.v6_decode_megakernel(rows, state_t, _x0(tp, token), jc,
                                                 interpret=True)
    new_ref = {"att_xx": np.asarray(j_new["att_xx"])[:, 0], "ffn_xx": np.asarray(j_new["ffn_xx"])[:, 0],
               "heads": np.swapaxes(np.asarray(j_new["heads"]), -1, -2)}
    _hold(*_port_step(model6, False, st, token), np.asarray(y)[:, 0], np.asarray(j_logits), new_ref)


@pytest.mark.parametrize("w4", [False, True])
def test_v6_decode_step_ref_matches_jax_tiled(model6, w4):
    """w8a8 and w4a8 against v6_decode_megakernel_tiled on a
    retile_mega_pack_v6 pack (split-half nibbles under w4); its logits are
    JAX's per-op head (ln_out, then the w8a8 head), as its serving runs it."""
    jc, _, jp, tp, packs = model6
    st = _rand_state(jc, 5 + w4)
    token = 100 + w4
    L, h, s = jc.n_layer, jc.head_count, jc.head_size
    tiled = JM.retile_mega_pack_v6(packs[w4][0], jc)
    state_t = {"att_xx": jnp.asarray(st["att_xx"])[..., None],
               "ffn_xx": jnp.asarray(st["ffn_xx"])[..., None],
               "heads": jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2).reshape(L, 1, h, s, s)}
    y, j_new = JM.v6_decode_megakernel_tiled(tiled, state_t, _x0(tp, token), jc, interpret=True)
    y = jnp.asarray(y).reshape(-1)
    head = quantize_q8_serving(jp["head"].w, rowwise=True, int8_act=True)
    j_logits = JG.mm(j_layer_norm(y, *jp["ln_out"])[None, :], head)[0]
    new_ref = {"att_xx": np.asarray(j_new["att_xx"]).reshape(L, -1),
               "ffn_xx": np.asarray(j_new["ffn_xx"]).reshape(L, -1),
               "heads": np.swapaxes(np.asarray(j_new["heads"]).reshape(L, h, s, s), -1, -2)}
    _hold(*_port_step(model6, w4, st, token), np.asarray(y), np.asarray(j_logits), new_ref)


def test_v6_decode_shape_error_names_what_k6_refuses():
    cfg = synth_config("6.0", 1, 256, 256, 64)
    assert TM.v6_decode_shape_error(cfg, 32, 64, 1024) is None
    assert "head sizes" in TM.v6_decode_shape_error(synth_config("6.0", 1, 256, 256, 128),
                                                    32, 64, 1024)
    assert "d_maa" in TM.v6_decode_shape_error(cfg, 30, 64, 1024)
    assert "v6" in TM.v6_decode_shape_error(synth_config("7.0", 1, 256, 256, 64), 32, 64, 1024)
