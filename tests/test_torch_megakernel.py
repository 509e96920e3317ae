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
