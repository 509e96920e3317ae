"""The port's v5 (v5.1, v5.2) and v4 decode packs and B=1 decode steps
(kernels K7's and K8's plain versions) against the JAX package's
build_mega_pack_v5 / _v4, its whole-layer kernels v5_decode_megakernel /
v4_decode_megakernel (a rowified pack with the in-kernel head) and its
tiled kernels v5_decode_megakernel_tiled / v4_decode_megakernel_tiled (a
retiled pack with small explicit tiles), w8 and w4, run in interpret
mode."""

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

VERSIONS = ("4.0", "5.1", "5.2")
L, C, H, S = 2, 256, 4, 64
TOL = dict(rtol=2e-2, atol=2e-2)  # int8 codes may flip at .5 under ulp-level differences


@pytest.fixture(scope="module", params=VERSIONS)
def model45(request):
    small = (request.param, L, C, 256, S)
    jc, tc = j_synth_config(*small), synth_config(*small)
    jp = j_synth_params(jc, seed=9)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    v5 = tc.version_major == 5
    j_build = JM.build_mega_pack_v5 if v5 else JM.build_mega_pack_v4
    t_build = TM.build_mega_pack_v5 if v5 else TM.build_mega_pack_v4
    packs = {w4: (j_build(jp, jc, quant=True, w4=w4, head=True), t_build(tp, tc, w4=w4))
             for w4 in (False, True)}
    return jc, tc, jp, tp, packs


def _mat_keys(tc):
    return TM.V5_MAT_KEYS if tc.version_major == 5 else TM.V4_MAT_KEYS


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("index", range(6))
def test_v45_pack_codes_and_scales_bit_equal_jax(model45, index, w4):
    """Each of the five matrices and the head: codes and row scales equal
    JAX's; int4 values (|code| <= 7) exactly for the five under w4."""
    _, tc, _, _, packs = model45
    jpack, tpack = packs[w4]
    name = (_mat_keys(tc) + ("head8",))[index]
    np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]))
    dkey = "head_d" if name == "head8" else name + "_d"
    np.testing.assert_array_equal(tpack[dkey].numpy().reshape(-1),
                                  np.asarray(jpack[dkey]).reshape(-1))
    assert (int(np.abs(tpack[name].numpy()).max()) <= 7) == (w4 and name != "head8")


def test_v45_pack_vectors_equal_jax(model45):
    """The vectors, the mixes (amix k, v, r(, g); fmix k, r) and the static
    decay and bonus, v5.1's per-head scalars broadcast over S as JAX's
    pack does; the gate flag."""
    _, tc, _, _, packs = model45
    jpack, tpack = packs[False]
    keys = ["ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias", "amix", "fmix", "td", "tf"]
    if tc.version_major == 5:
        keys += ["att.ln_x.weight", "att.ln_x.bias"]
        assert tpack["has_gate"] == jpack["has_gate"] == (tc.version_minor == 2)
        assert tpack["amix"].shape == (L, 4 if tc.version_minor == 2 else 3, C)
    for key in keys:
        np.testing.assert_array_equal(tpack[key].numpy().reshape(L, -1),
                                      np.asarray(jpack[key]).reshape(L, -1), err_msg=key)
        assert tpack[key].dtype == torch.float32, key
    assert tpack["f_dim"] == jpack["f_dim"] == 4 * C


@pytest.mark.parametrize("w4", [False, True])
def test_v45_device_pack_views_share_flat_buffers(model45, w4):
    _, tc, _, tp, packs = model45
    tpack = packs[w4][1]
    dp = TM.device_pack(tpack, tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    f = tpack["f_dim"]
    n_att = tpack["amix"].shape[1]
    big = n_att * C * C + 2 * C * C + 2 * f * C  # att; out, fr; fk, fv
    assert dp["mats"].shape == (L, big // 2 if w4 else big)
    assert dp["scales"].shape == (L, n_att * C + 3 * C + f)
    n_vec = 8 + n_att + (2 if tc.version_major == 5 else 0)
    assert dp["vecs"].shape == (L, n_vec, C)
    for name in _mat_keys(tc):
        assert torch.equal(TM._codes(dp, name, 1), tpack[name][1]), name
        assert torch.equal(dp[name + "_d"], tpack[name + "_d"])
        assert dp[name].untyped_storage().data_ptr() == dp["mats"].untyped_storage().data_ptr()
    for key in ("ln1.weight", "ln2.bias", "amix", "fmix", "td", "tf"):
        assert torch.equal(dp[key], tpack[key]), key
    assert dp["version"] == tc.version_major


def _rand_state(tc, seed, blank=False):
    rng = np.random.default_rng(seed)
    st = {"att_xx": rng.standard_normal((L, C)).astype(np.float32) * 0.5,
          "ffn_xx": rng.standard_normal((L, C)).astype(np.float32) * 0.5}
    if tc.version_major == 5:
        st["heads"] = rng.standard_normal((L, H, S, S)).astype(np.float32) * 0.1
    elif blank:
        st.update(aa=np.zeros((L, C), np.float32), bb=np.zeros((L, C), np.float32),
                  pp=np.full((L, C), -1e30, np.float32))
    else:
        st.update(aa=rng.standard_normal((L, C)).astype(np.float32),
                  bb=(np.abs(rng.standard_normal((L, C))) + 0.5).astype(np.float32),
                  pp=rng.standard_normal((L, C)).astype(np.float32))
    return st


def _x0(tp, token):
    """ln0 of the bf16 embedding row, as JAX serves it: [C, 1]."""
    emb = np.asarray(jnp.asarray(np.asarray(tp["emb"]), jnp.bfloat16).astype(jnp.float32))
    ln0 = [jnp.asarray(x.numpy()) for x in tp["ln0"]]
    return j_layer_norm(jnp.asarray(emb[token]), *ln0)[:, None]


def _port_step(model45, w4, st, token):
    _, tc, _, tp, packs = model45
    dp = TM.device_pack(packs[w4][1], tp["emb"].to(torch.bfloat16), tp["ln0"], "cpu")
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    v5 = tc.version_major == 5
    step = TM.v5_decode_step if v5 else TM.v4_decode_step
    layers = TM.v5_decode_layers_ref if v5 else TM.v4_decode_layers_ref
    before = step.launches
    logits, new = step(dp, state, torch.tensor([token]), tc)
    assert step.launches == before  # CPU: the plain version, no launch
    x, _ = layers(dp, state, torch.tensor([token]), tc)
    for k, v in st.items():
        np.testing.assert_array_equal(state[k].numpy(), v)  # input untouched
    return x, logits, new


def _hold(x, logits, new, y_ref, logits_ref, new_ref):
    np.testing.assert_allclose(x.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(logits.numpy(), logits_ref, **TOL)
    assert int(logits.argmax()) == int(np.argmax(logits_ref))
    assert new.keys() == new_ref.keys()
    for k in new_ref:
        assert bool(torch.isfinite(new[k]).all()), k
        np.testing.assert_allclose(new[k].numpy(), new_ref[k], err_msg=k, **TOL)


def _state_out(tc, j_new, reshape):
    out = {k: reshape(np.asarray(v)) for k, v in j_new.items() if k != "heads"}
    if "heads" in j_new:
        out["heads"] = np.swapaxes(np.asarray(j_new["heads"]).reshape(L, H, S, S), -1, -2)
    return out


@pytest.mark.parametrize("w4", [False, True])
def test_v45_decode_step_ref_matches_jax_whole_layer_kernel(model45, w4):
    """Against v5_decode_megakernel / v4_decode_megakernel on a rowified
    pack with the in-kernel head (row-layout token-shift state, transposed
    heads); under w4 the same kernel over the pack's int4 codes. The
    states are ones where no activation code sits at a .5 boundary: from
    seed 4, v5.2 under w4 flips one code and x moves by 0.021."""
    jc, tc, _, tp, packs = model45
    st = _rand_state(tc, 3)
    token = 41 + w4
    v5 = tc.version_major == 5
    rows = (JM.rowify_mega_pack_v5 if v5 else JM.rowify_mega_pack_v4)(packs[w4][0])
    state_t = {k: jnp.asarray(v)[:, None, :] for k, v in st.items() if k != "heads"}
    if v5:
        state_t["heads"] = jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2)
    kernel = JM.v5_decode_megakernel if v5 else JM.v4_decode_megakernel
    y, j_new, j_logits = kernel(rows, state_t, _x0(tp, token), jc, interpret=True)
    new_ref = _state_out(tc, j_new, lambda a: a[:, 0])
    _hold(*_port_step(model45, w4, st, token), np.asarray(y)[:, 0], np.asarray(j_logits),
          new_ref)


@pytest.mark.parametrize("w4", [False, True])
def test_v45_decode_step_ref_matches_jax_tiled_kernel(model45, w4):
    """Against v5_decode_megakernel_tiled / v4_decode_megakernel_tiled on a
    retiled pack with explicit small tiles (att and out rows in two tiles
    each, v5's heads in two groups; split-half nibbles under w4); its
    logits are JAX's per-op head (ln_out, then the w8a8 head), as its
    serving runs it. v4 starts from the blank state (pp = -1e30). One FFN
    tile: with nf > 1 the tiled kernels quantize each tile's slice of the
    relu^2 keys on its own, where the whole-layer kernel and the port
    quantize the whole vector."""
    jc, tc, jp, tp, packs = model45
    st = _rand_state(tc, 5 + w4, blank=True)
    token = 100 + w4
    v5 = tc.version_major == 5
    if v5:
        n_mix = 4 if tc.version_minor == 2 else 3
        tiled = JM.retile_mega_pack_v5(packs[w4][0], jc, nh=2, nf=1, ng=2 * n_mix, no=2)
        tiled["nh"] = 2
    else:
        tiled = JM.retile_mega_pack_v4(packs[w4][0], jc, nf=1, nr=6, no=2)
    state_t = {k: jnp.asarray(v)[..., None] for k, v in st.items() if k != "heads"}
    if v5:
        state_t["heads"] = jnp.swapaxes(jnp.asarray(st["heads"]), -1, -2).reshape(
            L, 2, H // 2, S, S)
    kernel = JM.v5_decode_megakernel_tiled if v5 else JM.v4_decode_megakernel_tiled
    y, j_new = kernel(tiled, state_t, _x0(tp, token), jc, interpret=True)
    y = jnp.asarray(y).reshape(-1)
    head = quantize_q8_serving(jp["head"].w, rowwise=True, int8_act=True)
    j_logits = JG.mm(j_layer_norm(y, *jp["ln_out"])[None, :], head)[0]
    new_ref = _state_out(tc, j_new, lambda a: a.reshape(L, -1))
    _hold(*_port_step(model45, w4, st, token), np.asarray(y), np.asarray(j_logits), new_ref)


def test_v45_decode_shape_errors_name_what_k7_and_k8_refuse():
    v5, v4 = synth_config("5.2", 1, 256, 256, 64), synth_config("4.0", 1, 768, 256, 64)
    assert TM.v5_decode_shape_error(v5, 1024) is None
    assert TM.v4_decode_shape_error(v4, 3072, w4=True) is None
    assert "head sizes" in TM.v5_decode_shape_error(synth_config("5.2", 1, 256, 256, 128), 1024)
    assert "multiples of 16" in TM.v4_decode_shape_error(v4, 3000)
    assert "int4" in TM.v4_decode_shape_error(synth_config("4.0", 1, 784, 256, 64), 3136, True)
    assert "v5" in TM.v5_decode_shape_error(v4, 3072)
    assert "v4" in TM.v4_decode_shape_error(v5, 1024)
