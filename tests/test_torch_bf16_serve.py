"""``ServingModel(..., precision="bf16" | "f32", megakernel=True)`` against
the JAX package's, whose decode runs its quant=False kernels in interpret
mode: B=1 on v4, v5.1, v5.2, v6 and v7 (the plain versions of K8, K7, K6
and K3 in their bf16 form here) and B = 2 and 3 on v7 (K4's plain version
and the per-op head in the model's dtype; JAX's lane-packed batched
kernel), each from the same seeded state; and ``graph.forward`` on FP32
and FP16 model files against JAX's.

The decode routes hold BAND of the scale (max |x - ref| over max(1,
max |ref|)) with equal greedy tokens: no activation codes, only the order
of f32 sums differs. ``graph.forward`` holds 1e-5 (f32 throughout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models.loader import load_params as j_load_params
from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.state import init_state as j_init_state
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models import graph as TG
from rwkv_tpu_torch.models.loader import load_params
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.state import init_state
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf
from test_torch_bf16_megakernel import SMALL, _rand_state, _rel
from test_torch_models import jax_tree_to_numpy

BAND = 1e-4
_REF = {7: TM.v7_decode_step_ref, 6: TM.v6_decode_step_ref, 5: TM.v5_decode_step_ref,
        4: TM.v4_decode_step_ref}


def _engines(version, precision):
    jc, tc = j_synth_config(*SMALL[version]), synth_config(*SMALL[version])
    kw = {"lora_dim": 32} if version == "7.0" else {}
    jp = j_synth_params(jc, seed=17, **kw)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    jsrv = JServingModel((jc, jp), precision=precision, megakernel=True)
    srv = ServingModel((tc, tp), precision=precision, megakernel=True, device="cpu")
    return tc, jsrv, srv


def _steps(jsrv, srv, st, first, n_steps, what):
    """Greedy decode of both engines from the serving-layout numpy state
    `st` and tokens `first` [B]; every step's logits and state within
    BAND, equal tokens."""
    j_state = {k: jnp.asarray(v) for k, v in st.items()}
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    toks = np.asarray(first)
    for step in range(n_steps):
        j_lg, j_state = jsrv.decode(toks, j_state)
        lg, state = srv.decode(toks, state)
        for name, a, ref in [("logits", lg, j_lg)] + [(k, state[k], j_state[k]) for k in j_state]:
            r = _rel(a.numpy(), np.asarray(ref))
            assert r <= BAND, f"{what} step {step} {name}: {r:.3e} of the scale (band {BAND})"
        toks = np.asarray(j_lg).argmax(-1)
        assert lg.argmax(-1).tolist() == toks.tolist(), (what, step)
    return lg


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("version", tuple(SMALL))
def test_bf16_pack_b1_route_matches_jax(version, precision):
    """B=1 through the bf16 form of K3 / K6 / K7 / K8 (their plain versions
    on the CPU, the wrapper's route): 4 greedy steps against JAX's
    whole-layer quant=False kernel with the bf16 head. Under f32 the
    kernels embed from the f32 table, as JAX does."""
    tc, jsrv, srv = _engines(version, precision)
    assert srv._mega["form"] == "bf16"
    assert srv._mega["emb"].dtype == (torch.float32 if precision == "f32" else torch.bfloat16)
    st = {k: v[None] for k, v in _rand_state(tc, 7).items()}
    lg = _steps(jsrv, srv, st, [29], 4, f"v{version} {precision} B=1")
    # the route is the decode step's (its plain version on CPU tensors)
    state = {k: torch.from_numpy(v[0]) for k, v in st.items()}
    ref, _ = _REF[tc.version_major](srv._mega, state, torch.tensor([29]), tc)
    lg1, _ = srv.decode([29], {k: v[None] for k, v in state.items()})
    torch.testing.assert_close(lg1[0], ref, rtol=0, atol=0)
    assert lg.shape == (1, tc.n_vocab)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("batch", [2, 3])
def test_bf16_pack_batched_route_matches_jax(batch, precision):
    """v7 at B = 2 and 3 under megakernel=True: K4's plain version in the
    bf16 form, then ln_out and the per-op head in the model's dtype (bf16
    rows against bf16-rounded activations, or f32); JAX (mega_min_batch =
    2) runs its lane-packed batched kernel and the same head."""
    tc, jsrv, srv = _engines("7.0", precision)
    jsrv.mega_min_batch = 2
    assert srv.mega_min_batch == 2 and srv.params["head"].dtype == (
        torch.float32 if precision == "f32" else torch.bfloat16)
    st = _rand_state(tc, 30 + batch, batch)
    first = np.random.default_rng(batch).integers(0, tc.n_vocab, batch)
    before = dict(TM.v7_decode_batched.launches_by_form)
    lg = _steps(jsrv, srv, st, first, 3, f"v7 {precision} B={batch}")
    assert lg.shape == (batch, tc.n_vocab)
    assert TM.v7_decode_batched.launches_by_form == before  # CPU: the plain version


@pytest.fixture(scope="module")
def dense_files(tmp_path_factory):
    """v7 and v6 synth models written as FP32 and FP16 ggmf files."""
    root = tmp_path_factory.mktemp("dense_files")
    out = {}
    for version, shape in (("7.0", (2, 128, 256, 32)), ("6.0", (2, 256, 256, 64))):
        cfg = synth_config(version, *shape)
        params = synth_params(cfg, seed=5)
        for fmt in ("FP32", "FP16"):
            path = root / f"v{version}-{fmt}.bin"
            write_synth_ggmf(cfg, params, str(path), fmt)
            out[(version, fmt)] = str(path)
    return out


@pytest.mark.parametrize("fmt", ["FP32", "FP16"])
@pytest.mark.parametrize("version", ["7.0", "6.0"])
def test_graph_forward_on_a_dense_file_matches_jax(dense_files, version, fmt):
    """graph.forward on a loaded FP32 / FP16 file (dense ``Weight`` leaves:
    f32 at full precision, FP16 weights converted to f32 against raw f32
    activations) against JAX's graph.forward: a 5-token prompt, then two
    single tokens, logits and state within 1e-5 of their scale."""
    path = dense_files[(version, fmt)]
    (jc, jp), (tc, tp) = j_load_params(path), load_params(path)
    assert tp["head"].kind == "dense" and tp["head"].w.dtype == (
        torch.float16 if fmt == "FP16" else torch.float32)
    j_state, state = j_init_state(jc), init_state(tc, "cpu")
    for toks in ([3, 17, 200, 9, 41], [77], [5]):
        j_lg, j_state = JG.forward(jp, j_state, jnp.asarray(toks, jnp.int32), jc)
        lg, state = TG.forward(tp, state, torch.tensor(toks), tc)
        for name, a, ref in [("logits", lg, j_lg)] + [(k, state[k], j_state[k]) for k in j_state]:
            r = _rel(a.numpy(), np.asarray(ref))
            assert r <= 1e-5, f"v{version} {fmt} {name}: {r:.3e} of the scale"
