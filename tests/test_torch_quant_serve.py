"""``ServingModel`` from ggmf files and under ``quant`` / ``q8`` / ``q8r``
against the JAX package, on the CPU (K9's plain forms).

Bands, each against the largest value of the reference tensor:
- 1e-4 where every activation stays float32: ``q8`` (every matrix int8;
  the layers over a file's blocks with f32 dense leaves are held to it in
  ``test_torch_block_matmul.py``);
- 5e-3 for ``ServingModel(path, "quant")``, whose dense leaves (the head,
  v7's LoRAs) are bf16 as in JAX: a last-bit difference upstream can flip
  the bf16 rounding of an input element (the readings reach 6e-4);
- 1e-2 for ``q8r`` against JAX under its Pallas body in interpret mode,
  which rounds x to bf16 before every projection as the port does (flips
  again; readings to 3.8e-3); 2e-2 with equal argmax against JAX's XLA
  path, which keeps x in f32 (readings to 1.1e-2).
Greedy tokens must be equal where the band is 1e-4 or 5e-3 and for q8r in
interpret mode.

The version matrix (every file format, ``q8``, ``q8r`` against the XLA
path, the decode kernels' pack of a Q5_1 file) runs in
``test_torch_quant_serve_v{7,6,52,51,4}.py``, one file a version, through
the ``check_*`` functions here."""

import numpy as np
import pytest
import torch

from rwkv_tpu.models import serve as JSV
from rwkv_tpu.models.loader import load_params as j_load_params
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops import megakernel as JM
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models import serve as TSV
from rwkv_tpu_torch.models.loader import load_params
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

SHAPE = (2, 256, 256, 64)  # L, C, V, S
PROMPT = np.random.default_rng(0).integers(0, 256, 20)  # buckets 16 + 4


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - ref).max() / max(float(np.abs(ref).max()), 1e-30))


FILE_FORMATS = ["Q4_0", "Q4_1", "Q5_1", "Q8_0", "Q4_K"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one intra-op thread: the suite runs six
    workers on the host's cores, where each worker's default pool of
    spinning threads multiplies small ops' time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fp32_file(tmp_path_factory, version: str) -> str:
    """The synth model of `version` (seed 1) as an FP32 ggmf file."""
    cfg = synth_config(version, *SHAPE)
    path = str(tmp_path_factory.mktemp("quant_serve") / f"v{version}.bin")
    write_synth_ggmf(cfg, synth_params(cfg, seed=1), path)
    return path


@pytest.fixture(scope="module")
def fp32_files(tmp_path_factory):
    return {version: fp32_file(tmp_path_factory, version) for version in ("5.2", "7.0")}


def _quantized(src: str, tmp_path, fmt) -> str:
    path = str(tmp_path / f"{fmt}.bin")
    quantize_model_file(src, path, fmt, verbose=False)
    return path


def _serve_pair(jmodel, tmodel, band: float, n_decode: int = 8, tokens_equal: bool = True):
    """Prefill PROMPT, then n_decode greedy steps fed JAX's tokens: logits
    within `band` of their scale at every step, and (tokens_equal) the same
    greedy tokens; else the prefill's argmax equal."""
    jl, js = jmodel.prefill(PROMPT)
    tl, ts = tmodel.prefill(PROMPT)
    assert tl.shape == (256,) and _rel(tl, jl) < band
    assert int(tl.argmax()) == int(np.argmax(np.asarray(jl)))
    for _ in range(n_decode):
        tok = int(np.argmax(np.asarray(jl)))
        if tokens_equal:
            assert int(tl.argmax()) == tok
        jl, js = jmodel.decode(np.array([tok]), js)
        tl, ts = tmodel.decode([tok], ts)
        jl, tl = np.asarray(jl)[0], tl[0]
        assert _rel(tl, jl) < band
    for k in js:
        assert ts[k].shape == tuple(np.asarray(js[k]).shape), k


def check_quantized_file(src: str, tmp_path, fmt: str):
    """ServingModel(path, "quant") on the FP32 file `src` quantized to `fmt`
    against JAX's, within 5e-3 and with equal greedy tokens."""
    path = _quantized(src, tmp_path, fmt)
    jmodel = JSV.ServingModel(path, precision="quant")
    tmodel = TSV.ServingModel(path, precision="quant", device="cpu")
    assert tmodel.config.__dict__ == jmodel.config.__dict__
    head = tmodel.params["head"]
    assert isinstance(head, torch.Tensor) and head.dtype == torch.bfloat16  # the file keeps it FP32
    _serve_pair(jmodel, tmodel, 5e-3)


def _synth_pair(version, lora_dim=64):
    jc, tc = j_synth_config(version, *SHAPE), synth_config(version, *SHAPE)
    return (jc, j_synth_params(jc, seed=2, lora_dim=lora_dim)), (tc, synth_params(tc, seed=2, lora_dim=lora_dim))


def check_q8(version: str):
    """q8 (every matrix int8, activations f32) against JAX within 1e-4."""
    jsrc, tsrc = _synth_pair(version)
    tmodel = TSV.ServingModel(tsrc, precision="q8", device="cpu")
    assert tmodel.params["head"].form == tmodel.params["blocks"]["ffn.key.weight"].form == "plain"
    _serve_pair(JSV.ServingModel(jsrc, precision="q8"), tmodel, 1e-4)


def test_q8r_matches_jax_kernel_in_interpret_mode():
    """v7 at C=256 with LoRAs of 128: every projection's shape takes JAX's
    Pallas body, which rounds x to bf16 as K9's rowwise form does."""
    jsrc, tsrc = _synth_pair("7.0", lora_dim=128)
    jmodel = JSV.ServingModel(jsrc, precision="q8r")
    jmodel._mm_force = "interpret"  # traced into every quant_matmul (serve.py:679)
    tmodel = TSV.ServingModel(tsrc, precision="q8r", device="cpu")
    assert tmodel.params["blocks"]["att.w1"].form == "rowwise"
    _serve_pair(jmodel, tmodel, 1e-2)


def check_q8r_xla(version: str):
    """q8r against JAX's XLA path (x kept in f32) within 2e-2."""
    jsrc, tsrc = _synth_pair(version)
    _serve_pair(JSV.ServingModel(jsrc, precision="q8r"),
                TSV.ServingModel(tsrc, precision="q8r", device="cpu"), 2e-2, n_decode=4,
                tokens_equal=False)


def test_w8a8_on_a_quantized_file_keeps_the_blocks(fp32_files, tmp_path):
    """As in JAX, a file-quantized leaf keeps its blocks under w8a8 (K9's
    min form on a Q5_1 file); only dense leaves become w8a8 rows (K1)."""
    path = _quantized(fp32_files["5.2"], tmp_path, "Q5_1")
    tmodel = TSV.ServingModel(path, precision="w8a8", device="cpu")
    assert tmodel.params["blocks"]["att.key.weight"].form == "min"
    assert tmodel.params["head"].form == "w8a8"
    _serve_pair(JSV.ServingModel(path, precision="w8a8"), tmodel, 5e-3, n_decode=4)


_J_BUILD = {7: JM.build_mega_pack, 6: JM.build_mega_pack_v6, 5: JM.build_mega_pack_v5,
            4: JM.build_mega_pack_v4}
_T_BUILD = {7: TM.build_mega_pack, 6: TM.build_mega_pack_v6, 5: TM.build_mega_pack_v5,
            4: TM.build_mega_pack_v4}


def check_megakernel_pack(src: str, tmp_path):
    """The decode kernels' w8 pack of a Q5_1 file (the blocks dequantized
    on the host, then rowwise int8): codes and row scales equal JAX's
    build_mega_pack*(quant=True, head=True) on the same loaded params."""
    path = _quantized(src, tmp_path, "Q5_1")
    (jc, jp), (tc, tp) = j_load_params(path), load_params(path)
    major = tc.version_major
    jpack, tpack = _J_BUILD[major](jp, jc, quant=True, head=True), _T_BUILD[major](tp, tc)
    mat_keys = TM._layout(tpack)[0]
    for name in mat_keys + ("head8",):
        np.testing.assert_array_equal(tpack[name].numpy(), np.asarray(jpack[name]), err_msg=name)
        dkey = "head_d" if name == "head8" else name + "_d"
        np.testing.assert_array_equal(tpack[dkey].numpy().reshape(-1),
                                      np.asarray(jpack[dkey]).reshape(-1), err_msg=dkey)


@pytest.mark.parametrize("precision", ["quant", "q8r"])
def test_megakernel_on_a_quantized_file_decodes_through_the_w8_pack(fp32_files, tmp_path, precision):
    """megakernel=True on a Q5_1 v7 file: prefill on K9's plain forms, B=1
    decode on K3's plain version over the w8 pack of the dequantized
    weights, equal to v7_decode_step_ref on that pack."""
    path = _quantized(fp32_files["7.0"], tmp_path, "Q5_1")
    model = TSV.ServingModel(path, precision=precision, megakernel=True, device="cpu")
    assert model._mega_k3 and not model._mega["w4"]
    logits, state = model.prefill(PROMPT)
    tok = torch.tensor([int(logits.argmax())])
    lg, new = model.decode(tok, state)
    ref_lg, ref_new = TM.v7_decode_step_ref(model._mega, {k: v[0] for k, v in state.items()},
                                            tok, model.config)
    torch.testing.assert_close(lg[0], ref_lg, rtol=0, atol=0)
    for k in ref_new:
        torch.testing.assert_close(new[k][0], ref_new[k], rtol=0, atol=0)
    assert bool(torch.isfinite(lg).all())


def test_megakernel_refuses_the_dense_precisions(fp32_files):
    """The dense precisions are no longer refused under megakernel=True: an
    FP32 file under bf16 and f32 decodes through the bf16 pack of its f32
    weights (bit-equal to JAX's quant=False pack). What the decode kernels
    still refuse is a shape they cannot take (S=128 here)."""
    (jc, jp), (tc, tp) = j_load_params(fp32_files["7.0"]), load_params(fp32_files["7.0"])
    jpack = JM.build_mega_pack(jp, jc, quant=False, head=True)
    for precision in ("bf16", "f32"):
        model = TSV.ServingModel(fp32_files["7.0"], precision=precision, megakernel=True,
                                 device="cpu")
        assert model._mega["form"] == "bf16" and model._mega_k3
        for name in TM.MAT_KEYS + ("headbf16",):
            np.testing.assert_array_equal(model._mega[name].view(torch.int16).numpy(),
                                          np.asarray(jpack[name]).view(np.int16), err_msg=name)
    cfg = synth_config("7.0", 2, 256, 256, 128)
    with pytest.raises(NotImplementedError, match="head sizes"):
        TSV.ServingModel((cfg, synth_params(cfg, seed=0)), precision="bf16", megakernel=True,
                         device="cpu")
