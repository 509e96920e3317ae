"""The port's compatibility layer, tokenizers and tools against the JAX
package's: ``compat`` (flags, errors, caller buffers), the World and 20B
tokenizers, ``convert_checkpoint``, the quantize CLI and ``merge_lora``
(byte-equal files from .pth / .safetensors checkpoints the test writes for
v4, v5.2, v6 and v7), ``measure_perplexity``, the seeded generation loop,
``_ServeAdapter`` and ``ChatSession``'s snapshot / restore."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rwkv_tpu.compat as JC
import rwkv_tpu.tools.generate_completions as JGEN
from rwkv_tpu.io.quantize import quantize_model_file as j_quantize_model_file
from rwkv_tpu.models.model import RWKVModel as JaxModel
from rwkv_tpu.models.serve import ServingModel as JaxServingModel
from rwkv_tpu.tools.chat_with_bot import ChatSession as JaxChatSession
from rwkv_tpu.tools.convert_checkpoint import convert as j_convert
from rwkv_tpu.tools.measure_perplexity import measure_perplexity as j_measure_perplexity
from rwkv_tpu.tools.merge_lora import _preprocess_replacement as j_preprocess
from rwkv_tpu.tools.merge_lora import merge_lora as j_merge_lora
from rwkv_tpu.utils.world_tokenizer import WorldTokenizer as JaxWorldTokenizer
import rwkv_tpu_torch.compat as TC
import rwkv_tpu_torch.tools.generate_completions as TGEN
from rwkv_tpu_torch.models.model import RWKVModel
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.tools import quantize as TQ
from rwkv_tpu_torch.tools.chat_with_bot import PROMPTS_DIR, ChatSession
from rwkv_tpu_torch.tools.convert_checkpoint import convert, detect_checkpoint_version
from rwkv_tpu_torch.tools.measure_perplexity import measure_perplexity
from rwkv_tpu_torch.tools.merge_lora import _preprocess_replacement, merge_lora
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf
from rwkv_tpu_torch.utils.tokenizer import get_tokenizer
from rwkv_tpu_torch.utils.world_tokenizer import WorldTokenizer

REPO = Path(__file__).resolve().parent.parent
SHAPE = (2, 256, 256, 64)  # L, C, V, S
CKPT_VERSIONS = ["4.0", "5.2", "6.0", "7.0"]
_LOW_RANK = ("att.w1", "att.a1", "att.g1", "att.v1", "att.time_maa_w1", "att.time_decay_w1",
             "att.w2", "att.a2", "att.g2", "att.v2", "att.time_decay_w2")
_MIXES = ("att.w0", "att.a0", "att.v0", "att.k_k", "att.k_a")


def checkpoint(version: str, seed: int = 5) -> dict:
    """A state dict in the checkpoint layout the converter reads, from the
    synth tree of `version`: mixes as [1, 1, C], v7's six x_* mixes apart,
    low-rank pairs and v6's maa / decay LoRAs transposed, v7 block 0 with
    the v0 / v1 / v2 the converter drops."""
    cfg = synth_config(version, *SHAPE)
    p = synth_params(cfg, seed=seed)
    c = cfg.n_embed
    sd = {"emb.weight": p["emb"]}
    for i, block in enumerate(p["blocks"]):
        pre = f"blocks.{i}."
        if i == 0:
            sd[pre + "ln0.weight"], sd[pre + "ln0.bias"] = p["ln0"]
        for k, v in block.items():
            v = np.asarray(v, np.float32)
            if k == "att.x_rwkvag":
                for j, name in enumerate("rwkvag"):
                    sd[pre + f"att.x_{name}"] = v[j].reshape(1, 1, c)
            elif k in _LOW_RANK:
                sd[pre + k] = v.T
            elif k == "att.time_maa_w2":
                sd[pre + k] = np.swapaxes(v, 1, 2)
            elif k == "att.time_decay" and version == "6.0":
                sd[pre + k] = v.reshape(1, 1, c)
            elif v.ndim == 1 and (".time_" in "." + k or ".x_" in "." + k or k in _MIXES):
                sd[pre + k] = v.reshape(1, 1, c)
            else:
                sd[pre + k] = v
        if version == "7.0" and i == 0:
            r = np.random.default_rng(seed)
            sd[pre + "att.v0"] = r.standard_normal((1, 1, c)).astype(np.float32)
            sd[pre + "att.v1"] = r.standard_normal((c, 32)).astype(np.float32)
            sd[pre + "att.v2"] = r.standard_normal((32, c)).astype(np.float32)
    sd["ln_out.weight"], sd["ln_out.bias"] = p["ln_out"]
    sd["head.weight"] = p["head"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Each version's checkpoint as .pth and .safetensors."""
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for version in CKPT_VERSIONS:
        sd = checkpoint(version)
        out[version, "pth"] = str(d / f"v{version}.pth")
        torch.save(sd, out[version, "pth"])
        out[version, "safetensors"] = str(d / f"v{version}.safetensors")
        save_file(sd, out[version, "safetensors"])
    return out


def _bytes(path) -> bytes:
    return Path(path).read_bytes()


@pytest.mark.parametrize("kind", ["pth", "safetensors"])
@pytest.mark.parametrize("dtype", ["FP32", "FP16"])
@pytest.mark.parametrize("version", CKPT_VERSIONS)
def test_convert_is_byte_equal_to_jax(ckpts, tmp_path, version, dtype, kind):
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    convert(ckpts[version, kind], str(ours), dtype)
    j_convert(ckpts[version, kind], str(theirs), dtype)
    assert _bytes(ours) == _bytes(theirs)


@pytest.mark.parametrize("version", CKPT_VERSIONS)
def test_converted_file_runs_in_the_port(ckpts, tmp_path, version):
    path = tmp_path / "m.bin"
    convert(ckpts[version, "pth"], str(path), "FP32")
    m = RWKVModel(str(path), device="cpu")
    assert detect_checkpoint_version(
        {k: v.numpy() for k, v in torch.load(ckpts[version, "pth"]).items()}) == version
    assert m.config.version_major == int(version[0])
    logits, _ = m.eval_sequence([1, 2, 3])
    assert logits.shape == (SHAPE[2],) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("fmt", ["Q4_0", "Q5_1", "Q8_0", "Q4_K"])
@pytest.mark.parametrize("version", CKPT_VERSIONS)
def test_quantize_cli_is_byte_equal_to_jax(ckpts, tmp_path, capsys, version, fmt):
    src, ours, theirs = tmp_path / "f32.bin", tmp_path / "ours.bin", tmp_path / "theirs.bin"
    convert(ckpts[version, "pth"], str(src), "FP32")
    TQ.main([str(src), str(ours), fmt, "--quiet"])
    assert "Quantized in" in capsys.readouterr().out
    j_quantize_model_file(str(src), str(theirs), fmt, verbose=False)
    assert _bytes(ours) == _bytes(theirs)


def _lora(version: str) -> tuple[str, dict]:
    """(arch argument, LoRA state dict): low-rank pairs with and without the
    '.weight' suffix, whole-tensor replacements that run each version's
    preprocessing, and one unused key. v6's time_faaaa replacement in block
    0 comes before block 1's time_decay in the file, so the JAX package's
    head-count hint is fresh there."""
    c = SHAPE[1]
    h = c // SHAPE[3]
    g = torch.Generator().manual_seed(11)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    lora = {"blocks.0.att.key.lora_A.weight": r(8, c), "blocks.0.att.key.lora_B.weight": r(c, 8),
            "blocks.1.ffn.value.lora_A": r(4, 4 * c), "blocks.1.ffn.value.lora_B": r(c, 4),
            "blocks.1.att.output.weight": r(c, c), "not.in.the.model": r(3)}
    if version == "4.0":
        lora.update({"blocks.0.att.time_decay": r(c), "blocks.1.att.time_first": r(c)})
        return "v4", lora
    if version == "5.2":
        lora.update({"blocks.0.att.time_decay": r(h, SHAPE[3]),
                     "blocks.1.att.time_faaaa": r(h, SHAPE[3])})
        return "v5.2", lora
    if version == "6.0":
        lora.update({"blocks.0.att.time_maa_w2": r(5, 32, c),
                     "blocks.0.att.time_faaaa": r(h, SHAPE[3]),
                     "blocks.0.att.time_maa_w1": r(c, 160),
                     "blocks.1.att.time_decay": r(1, 1, c),
                     "blocks.1.att.time_decay_w2": r(64, c)})
        return "v6.0", lora
    # v7 names carry no '.time_' part, so no arch-specific rule applies
    lora.update({"blocks.1.att.w1": r(64, c)})
    return "v7.0", lora


@pytest.mark.parametrize("dtype", ["FP32", "FP16"])
@pytest.mark.parametrize("version", CKPT_VERSIONS)
def test_merge_lora_is_byte_equal_to_jax(ckpts, tmp_path, capsys, version, dtype):
    base, lora_path = tmp_path / "base.bin", tmp_path / "lora.pth"
    convert(ckpts[version, "pth"], str(base), dtype)
    arch, lora = _lora(version)
    torch.save(lora, str(lora_path))
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    merge_lora(str(base), arch, str(lora_path), 16, str(ours))
    log = capsys.readouterr().out
    assert "WARNING: Unused parameter in LoRA state dict not.in.the.model" in log
    assert log.count("Merged LoRA into parameter") == 2
    j_merge_lora(str(base), arch, str(lora_path), 16, str(theirs))
    assert _bytes(ours) == _bytes(theirs) != _bytes(base)


def test_merge_lora_v6_time_decay_takes_the_model_head_count():
    """The head count comes from the replaced tensor: JAX's rule with a
    fresh hint, whatever an earlier call left in JAX's mutable default."""
    t = np.random.default_rng(2).standard_normal((1, 1, 256)).astype(np.float32)
    ours = _preprocess_replacement("blocks.3.att.time_decay", t, "v6.0", (4, 64, 1))
    np.testing.assert_array_equal(ours, j_preprocess("blocks.3.att.time_decay", t, "v6.0", [4]))
    assert ours.shape == (4, 64, 1)
    ours8 = _preprocess_replacement("blocks.3.att.time_decay", t, "v6.0", (8, 32, 1))
    np.testing.assert_array_equal(ours8, t.reshape(8, 32, 1))


# -- compat ------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_file(tmp_path_factory):
    """The v7 synth model (seed 3) as an FP32 file."""
    cfg = synth_config("7.0", *SHAPE)
    path = str(tmp_path_factory.mktemp("fp32") / "v7.bin")
    write_synth_ggmf(cfg, synth_params(cfg, seed=3), path)
    return path


@pytest.fixture(scope="module")
def jax_model(fp32_file):
    """One JAX model shared by the tests below, so each T compiles once."""
    return JaxModel(fp32_file)


def test_compat_constants_match_jax():
    assert TC.QUANTIZED_FORMAT_NAMES == JC.QUANTIZED_FORMAT_NAMES
    assert {f.name: int(f) for f in TC.rwkv_error_flags} == \
        {f.name: int(f) for f in JC.rwkv_error_flags}
    assert isinstance(TC.load_rwkv_shared_library(), TC.RWKVSharedLibrary)
    info = TC.get_system_info_string()
    assert f"torch={torch.__version__}" in info and "devices=" in info


def test_compat_errors(fp32_file, tmp_path):
    with pytest.raises(TC.RWKVError) as e:
        TC.RWKVModel(TC.load_rwkv_shared_library(), "", device="cpu")
    assert e.value.flags == TC.rwkv_error_flags.RWKV_ERROR_ARGS
    with pytest.raises(TC.RWKVError) as e:
        TC.RWKVModel(str(tmp_path / "missing.bin"), device="cpu")
    assert e.value.flags == TC.rwkv_error_flags.RWKV_ERROR_FILE_OPEN
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"not a model file at all, just some bytes")
    with pytest.raises(TC.RWKVError) as e:
        TC.RWKVModel(str(bad), device="cpu")
    assert e.value.flags == TC.rwkv_error_flags.RWKV_ERROR_FILE

    m = TC.RWKVModel(fp32_file, device="cpu")
    n = m._state_buffer_element_count
    cases = [
        (np.zeros(n, np.float64), TC.rwkv_error_flags.RWKV_ERROR_DATA_TYPE),
        (np.zeros(n + 1, np.float32), TC.rwkv_error_flags.RWKV_ERROR_SHAPE),
        (torch.zeros(n, dtype=torch.float64), TC.rwkv_error_flags.RWKV_ERROR_DATA_TYPE),
        (torch.zeros(2, n, dtype=torch.float32).t(), TC.rwkv_error_flags.RWKV_ERROR_DATA),
        (torch.zeros(n, dtype=torch.float32, device="meta"), TC.rwkv_error_flags.RWKV_ERROR_DATA),
        (torch.zeros(n - 1, dtype=torch.float32), TC.rwkv_error_flags.RWKV_ERROR_SHAPE),
    ]
    for buf, flag in cases:
        with pytest.raises(TC.RWKVError) as e:
            m.eval(1, state_in=buf)
        assert e.value.flags == flag
    m.free()
    with pytest.raises(TC.RWKVError) as e:
        m.eval(1)
    assert e.value.flags == TC.rwkv_error_flags.RWKV_ERROR_CTX


def test_compat_buffers_match_jax(fp32_file, jax_model):
    """Flat logits and state equal the JAX wrapper's within 1e-5 of the
    scale; caller buffers are written in place; use_numpy=False returns
    tensors; the three eval entry points chain through flat states."""
    m = TC.RWKVModel(fp32_file, device="cpu")
    j = JC.RWKVModel(fp32_file)
    j._model = jax_model
    assert (m.n_vocab, m.n_embed, m.n_layer) == (j.n_vocab, j.n_embed, j.n_layer)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5 * np.abs(b).max()

    lt, st = m.eval_sequence_in_chunks([1, 2, 3, 4, 5], chunk_size=16)
    lj, sj = j.eval_sequence_in_chunks([1, 2, 3, 4, 5], chunk_size=16)
    close(lt, lj)
    close(st, sj)
    state_out = np.empty(m._state_buffer_element_count, np.float32)
    logits_out = torch.empty(m._logits_buffer_element_count, dtype=torch.float32)
    rl, rs = m.eval(7, state_in=st, state_out=state_out, logits_out=logits_out)
    assert rs is state_out and rl is logits_out
    lj, sj = j.eval(7, state_in=sj)
    close(logits_out.numpy(), lj)
    close(state_out, sj)
    lt, st = m.eval_sequence([9, 10], state_in=torch.from_numpy(state_out), use_numpy=False)
    assert isinstance(lt, torch.Tensor) and isinstance(st, torch.Tensor)
    lj, sj = j.eval_sequence([9, 10], state_in=sj)
    close(lt.numpy(), lj)
    close(st.numpy(), sj)


_NO_CARD = r"""
import sys, torch
assert not torch.cuda.is_available()
from rwkv_tpu_torch.compat import RWKVModel
try:
    RWKVModel(sys.argv[1])
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("compat.RWKVModel ran without a card instead of raising")
print("ok")
"""


def test_compat_without_a_card_raises(fp32_file):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_CARD, fp32_file], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr


# -- tokenizers --------------------------------------------------------------

TEXTS = {
    "ascii": "Hello, world! The quick brown fox jumps over the lazy dog.\n\n  1234 ",
    "cjk": "你好，世界。これは日本語のテキストです。한국어 문장.",
    "emoji": "emoji 🙂👍🏽 and 🚀 rocket",
}


@pytest.fixture(scope="module")
def world_pair():
    return WorldTokenizer(), JaxWorldTokenizer()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_world_tokenizer_matches_jax(world_pair, name):
    ours, theirs = world_pair
    toks = ours.encode(TEXTS[name])
    assert toks == theirs.encode(TEXTS[name])
    assert ours.decode(toks) == TEXTS[name] == theirs.decode(toks)


def test_world_tokenizer_raw_bytes_match_jax(world_pair):
    ours, theirs = world_pair
    raw = bytes(range(256)) + b"\xff\xfe\x00\x80abc\xe4\xbd"
    toks = ours.encode_bytes(raw)
    assert toks == theirs.encode_bytes(raw)
    assert ours.decode_bytes(toks) == raw
    assert ours.decode(toks) == theirs.decode(toks)


def test_get_tokenizer_picks_by_vocab():
    decode, encode = get_tokenizer("auto", 65536)
    assert decode(encode(TEXTS["ascii"])) == TEXTS["ascii"]
    with pytest.raises(ValueError):
        get_tokenizer("auto", 1234)
    with pytest.raises(ValueError):
        get_tokenizer("nope")


def test_20b_tokenizer_matches_jax():
    pytest.importorskip("tokenizers")
    from rwkv_tpu.utils.tokenizer import get_tokenizer as j_get_tokenizer

    decode, encode = get_tokenizer("auto", 50277)
    j_decode, j_encode = j_get_tokenizer("20B")
    for text in TEXTS.values():
        toks = encode(text)
        assert toks == j_encode(text)
        assert decode(toks) == j_decode(toks)


# -- the tools' loops --------------------------------------------------------


@pytest.fixture(scope="module")
def port_model(fp32_file):
    return RWKVModel(fp32_file, device="cpu")


def test_measure_perplexity_matches_jax(port_model, jax_model):
    tokens = [int(t) for t in np.random.default_rng(6).integers(0, SHAPE[2], 12)]
    ppl, ms = measure_perplexity(port_model, tokens, ignore_first_n=2)
    j_ppl, _ = j_measure_perplexity(jax_model, tokens, ignore_first_n=2)
    assert np.isfinite(ppl) and ms > 0
    assert abs(ppl - j_ppl) <= 1e-5 * j_ppl
    with pytest.raises(ValueError):
        measure_perplexity(port_model, tokens[:3], ignore_first_n=2)


def _recording_tokenizer(seen: list):
    def decode(toks):
        seen.extend(int(t) for t in toks)
        return ""

    return lambda name, n_vocab: (decode, lambda s: [3, 1, 4, 1, 5])


def test_generation_loop_gives_jax_token_stream(fp32_file, port_model, jax_model, monkeypatch,
                                                capsys):
    """The tool's main on both engines, seed 0, 2 generations of 6 tokens:
    the same sampled tokens."""
    ours, theirs = [], []
    monkeypatch.setattr(JGEN, "get_tokenizer", _recording_tokenizer(theirs))
    monkeypatch.setattr(JGEN, "RWKVModel", lambda path: jax_model)
    monkeypatch.setattr(sys, "argv", ["generate", fp32_file, "--seed", "0", "--generations",
                                      "2", "--tokens-per-generation", "6"])
    JGEN.main()
    monkeypatch.setattr(TGEN, "get_tokenizer", _recording_tokenizer(ours))
    TGEN.main([fp32_file, "--seed", "0", "--generations", "2", "--tokens-per-generation", "6",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("--- Generation") == 4 and out.count("ms per token") == 4
    assert len(ours) == 12 and ours == theirs
    streams = TGEN.generate(port_model, "", [3, 1, 4, 1, 5], lambda t: "", 2, 6, 0.8, 0.5,
                            np.random.default_rng(0))
    assert [t for s in streams for t in s] == ours


def test_serve_adapter_matches_jax(fp32_file):
    """_ServeAdapter over ServingModel(f32) on both sides: prefill and two
    decode steps within 1e-5 of the scale; logits come back as numpy."""
    ours = TGEN._ServeAdapter(ServingModel(fp32_file, precision="f32", device="cpu"))
    theirs = JGEN._ServeAdapter(JaxServingModel(fp32_file, precision="f32"))
    assert ours.n_vocab == theirs.n_vocab == SHAPE[2]
    lo, so = ours.eval_sequence_in_chunks([34, 105, 110])
    lj, sj = theirs.eval_sequence_in_chunks([34, 105, 110])
    for t in (None, 32, 116):
        if t is not None:
            lo, so = ours.eval(t, so)
            lj, sj = theirs.eval(t, sj)
        assert isinstance(lo, np.ndarray) and lo.shape == (SHAPE[2],)
        assert np.abs(lo - np.asarray(lj)).max() <= 1e-5 * np.abs(np.asarray(lj)).max()
    assert so["att_xx"].shape == (1, SHAPE[0], SHAPE[1])


def _byte_decode(toks):
    return bytes(int(t) for t in toks).decode("latin-1")


def test_chat_session_snapshot_restore(port_model, jax_model, capsys):
    """A snapshot restored replays the same continuation with a reseeded
    rng, and the session's stream equals JAX's ChatSession's."""
    chat = ChatSession(port_model, _byte_decode, None, seed=7)
    chat.process_tokens([72, 105, 33, 10, 10])
    snap = chat.snapshot()
    first = chat.generate(stop_on_double_newline=False, max_len=6)
    assert chat.tokens == [72, 105, 33, 10, 10] + first
    chat.restore(snap)
    assert chat.tokens == [72, 105, 33, 10, 10]
    chat.rng = np.random.default_rng(7)
    assert chat.generate(stop_on_double_newline=False, max_len=6) == first
    chat.process_tokens([])
    ref = JaxChatSession(jax_model, _byte_decode, None, seed=7)
    ref.process_tokens([72, 105, 33, 10, 10])
    assert ref.generate(stop_on_double_newline=False, max_len=6) == first
    capsys.readouterr()
    assert (PROMPTS_DIR / "English-Chat.json").is_file()
