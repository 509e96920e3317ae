"""The port's native host library (``rwkv_tpu_torch.native``, built from
``csrc/host/rwkv_native.cpp`` with g++) against the JAX package's
pure-Python data plane, on the CPU: block codecs, ggmf header and tensor
scan, file requantization, the World trie tokenizer and the quantize
tool, all byte-equal."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rwkv_tpu.io import quant as JQ
from rwkv_tpu.io.ggmf import read_ggmf
from rwkv_tpu.io.quantize import quantize_model_file as j_quantize_model_file
from rwkv_tpu.utils.world_tokenizer import WorldTokenizer
from rwkv_tpu_torch.io.quantize import quantize_model_file as t_quantize_model_file
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.tools import quantize as quantize_tool
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

REPO = Path(__file__).resolve().parent.parent
FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]
TEXTS = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "Hello 你好 こんにちは привет مرحبا 🙂",
    "code: x = f(y) ** 2\n\ttabs\r\n",
]


def _forget_loaded(native):
    """Drop the worker's loaded library and cached default tokenizer, so
    that which quantizer and tokenizer other tests get does not depend on
    what ran before them."""
    from rwkv_tpu_torch.utils import world_tokenizer as W

    native._lib = None
    W._default.cache_clear()


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The library, built into a temporary directory: a build in the
    checkout's ``_build/`` would switch the tools and the default World
    tokenizer of every later test and run to the native code."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    from rwkv_tpu_torch import native

    build_dir = tmp_path_factory.mktemp("native_build")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD_DIR", build_dir)
        _forget_loaded(native)
        path = native.build()
        assert path.exists() and path.parent == build_dir
        assert native.is_available()
        yield native
        _forget_loaded(native)


@pytest.fixture(scope="module")
def fp32_file(tmp_path_factory):
    cfg = synth_config("5.2", 2, 256, 256, 64)
    path = tmp_path_factory.mktemp("native") / "v52-FP32.bin"
    write_synth_ggmf(cfg, synth_params(cfg, seed=4), str(path))
    return path


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_rows_byte_equal_jax(native, fmt):
    dt = JQ.dtype_from_name(fmt)
    x = (np.random.default_rng(0).standard_normal(16 * 1024) * 3).astype(np.float32)
    np.testing.assert_array_equal(native.quantize_rows(x, int(dt), n_threads=3),
                                  JQ.quantize_rows(x, dt).view(np.uint8))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_rows_byte_equal_jax(native, fmt):
    dt = JQ.dtype_from_name(fmt)
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    packed = JQ.quantize_rows(x, dt)
    np.testing.assert_array_equal(native.dequantize_rows(packed, int(dt), x.size),
                                  JQ.dequantize_rows(packed, dt, (x.size,)).reshape(-1))


def test_header_and_scan_match_jax_reader(native, fp32_file):
    hdr = native.read_header(str(fp32_file))
    jhdr, tensors = read_ggmf(str(fp32_file), with_data=False)
    assert (hdr["n_vocab"], hdr["n_embed"], hdr["n_layer"]) == (256, 256, 2)
    assert hdr["magic"] == jhdr.magic and hdr["version"] == jhdr.version
    infos = native.scan_tensors(str(fp32_file))
    assert [i["name"] for i in infos] == [t.name for t in tensors]
    for info, t in zip(infos, tensors):
        assert tuple(info["shape"]) == tuple(t.shape) and info["nbytes"] == t.nbytes, t.name
        assert info["dtype"] == int(t.dtype), t.name
    with pytest.raises(RuntimeError):
        native.read_header(str(fp32_file.parent / "missing.bin"))


@pytest.mark.parametrize("fmt", ["Q5_1", "Q8_0", "Q4_K"])
def test_quantize_model_file_byte_equal_jax(native, fp32_file, tmp_path, fmt):
    jax_out, nat_out = tmp_path / "jax.bin", tmp_path / "native.bin"
    j_quantize_model_file(str(fp32_file), str(jax_out), fmt, verbose=False)
    orig, new = native.quantize_model_file(str(fp32_file), str(nat_out),
                                           int(JQ.dtype_from_name(fmt)))
    assert nat_out.read_bytes() == jax_out.read_bytes()
    assert 0 < new < orig


def test_quantize_model_file_from_fp16_byte_equal_jax(native, tmp_path):
    cfg = synth_config("7.0", 2, 256, 256, 64)
    src = tmp_path / "v7-FP16.bin"
    write_synth_ggmf(cfg, synth_params(cfg, seed=4), str(src), "FP16")
    j_quantize_model_file(str(src), str(tmp_path / "jax.bin"), "Q4_0", verbose=False)
    native.quantize_model_file(str(src), str(tmp_path / "native.bin"), 2)  # Q4_0
    assert (tmp_path / "native.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_world_tokenizer_matches_jax(native):
    py, nat = WorldTokenizer(), native.NativeWorldTokenizer()
    for s in TEXTS:
        assert nat.encode(s) == py.encode(s), s
        assert nat.decode(py.encode(s)) == py.decode(py.encode(s)) == s
    raw = bytes(range(256))
    assert nat.encode_bytes(raw) == py.encode_bytes(raw)
    assert nat.decode_bytes(nat.encode_bytes(raw)) == raw


def test_world_tokenizer_prefers_the_native_trie(native):
    from rwkv_tpu_torch.utils import world_tokenizer as W

    W._default.cache_clear()
    try:
        decode, encode = W.get_world_tokenizer_v20230424()
        assert isinstance(decode.__self__, native.NativeWorldTokenizer)
        assert encode(TEXTS[2]) == W.WorldTokenizer().encode(TEXTS[2])
    finally:
        W._default.cache_clear()


def test_quantize_tool_native_and_python_byte_identical(native, fp32_file, tmp_path, capsys):
    outs = {}
    for name, extra in (("native", []), ("python", ["--python"])):
        outs[name] = tmp_path / f"{name}.bin"
        quantize_tool.main([str(fp32_file), str(outs[name]), "Q5_1", "--quiet", *extra])
        assert "Quantized in" in capsys.readouterr().out
    assert outs["native"].read_bytes() == outs["python"].read_bytes()
    t_quantize_model_file(str(fp32_file), str(tmp_path / "port.bin"), "Q5_1", verbose=False)
    assert outs["python"].read_bytes() == (tmp_path / "port.bin").read_bytes()


def test_module_builds_from_the_command_line(native):
    out = subprocess.run([sys.executable, "-m", "rwkv_tpu_torch.native",
                          "--build-dir", str(native.BUILD_DIR)], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and str(native.lib_path()) in out.stdout, out.stderr


def test_missing_sources_fall_back_to_python(monkeypatch, tmp_path, fp32_file, capsys):
    """An install without the C++ sources (or the library) reports the
    library unavailable, and the default World tokenizer and the quantize
    tool take the Python code instead of raising."""
    from rwkv_tpu_torch import native
    from rwkv_tpu_torch.utils import world_tokenizer as W

    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    _forget_loaded(native)
    try:
        assert not native.is_available()
        decode, encode = W.get_world_tokenizer_v20230424()
        assert type(decode.__self__) is W.WorldTokenizer
        assert decode(encode(TEXTS[2])) == TEXTS[2]
        out = tmp_path / "tool.bin"
        quantize_tool.main([str(fp32_file), str(out), "Q5_1", "--quiet"])
        assert "Quantized in" in capsys.readouterr().out
        t_quantize_model_file(str(fp32_file), str(tmp_path / "port.bin"), "Q5_1", verbose=False)
        assert out.read_bytes() == (tmp_path / "port.bin").read_bytes()
    finally:
        _forget_loaded(native)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty_build")
    assert not native.is_available()
