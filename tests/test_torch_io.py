"""The port's copies of the ggmf codecs, file format and quantizer
(``rwkv_tpu_torch.io``) against the JAX package's ``rwkv_tpu.io``: byte for
byte."""

import numpy as np
import pytest

from rwkv_tpu.io import ggmf as j_ggmf
from rwkv_tpu.io import quant as JQ
from rwkv_tpu.io.quantize import quantize_model_file as j_quantize_model_file
from rwkv_tpu_torch.io import ggmf, quant as TQ
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]


def _rows(seed: int = 0) -> np.ndarray:
    """[16, 512] f32 rows with zeros, constants, ties and extremes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 512)).astype(np.float32)
    x[0] = 0.0                                              # all zeros
    x[1] = 0.75                                             # constant rows
    x[2] = -3.0
    x[3] = np.round(rng.standard_normal(512) * 8) / 2       # ties at .5
    x[4] = rng.integers(-16, 16, 512).astype(np.float32)    # integer grid
    x[5, ::2], x[5, 1::2] = 6.0e4, -6.0e4                   # near the fp16 limit
    x[6] = rng.standard_normal(512).astype(np.float32) * 1e-6   # fp16 subnormal scales
    x[7] = np.abs(x[7])                                     # all positive (min > 0)
    x[8] = -np.abs(x[8])                                    # all negative
    x[9, :] = 0.0
    x[9, 17] = 5.0                                          # one spike per block
    x[10] *= 1e3
    return x


@pytest.mark.parametrize("fmt", FORMATS + ["FP32", "FP16"])
def test_quantize_rows_bytes_equal_jax(fmt):
    x = _rows()
    got = TQ.quantize_rows(x, TQ.dtype_from_name(fmt))
    ref = JQ.quantize_rows(x, JQ.dtype_from_name(fmt))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("fmt", FORMATS)
def test_unpack_and_dequantize_equal_jax(fmt):
    x = _rows(1)[:, :256] * 0.3
    data = JQ.quantize_rows(x, JQ.dtype_from_name(fmt))
    got = TQ.unpack_blocks(data, TQ.dtype_from_name(fmt))
    ref = JQ.unpack_blocks(data, JQ.dtype_from_name(fmt))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(TQ.dequantize_rows(data, TQ.dtype_from_name(fmt), x.shape),
                                  JQ.dequantize_rows(data, JQ.dtype_from_name(fmt), x.shape))
    assert TQ.quant_offset(TQ.dtype_from_name(fmt)) == JQ.quant_offset(JQ.dtype_from_name(fmt))


def test_dtype_tables_equal_jax():
    assert TQ.QUANT_FORMATS == JQ.QUANT_FORMATS
    assert TQ.UNSUPPORTED_FORMATS == JQ.UNSUPPORTED_FORMATS
    for name in ("FP32", "FP16") + JQ.QUANT_FORMATS:
        t, j = TQ.dtype_from_name(name), JQ.dtype_from_name(name)
        assert int(t) == int(j) and TQ.is_quantized(t) == JQ.is_quantized(j)
        assert TQ.tensor_nbytes(t, 8, 512) == JQ.tensor_nbytes(j, 8, 512)
        assert TQ.dtype_name(t) == JQ.dtype_name(j)


def test_ggmf_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 64)).astype(np.float32)
    tensors = [
        ggmf.GgmfTensor("emb.weight", TQ.GgmlDType.FP32, a.shape, a.tobytes()),
        ggmf.GgmfTensor("blocks.0.att.x_rwkvag", TQ.GgmlDType.FP32, (6, 1, 64),
                        rng.standard_normal((6, 1, 64)).astype(np.float32).tobytes()),
        ggmf.GgmfTensor("head.weight", TQ.GgmlDType.Q5_1, a.shape,
                        TQ.quantize_rows(a, TQ.GgmlDType.Q5_1).tobytes()),
        ggmf.GgmfTensor("ln_out.weight", TQ.GgmlDType.FP16, (64,),
                        a[0].astype(np.float16).tobytes()),
    ]
    header = ggmf.GgmfHeader(ggmf.GGMF_MAGIC, ggmf.FILE_VERSION_1, 4, 64, 1, TQ.GgmlDType.Q5_1)
    path = tmp_path / "m.bin"
    ggmf.write_ggmf(str(path), header, tensors)
    h2, t2 = ggmf.read_ggmf(str(path))
    hj, tj = j_ggmf.read_ggmf(str(path))
    assert h2 == header and (hj.n_vocab, hj.n_embed, hj.n_layer) == (4, 64, 1)
    assert [(t.name, t.dtype, t.shape, t.data) for t in t2] == [
        (t.name, t.dtype, t.shape, t.data) for t in tensors]
    assert [(t.name, int(t.dtype), t.shape, t.data) for t in tj] == [
        (t.name, int(t.dtype), t.shape, t.data) for t in tensors]
    np.testing.assert_array_equal(t2[0].to_f32(), a)
    _, headers_only = ggmf.read_ggmf(str(path), with_data=False)
    assert [t.name for t in headers_only] == [t.name for t in tensors]
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\0" * 24)
    with pytest.raises(ValueError):
        ggmf.read_ggmf(str(bad))


@pytest.fixture(scope="module")
def fp32_files(tmp_path_factory):
    """FP32 and FP16 synth files of v7 (C=256: every K-format row fits) and
    v6 (its decay LoRA up-projection has rows of 64: the K-formats fall
    back to Q5_0 / Q5_1 there)."""
    d = tmp_path_factory.mktemp("io")
    out = {}
    for version in ("7.0", "6.0"):
        cfg = synth_config(version, 2, 256, 256, 64)
        params = synth_params(cfg, seed=4)
        for dtype in ("FP32", "FP16"):
            out[version, dtype] = str(d / f"v{version}-{dtype}.bin")
            write_synth_ggmf(cfg, params, out[version, dtype], dtype)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("version", ["7.0", "6.0"])
def test_quantize_model_file_bytes_equal_jax(tmp_path, fp32_files, version, fmt):
    src = fp32_files[version, "FP32"]
    got, ref = tmp_path / "port.bin", tmp_path / "jax.bin"
    sizes = quantize_model_file(src, str(got), fmt, verbose=False)
    assert sizes == j_quantize_model_file(src, str(ref), fmt, verbose=False)
    assert got.read_bytes() == ref.read_bytes()
    _, tensors = ggmf.read_ggmf(str(got), with_data=False)
    kinds = {t.name: TQ.dtype_name(t.dtype) for t in tensors}
    assert kinds["emb.weight"] == kinds["head.weight"] == "FP32"
    assert kinds["blocks.1.att.key.weight"] == fmt
    if version == "7.0":
        assert kinds["blocks.1.att.w1"] == kinds["blocks.1.att.r_k"] == "FP32"
        assert kinds["blocks.1.att.x_rwkvag"] == "FP32"
    else:
        fallback = {"Q4_K": "Q5_0", "Q5_K": "Q5_1"}.get(fmt, fmt)
        assert kinds["blocks.1.att.time_decay_w2"] == fallback
        assert kinds["blocks.1.att.time_decay"] == kinds["blocks.1.att.time_maa_w2"] == "FP32"


@pytest.mark.parametrize("fmt", ["Q5_1", "Q4_K"])
def test_quantize_fp16_file_bytes_equal_jax(tmp_path, fp32_files, fmt):
    src = fp32_files["7.0", "FP16"]
    got, ref = tmp_path / "port.bin", tmp_path / "jax.bin"
    quantize_model_file(src, str(got), fmt, verbose=False)
    j_quantize_model_file(src, str(ref), fmt, verbose=False)
    assert got.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("fmt", ["Q2_K", "FP16"])
def test_quantize_model_file_refuses_what_jax_refuses(tmp_path, fp32_files, fmt):
    src = fp32_files["7.0", "FP32"]
    with pytest.raises(ValueError):
        quantize_model_file(src, str(tmp_path / "a.bin"), fmt, verbose=False)
    with pytest.raises(ValueError):
        j_quantize_model_file(src, str(tmp_path / "b.bin"), fmt, verbose=False)
