"""Kernel K9's plain forms (``rwkv_tpu_torch.ops.kernels``: plain, min,
pack4, pack4_min, rowwise) against the JAX package's ``quant_matmul`` run
as its Pallas body in interpret mode and as its XLA path, the serving
weights' construction (``from_weight``, ``quantize_q8_serving``,
``dequant_weight``) bit for bit, and the layers over a file's blocks in
every format against JAX's ``forward_stacked`` (dense leaves in f32, so
every activation stays f32: 1e-4 of the scale).

Band: every output within 1e-5 of ``sum_k |x_k| * |W_nk|`` (f32 sums in
another order). The rowwise form (q8r) follows the TPU kernel, which rounds
x to bf16, so it is held to that band against interpret mode; JAX's XLA
path keeps x in f32, so against it the band adds the bf16 rounding of x,
2^-8 of the same sum. On the CPU JAX's pack4 runs the f32 dequantization
on both its routes (the TPU's decode and big-M routes differ,
``rwkv_tpu/ops/kernels.py:448``), and the port is held to it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.io import quant as JQ
from rwkv_tpu.models import serve as JSV
from rwkv_tpu.models.loader import load_params as j_load_params
from rwkv_tpu.models.state import init_state as j_init_state
from rwkv_tpu.ops import kernels as JK
from rwkv_tpu.ops.parity import Weight as JWeight
from rwkv_tpu_torch.io import quant as TQ
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models import serve as TSV
from rwkv_tpu_torch.models.loader import load_params
from rwkv_tpu_torch.models.state import init_state
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import kernels as TK
from rwkv_tpu_torch.ops.kernels import PackedQuantWeight
from rwkv_tpu_torch.ops.parity import Weight, mm
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

FILE_FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]
ALL = FILE_FORMATS + ["q8", "q8r"]
FORM = {"Q4_0": "pack4", "Q4_1": "pack4_min", "Q5_0": "plain", "Q5_1": "min", "Q8_0": "plain",
        "Q4_K": "min", "Q5_K": "min", "q8": "plain", "q8r": "rowwise"}
K = 256


def _dense(n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    w[0] = 0.0  # an all-zero row
    w[1, :32] = 0.25  # a constant block
    return w


def _pair(fmt, n, k=K, seed=0):
    """(JAX PackedQuantWeight, the port's) of one seeded weight in `fmt`."""
    w = _dense(n, k, seed + n)
    if fmt in ("q8", "q8r"):
        rowwise = fmt == "q8r"
        return (JK.quantize_q8_serving(jnp.asarray(w), rowwise=rowwise),
                TK.quantize_q8_serving(w, rowwise=rowwise, int8_act=False))
    data = TQ.quantize_rows(w, TQ.dtype_from_name(fmt)).tobytes()
    jw = JWeight.from_packed(data, JQ.dtype_from_name(fmt), (n, k))
    tw = Weight.from_packed(data, TQ.dtype_from_name(fmt), (n, k))
    return JK.PackedQuantWeight.from_weight(jw), TK.PackedQuantWeight.from_weight(tw)


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 3.0, (m, 1))).astype(np.float32)
    if m > 1:
        x[-1] = 0.0
    return x


@pytest.mark.parametrize("fmt", ALL)
@pytest.mark.parametrize("n", [256, 195])
def test_dequant_weight_bit_equal_jax(fmt, n):
    jw, tw = _pair(fmt, n)
    assert tw.form == FORM[fmt] and tw.shape == (n, K)
    np.testing.assert_array_equal(TK.dequant_weight(tw).numpy(), np.asarray(JK.dequant_weight(jw)).T)


@pytest.mark.parametrize("fmt", ALL)
@pytest.mark.parametrize("m", [1, 8, 256])
@pytest.mark.parametrize("n", [256, 195])
def test_block_matmul_plain_within_band_of_jax_kernel(fmt, m, n):
    jw, tw = _pair(fmt, n)
    x = _x(m, K, m + n)
    got = TK.quant_matmul(torch.from_numpy(x), tw).numpy()
    assert got.shape == (m, n)
    band = np.abs(x) @ np.abs(TK.dequant_weight(tw).numpy()).T
    ref_kernel = np.asarray(JK.quant_matmul(jnp.asarray(x), jw, force="interpret"))
    ref_xla = np.asarray(JK.quant_matmul(jnp.asarray(x), jw, force="xla"))
    assert ref_kernel.shape == ref_xla.shape == (m, n)
    assert np.all(np.abs(got - ref_kernel) <= 1e-5 * band + 1e-30), fmt
    xla_band = (1e-5 + (2.0 ** -8 if fmt == "q8r" else 0.0)) * band + 1e-30
    assert np.all(np.abs(got - ref_xla) <= xla_band), fmt


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("n", [256, 195])
def test_quantize_q8_serving_bit_equal_jax(rowwise, n):
    w = _dense(n, 128, 5)
    ref = JK.quantize_q8_serving(jnp.asarray(w), rowwise=rowwise)
    got = TK.quantize_q8_serving(torch.from_numpy(w), rowwise=rowwise, int8_act=False)
    assert got.form == ("rowwise" if rowwise else "plain")
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q).T[:n])
    d_ref = np.asarray(ref.d)[0, :n] if rowwise else np.asarray(ref.d).T[:n]
    np.testing.assert_array_equal(got.d.numpy(), d_ref)
    assert got.d.shape == ((n,) if rowwise else (n, 4))


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1"])
def test_from_weight_nibbles_in_ggml_order(fmt):
    """Byte j of a block's 16 bytes holds code j (low) and code j + 16
    (high): the file's own order, not JAX's even/odd interleave."""
    w = _dense(8, 64, 1)
    tw = Weight.from_packed(TQ.quantize_rows(w, TQ.dtype_from_name(fmt)).tobytes(),
                            TQ.dtype_from_name(fmt), (8, 64))
    pw = TK.PackedQuantWeight.from_weight(tw)
    assert pw.q.shape == (8, 32) and pw.signed4 == (fmt == "Q4_0") and pw.pack4
    b = pw.q.numpy().view(np.uint8).reshape(8, 2, 16).astype(np.int32)
    c = tw.q.numpy().astype(np.int32)  # [8, 2, 32]
    np.testing.assert_array_equal(b & 0xF, c[..., :16] & 0xF)
    np.testing.assert_array_equal(b >> 4, c[..., 16:] & 0xF)
    np.testing.assert_array_equal(TK.codes(pw).numpy(), tw.q.numpy().reshape(8, 64))
    if fmt == "Q4_1":
        assert pw.m is not None and torch.equal(pw.m, tw.m)


def test_quant_matmul_on_cpu_launches_nothing_and_keeps_leading_dims():
    _, tw = _pair("Q5_1", 195)
    x = torch.from_numpy(_x(6, K, 3)).reshape(2, 3, K)
    before = dict(TK.quant_matmul.launches_by_form), TK.quant_matmul.launches
    y = mm(x, tw)
    assert y.shape == (2, 3, 195)
    assert (dict(TK.quant_matmul.launches_by_form), TK.quant_matmul.launches) == before
    torch.testing.assert_close(y.reshape(6, 195), TK.block_matmul_plain(x.reshape(6, K), tw),
                               rtol=0, atol=0)


def test_packed_weight_stack_and_layer_keep_the_form():
    ws = [_pair("Q4_1", 64, seed=s)[1] for s in range(3)]
    st = TK.PackedQuantWeight.stack(ws)
    assert st.q.shape == (3, 64, K // 2) and st.m.shape == (3, 64, K // 32)
    assert st.form == "pack4_min" and st.shape == (64, K)
    one = st.map(lambda t: t[1])
    for f in ("q", "d", "m"):
        assert torch.equal(getattr(one, f), getattr(ws[1], f))
    np.testing.assert_array_equal(TK.dequant_weight(st)[2].numpy(), TK.dequant_weight(ws[2]).numpy())


def test_w8a8_defaults_and_form_errors():
    w = _dense(64, 64, 2)
    assert TK.quantize_q8_serving(w).form == "w8a8"
    with pytest.raises(ValueError):
        TK.quantize_q8_serving(w, rowwise=False, int8_act=True)
    with pytest.raises(ValueError):
        TK.PackedQuantWeight.from_weight(Weight(kind="dense", w=torch.from_numpy(w)))


VERSIONS = ["4.0", "5.1", "5.2", "6.0", "7.0"]
PROMPT = np.random.default_rng(0).integers(0, 256, 16)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got.numpy() - ref).max() / max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(scope="module")
def fp32_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("block_matmul")
    out = {}
    for version in VERSIONS:
        cfg = synth_config(version, 2, 256, 256, 64)
        out[version] = str(d / f"v{version}.bin")
        write_synth_ggmf(cfg, synth_params(cfg, seed=1), out[version])
    return out


@pytest.mark.parametrize("fmt", FILE_FORMATS)
@pytest.mark.parametrize("version", VERSIONS)
def test_file_blocks_with_f32_leaves_match_jax(fp32_files, tmp_path, version, fmt):
    """The layers on a file's own blocks (K9's plain forms, every format)
    with the dense leaves in f32: logits and state within 1e-4 of JAX's
    forward_stacked, for a 16-token chunk and a single token."""
    path = str(tmp_path / f"{fmt}.bin")
    quantize_model_file(fp32_files[version], path, fmt, verbose=False)
    (jc, jp), (tc, tp) = j_load_params(path), load_params(path)
    jparams = JSV.stack_layer_params(jp, jc, jnp.float32, "keep-quant")
    tparams = TSV.stack_layer_params(tp, tc, torch.float32, "keep-quant", "cpu")
    assert isinstance(tparams["blocks"]["ffn.key.weight"], PackedQuantWeight)
    for n in (16, 1):
        jl, js = JSV.forward_stacked(jparams, j_init_state(jc), jnp.asarray(PROMPT[:n], jnp.int32), jc)
        tl, ts = TSV.forward_stacked(tparams, init_state(tc, "cpu"), torch.from_numpy(PROMPT[:n]), tc)
        assert _rel(tl, jl) < 1e-4
        for k in js:
            assert _rel(ts[k], js[k]) < 1e-4, k
