"""The port's ggmf loader and synth-file writer against the JAX package:
``write_synth_ggmf`` files read back by JAX's ``load_params`` to the synth
values exactly, and the port's ``load_params`` equal to JAX's leaf by leaf
for FP32, FP16 and every quantized format of every version."""

import numpy as np
import pytest
import torch

from rwkv_tpu.models.config import detect_version as j_detect_version
from rwkv_tpu.models.loader import load_params as j_load_params
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops.parity import Weight as JWeight
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.io.ggmf import read_ggmf
from rwkv_tpu_torch.io.quantize import quantize_model_file
from rwkv_tpu_torch.models.config import detect_version
from rwkv_tpu_torch.models.loader import load_params
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops.parity import Weight
from rwkv_tpu_torch.tools.synth_file import write_synth_ggmf

VERSIONS = ["4.0", "5.1", "5.2", "6.0", "7.0"]
FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K", "Q5_K"]
SHAPE = (2, 256, 256, 64)  # L, C, V, S


def _flat(tree):
    out = {"emb": tree["emb"], "head": tree["head"]}
    for name in ("ln0", "ln_out"):
        for i, x in enumerate(tree[name]):
            out[f"{name}.{i}"] = x
    for i, b in enumerate(tree["blocks"]):
        for k, v in b.items():
            out[f"blocks.{i}.{k}"] = v
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synth model of every version (seed 3) as FP32 and FP16 files."""
    d = tmp_path_factory.mktemp("loader")
    out = {}
    for version in VERSIONS:
        cfg = synth_config(version, *SHAPE)
        params = synth_params(cfg, seed=3)
        for dtype in ("FP32", "FP16"):
            out[version, dtype] = str(d / f"v{version}-{dtype}.bin")
            write_synth_ggmf(cfg, params, out[version, dtype], dtype)
    return out


@pytest.mark.parametrize("version", VERSIONS)
def test_synth_file_reads_back_exactly_through_jax_loader(files, version):
    jcfg, jp = j_load_params(files[version, "FP32"])
    assert jcfg == j_synth_config(version, *SHAPE)
    ref = _flat(j_synth_params(jcfg, seed=3))
    got = _flat(jp)
    assert got.keys() == ref.keys()
    for k in ref:
        g, r = got[k], ref[k]
        if isinstance(r, JWeight):
            assert isinstance(g, JWeight) and g.kind == "dense", k
            g, r = g.w, r.w
        assert np.asarray(g).shape == np.asarray(r).shape, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=k)


def _assert_leaf_equal(name, got, ref):
    if isinstance(ref, JWeight):
        assert isinstance(got, Weight) and got.kind == ref.kind, name
        assert got.shape == tuple(ref.shape), name
        if ref.kind == "dense":
            assert str(got.w.dtype).split(".")[-1] == str(ref.w.dtype), name
            np.testing.assert_array_equal(got.w.numpy(), np.asarray(ref.w), err_msg=name)
            return
        assert (got.fmt, got.q8_1_act, got.q8_k_act) == (ref.fmt, ref.q8_1_act, ref.q8_k_act), name
        assert got.q.dtype == torch.int8 and got.d.dtype == torch.float32, name
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q), err_msg=name)
        np.testing.assert_array_equal(got.d.numpy(), np.asarray(ref.d), err_msg=name)
        assert (got.m is None) == (ref.m is None), name
        if ref.m is not None:
            np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m), err_msg=name)
        return
    assert isinstance(got, torch.Tensor), name
    ref = np.asarray(ref)
    assert got.dtype == (torch.float16 if ref.dtype == np.float16 else torch.float32), name
    np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)


@pytest.mark.parametrize("fmt", ["FP32", "FP16"] + FORMATS)
@pytest.mark.parametrize("version", VERSIONS)
def test_load_params_equals_jax_leaf_by_leaf(tmp_path, files, version, fmt):
    path = files[version, "FP16" if fmt == "FP16" else "FP32"]
    if fmt not in ("FP32", "FP16"):
        path = str(tmp_path / "q.bin")
        quantize_model_file(files[version, "FP32"], path, fmt, verbose=False)
    cfg, params = load_params(path)
    jcfg, jparams = j_load_params(path)
    assert cfg.__dict__ == jcfg.__dict__
    got, ref = _flat(params), _flat(jparams)
    assert got.keys() == ref.keys()
    for k in ref:
        _assert_leaf_equal(k, got[k], ref[k])
    names = [t.name for t in read_ggmf(path, with_data=False)[1]]
    assert detect_version(names) == j_detect_version(names) == (cfg.version_major, cfg.version_minor)
    if fmt not in ("FP32", "FP16"):
        assert params["blocks"][1]["ffn.key.weight"].fmt == fmt


def _jax_tree_to_numpy(tree):
    """A JAX tree as loaded from a file -> params_from_numpy's input: dense
    weights as arrays, quant ones as {q, d, m, fmt}."""
    def leaf(x):
        if isinstance(x, JWeight):
            if x.kind == "quant":
                return {"q": np.asarray(x.q), "d": np.asarray(x.d),
                        "m": None if x.m is None else np.asarray(x.m), "fmt": x.fmt}
            x = x.w
        return np.asarray(x, np.float32)

    return {"emb": leaf(tree["emb"]), "head": leaf(tree["head"]),
            "ln0": tuple(leaf(x) for x in tree["ln0"]),
            "ln_out": tuple(leaf(x) for x in tree["ln_out"]),
            "blocks": [{k: leaf(v) for k, v in b.items()} for b in tree["blocks"]]}


@pytest.mark.parametrize("fmt", ["Q4_1", "Q5_K"])
def test_params_from_numpy_takes_a_jax_loaded_tree(tmp_path, files, fmt):
    path = str(tmp_path / "q.bin")
    quantize_model_file(files["6.0", "FP32"], path, fmt, verbose=False)
    jcfg, jparams = j_load_params(path)
    cfg, own = load_params(path)
    crossed = _flat(params_from_numpy(cfg, _jax_tree_to_numpy(jparams)))
    own = _flat(own)
    assert crossed.keys() == own.keys()
    for k, v in own.items():
        c = crossed[k]
        if isinstance(v, Weight) and v.kind == "quant":
            assert (c.kind, c.fmt, c.q8_1_act, c.q8_k_act) == (v.kind, v.fmt, v.q8_1_act, v.q8_k_act)
            for f in ("q", "d", "m"):
                a, b = getattr(c, f), getattr(v, f)
                assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), (k, f)
        else:
            dense = v.w if isinstance(v, Weight) else v
            assert torch.equal(c, dense.float()), k
