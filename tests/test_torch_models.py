"""The port's model plumbing against the JAX package: synthetic weights,
state layout and flat round trip, weight conversion, the f32 forward graph,
and the port's import and device rules."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.models import graph as JG
from rwkv_tpu.models import state as JS
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.ops.parity import Weight
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models import graph as TG
from rwkv_tpu_torch.models import state as TS
from rwkv_tpu_torch.models.config import ModelConfig, detect_version
from rwkv_tpu_torch.models.synth import synth_config, synth_params

REPO = Path(__file__).resolve().parent.parent
SMALL = ("7.0", 2, 128, 256, 32)  # version, L, C, V, S (H = 4)


def jax_tree_to_numpy(tree):
    """JAX parameter pytree -> the numpy tree params_from_numpy takes."""
    def leaf(x):
        return np.asarray(x.w if isinstance(x, Weight) else x, np.float32)

    return {
        "emb": leaf(tree["emb"]),
        "ln0": tuple(leaf(x) for x in tree["ln0"]),
        "ln_out": tuple(leaf(x) for x in tree["ln_out"]),
        "head": leaf(tree["head"]),
        "blocks": [{k: leaf(v) for k, v in b.items()} for b in tree["blocks"]],
    }


def _flat_leaves(tree):
    out = {"emb": tree["emb"], "head": tree["head"]}
    for name in ("ln0", "ln_out"):
        for i, x in enumerate(tree[name]):
            out[f"{name}.{i}"] = x
    for i, b in enumerate(tree["blocks"]):
        for k, v in b.items():
            out[f"blocks.{i}.{k}"] = v
    return out


@pytest.mark.parametrize("version", ["4.0", "5.1", "5.2", "6.0", "7.0"])
def test_synth_params_bit_equal_jax(version):
    """Same seed, same numpy draw order: every leaf bit-identical."""
    jc = j_synth_config(version, 2, 64, 96, 16)
    tc = synth_config(version, 2, 64, 96, 16)
    assert jc.__dict__ == tc.__dict__
    ref = _flat_leaves(jax_tree_to_numpy(j_synth_params(jc, seed=5, lora_dim=32)))
    got = _flat_leaves(synth_params(tc, seed=5, lora_dim=32))
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_params_from_numpy_equals_port_synth():
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    converted = _flat_leaves(params_from_numpy(tc, jax_tree_to_numpy(j_synth_params(jc, seed=2, lora_dim=32))))
    own = _flat_leaves(synth_params(tc, seed=2, lora_dim=32))
    assert converted.keys() == own.keys()
    for k in own:
        assert torch.equal(converted[k], own[k]), k


def test_params_from_numpy_rejects_wrong_shapes():
    tc = synth_config(*SMALL)
    tree = _flat_leaves(synth_params(tc, seed=0, lora_dim=32))
    bad = {"emb": np.zeros((10, 128), np.float32), "head": tree["head"].numpy(),
           "ln0": (tree["ln0.0"], tree["ln0.1"]), "ln_out": (tree["ln_out.0"], tree["ln_out.1"]),
           "blocks": [{}, {}]}
    with pytest.raises(ValueError):
        params_from_numpy(tc, bad)


def test_config_and_detect_version_match_jax():
    from rwkv_tpu.models.config import detect_version as j_detect

    names_by_version = [
        ["blocks.0.att.key.weight"],
        ["blocks.0.att.ln_x.weight"],
        ["blocks.0.att.ln_x.weight", "blocks.0.att.gate.weight"],
        ["blocks.0.att.ln_x.weight", "blocks.0.att.time_maa_x"],
        ["blocks.0.att.ln_x.weight", "blocks.0.att.r_k"],
    ]
    for names in names_by_version:
        assert detect_version(names) == j_detect(names)
    cfg = ModelConfig(256, 128, 2, 7, 0, 4, 32)
    assert (cfg.version, cfg.vectors_per_layer, cfg.state_len) == ("7.0", 34, 128 * 34 * 2)


@pytest.mark.parametrize("version", ["4.0", "7.0"])
def test_init_state_and_flat_round_trip_match_jax(version):
    jc, tc = j_synth_config(version, 2, 64, 96, 16), synth_config(version, 2, 64, 96, 16)
    ref, got = JS.init_state(jc), TS.init_state(tc, device="cpu")
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    rng = np.random.default_rng(0)
    flat = rng.standard_normal(tc.state_len).astype(np.float32)
    np.testing.assert_array_equal(TS.state_to_flat(tc, TS.state_from_flat(tc, flat, device="cpu")), flat)
    ref_s, got_s = JS.state_from_flat(jc, flat), TS.state_from_flat(tc, flat, device="cpu")
    for k in ref_s:
        np.testing.assert_array_equal(got_s[k].numpy(), np.asarray(ref_s[k]), err_msg=k)
    np.testing.assert_array_equal(TS.state_to_flat(tc, got_s), JS.state_to_flat(jc, ref_s))


@pytest.mark.parametrize("n_tokens", [1, 7])
def test_f32_forward_matches_jax(n_tokens):
    jc, tc = j_synth_config(*SMALL), synth_config(*SMALL)
    jp = j_synth_params(jc, seed=1, lora_dim=32)
    tp = params_from_numpy(tc, jax_tree_to_numpy(jp))
    rng = np.random.default_rng(n_tokens)
    s0 = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
          for k, v in JS.init_state(jc).items()}
    toks = rng.integers(0, tc.n_vocab, n_tokens).astype(np.int32)
    jl, js = JG.forward(jp, {k: jnp.asarray(v) for k, v in s0.items()}, jnp.asarray(toks), jc)
    tl, ts = TG.forward(tp, {k: torch.from_numpy(v) for k, v in s0.items()},
                        torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def test_wkv7_scan_trace_matches_jax():
    rng = np.random.default_rng(3)
    t, h, s = 5, 2, 8
    ops = [rng.standard_normal((t, h, s)).astype(np.float32) * 0.3 for _ in range(6)]
    ops[1] = np.exp(-np.abs(ops[1]))
    s0 = rng.standard_normal((h, s, s)).astype(np.float32) * 0.2
    jy, jst = JG.wkv7_scan_trace(jnp.asarray(s0), *(jnp.asarray(x) for x in ops))
    ty, tst = TG.wkv7_scan_trace(torch.from_numpy(s0), *(torch.from_numpy(x) for x in ops))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-5, atol=1e-6)


_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
import rwkv_tpu_torch
names = ["rwkv_tpu_torch"] + [m.name for m in pkgutil.walk_packages(rwkv_tpu_torch.__path__, "rwkv_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "rwkv_tpu.")) or m == "rwkv_tpu")
print(len(names), bad)
assert not bad, bad
assert len(names) >= 14, names
for need in ("io", "io.quant", "io.ggmf", "io.quantize", "models.loader", "tools.synth_file",
             "reservoir", "reservoir.reservoir", "reservoir.enhanced", "reservoir.esn",
             "utils.profiling", "native"):
    assert "rwkv_tpu_torch." + need in names, need
assert "optax" not in sys.modules
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_neither_jax_nor_rwkv_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=str(REPO), env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_LAZY_NAMES = r"""
import sys
import rwkv_tpu_torch
assert "rwkv_tpu_torch.models" not in sys.modules
for name in ("RWKVModel", "ServingModel", "ContinuousBatcher", "ReservoirRWKV", "ModelConfig",
             "get_tokenizer"):
    obj = getattr(rwkv_tpu_torch, name)
    assert obj.__name__ == name and obj.__module__.startswith("rwkv_tpu_torch."), obj
try:
    rwkv_tpu_torch.NoSuchName
except AttributeError:
    pass
else:
    raise SystemExit("an unknown name resolved")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rwkv_tpu", "optax"))
assert not bad, bad
print("ok")
"""


def test_top_level_names_resolve_lazily_without_jax():
    out = subprocess.run([sys.executable, "-c", _LAZY_NAMES], cwd=str(REPO), env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr


_DEVICE_CHECK = r"""
import torch
assert not torch.cuda.is_available()
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.state import init_state
from rwkv_tpu_torch.models.synth import synth_config, synth_params
cfg = synth_config("7.0", 1, 64, 64, 32)
p = synth_params(cfg, seed=0, lora_dim=32)
for fn in (lambda: ServingModel((cfg, p), precision="f32"), lambda: init_state(cfg)):
    try:
        fn()
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise SystemExit("an entry point ran without a device instead of raising")
ServingModel((cfg, p), precision="f32", device="cpu")
print("ok")
"""


def test_entry_points_need_cuda_unless_asked_for_cpu():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _DEVICE_CHECK], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
