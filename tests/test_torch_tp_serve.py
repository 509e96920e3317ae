"""``ServingModel(..., mesh=make_mesh(1, 2, ...), megakernel=True)``: the
port's TP decode route against the JAX package's on the conftest's virtual
CPU mesh (v7 and v6; w8a8, w4a8, bf16; v5 and v4 in test_torch_tp_v45.py),
and the mesh's rules: prefill and B>1 decode stay per-op on the mesh's
first device, a model whose shapes do not split over the shards (v4 / v5
too) raises, a device other than the mesh's raises."""

import jax
import numpy as np
import pytest
import torch

from rwkv_tpu.models.serve import ServingModel as JServingModel
from rwkv_tpu.models.synth import synth_config as j_synth_config
from rwkv_tpu.models.synth import synth_params as j_synth_params
from rwkv_tpu.parallel.sharding import make_mesh as j_make_mesh
from rwkv_tpu_torch.convert import params_from_numpy
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel_tp as TT
from rwkv_tpu_torch.parallel.sharding import make_mesh
from test_torch_megakernel import jax_tree_to_numpy

# logits against JAX over 3 decode steps: bf16 within REL of the scale
# (test_megakernel_tp.py's bands, v7 1e-4, v6 1e-3); the int forms within
# 2e-2 element-wise (activation codes may flip at .5 boundaries) with equal
# argmax
REL = {"7.0": 1e-4, "6.0": 1e-3}


def _cpu_mesh(tp: int = 2):
    return make_mesh(1, tp, devices=["cpu"] * tp)


def _models(version: str, precision: str):
    jc, tc = j_synth_config(version, 2, 128, 256, 32), synth_config(version, 2, 128, 256, 32)
    kw = {"lora_dim": 32} if version == "7.0" else {}
    jp = j_synth_params(jc, seed=3, **kw)
    tpar = params_from_numpy(tc, jax_tree_to_numpy(jp))
    jm = JServingModel((jc, jp), precision=precision, mesh=j_make_mesh(1, 2, jax.devices()[:2]),
                       megakernel=True)
    tm = ServingModel((tc, tpar), precision=precision, mesh=_cpu_mesh(), megakernel=True,
                      device="cpu")
    return jm, tm


@pytest.mark.parametrize("version", ["7.0", "6.0"])
@pytest.mark.parametrize("precision", ["w8a8", "w4a8", "bf16"])
def test_mesh_decode_matches_jax(version, precision, monkeypatch):
    """B=1 decode through the TP step (counted) from init_state over three
    tokens: logits and state against JAX's TP route."""
    jm, tm = _models(version, precision)
    assert jm._mega_tp is not None and len(tm._mega_tp) == 2 and tm._mega is None
    step = "tp_decode_step_v6" if version == "6.0" else "tp_decode_step"
    calls = []
    real = getattr(TT, step)
    monkeypatch.setattr(TT, step, lambda *a: calls.append(1) or real(*a))
    sj, st = jm.init_state(1), tm.init_state(1)
    for tok in (3, 77, 200):
        lj, sj = jm.decode(np.array([tok], np.int32), sj)
        lt, st = tm.decode(np.array([tok]), st)
        lj = np.asarray(lj)
        assert lt.shape == (1, 256)
        if precision == "bf16":
            assert np.abs(lt.numpy() - lj).max() / np.abs(lj).max() < REL[version]
        else:
            np.testing.assert_allclose(lt.numpy(), lj, rtol=2e-2, atol=2e-2)
        assert int(lt.argmax()) == int(lj.argmax())
        np.testing.assert_allclose(st["heads"].numpy(), np.asarray(sj["heads"]), rtol=2e-2,
                                   atol=2e-2)
    assert len(calls) == 3


@pytest.fixture(scope="module")
def v7_tree():
    cfg = synth_config("7.0", 2, 128, 256, 32)
    return cfg, synth_params(cfg, seed=5, lora_dim=32)


def test_mesh_prefill_and_batches_run_per_op_on_first_device(v7_tree):
    """Under a mesh, prefill and B>1 decode are the per-op path of the
    model without one (bit for bit), and the state stays unsharded."""
    ref = ServingModel(v7_tree, precision="w8a8", device="cpu")
    tpm = ServingModel(v7_tree, precision="w8a8", mesh=_cpu_mesh(), megakernel=True)
    assert tpm.device == torch.device("cpu") and tpm.mesh.tp == 2
    prompt = [5, 9, 200, 3, 7, 11, 1]
    lr, sr = ref.prefill(prompt)
    lt, st = tpm.prefill(prompt)
    assert torch.equal(lr, lt) and all(torch.equal(sr[k], st[k]) for k in sr)
    batch = {k: v.repeat(3, *([1] * (v.ndim - 1))) for k, v in sr.items()}
    lr, sr3 = ref.decode(np.array([1, 2, 3]), batch)
    lt, st3 = tpm.decode(np.array([1, 2, 3]), batch)
    assert torch.equal(lr, lt) and all(torch.equal(sr3[k], st3[k]) for k in sr3)
    assert st["heads"].shape == (1, 2, 4, 32, 32)


def test_mesh_b1_decode_tracks_single_device_kernels(v7_tree):
    """The TP route and the single-device decode route (K3's plain version)
    after the same prefill: JAX's TP-vs-single-chip band (1.5e-1 of the
    scale, argmax in the top 5); they differ by the per-shard activation
    scales on out and fv."""
    single = ServingModel(v7_tree, precision="w8a8", megakernel=True, device="cpu")
    tpm = ServingModel(v7_tree, precision="w8a8", mesh=_cpu_mesh(), megakernel=True)
    _, s1 = single.prefill([4, 8, 15, 16])
    _, s2 = tpm.prefill([4, 8, 15, 16])
    for tok in (23, 42):
        l1, s1 = single.decode(np.array([tok]), s1)
        l2, s2 = tpm.decode(np.array([tok]), s2)
        scale = float(l1.abs().max())
        assert float((l2 - l1).abs().max()) / scale < 1.5e-1
        assert int(l2.argmax()) in torch.topk(l1[0], 5).indices.tolist()


@pytest.mark.parametrize("version", ["5.2", "4.0"])
def test_mesh_megakernel_v4_v5_raise(version):
    """A v4 / v5 model whose C and F do not split over tp=3 shards raises
    with K14's / K15's shape error before any pack is built."""
    cfg = synth_config(version, 2, 128, 256, 32)
    name = "K14 / K13" if version == "4.0" else "K15 / K13"
    with pytest.raises(NotImplementedError, match=f"{name}: .*split over tp=3"):
        ServingModel((cfg, synth_params(cfg, seed=0)), precision="w8a8", mesh=_cpu_mesh(3),
                     megakernel=True)


def test_mesh_with_another_device_raises(v7_tree):
    with pytest.raises(ValueError, match="not the mesh's first device"):
        ServingModel(v7_tree, precision="w8a8", mesh=_cpu_mesh(), megakernel=True,
                     device="cuda")
    mesh = make_mesh(1, 2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="not the mesh's first device"):
        ServingModel(v7_tree, precision="w8a8", mesh=mesh, megakernel=True, device="cpu")


def test_mesh_shapes_checked_before_packing(v7_tree):
    with pytest.raises(NotImplementedError, match="split over tp=3"):
        ServingModel(v7_tree, precision="w8a8", mesh=_cpu_mesh(3), megakernel=True)
