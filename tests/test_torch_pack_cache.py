"""The mega-pack cache on the CPU: ``ops.megakernel.save_mega_pack`` /
``load_mega_pack`` and ``ServingModel(mega_pack_cache=...)``, the port's
twin of the JAX package's cache (its ``tests/test_megakernel.py``
round trip and serving test).

- Every version's host pack in every form (v7 int8, int4, bf16; v6, v5.1,
  v5.2 and v4 likewise) saves and loads bit for bit, key for key, with
  the scalars and dtypes it had.
- ``ServingModel(..., megakernel=True, mega_pack_cache=path)`` writes the
  file on the first build and reads it (building nothing) on the second,
  with bit-equal decode logits over two tokens; a tensor-parallel mesh
  cuts its shard packs from the loaded pack.
- A file without the port's layout name (the JAX package's own, say), or
  a pack of another model or precision, raises."""

import os

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.models import serve as TSV
from rwkv_tpu_torch.models.serve import ServingModel
from rwkv_tpu_torch.models.synth import synth_config, synth_params
from rwkv_tpu_torch.ops import megakernel as TM
from rwkv_tpu_torch.parallel.sharding import make_mesh

SHAPES = {  # version, L, C, V, S
    "7.0": ("7.0", 2, 128, 256, 32),
    "6.0": ("6.0", 2, 128, 256, 32),
    "5.2": ("5.2", 2, 128, 256, 32),
    "5.1": ("5.1", 2, 128, 256, 32),
    "4.0": ("4.0", 2, 128, 256, 32),
}
BUILD = {7: TM.build_mega_pack, 6: TM.build_mega_pack_v6, 5: TM.build_mega_pack_v5,
         4: TM.build_mega_pack_v4}
FORMS = {"w8a8": dict(quant=True, w4=False), "w4a8": dict(quant=True, w4=True),
         "bf16": dict(quant=False, w4=False)}


def _tree(version: str, seed: int = 3):
    cfg = synth_config(*SHAPES[version])
    kw = {"lora_dim": 32} if version == "7.0" else {}
    return cfg, synth_params(cfg, seed=seed, **kw)


def _assert_same_pack(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("version", list(SHAPES))
def test_pack_save_and_load_bit_exact(tmp_path, version, form):
    cfg, params = _tree(version)
    pack = BUILD[cfg.version_major](params, cfg, **FORMS[form])
    path = tmp_path / "pack.npz"
    TM.save_mega_pack(path, pack)
    loaded = TM.load_mega_pack(path)
    _assert_same_pack(loaded, pack)
    want = {"w8a8": "i8", "w4a8": "i4", "bf16": "bf16"}[form]
    assert TM.mega_pack_mismatch(loaded, cfg, want) is None
    other = next(f for f in ("i8", "i4", "bf16") if f != want)
    assert "form" in TM.mega_pack_mismatch(loaded, cfg, other)


@pytest.mark.parametrize("precision", ["w8a8", "w4a8", "bf16"])
@pytest.mark.parametrize("version", ["7.0", "6.0", "5.2", "4.0"])
def test_serving_model_writes_then_reads_the_cache(tmp_path, monkeypatch, version, precision):
    """The first model builds and writes the pack, the second reads it and
    builds nothing; both decode two tokens to the same bits."""
    cfg, params = _tree(version, seed=47)
    cache = str(tmp_path / "mega.npz")
    a = ServingModel((cfg, params), precision=precision, megakernel=True, device="cpu",
                     mega_pack_cache=cache)
    assert os.path.exists(cache)

    def refuse(*args, **kwargs):
        raise AssertionError("the pack was built again instead of read from the cache")

    for name in ("build_mega_pack", "build_mega_pack_v6", "build_mega_pack_v5",
                 "build_mega_pack_v4"):
        monkeypatch.setattr(TM, name, refuse)
    b = ServingModel((cfg, params), precision=precision, megakernel=True, device="cpu",
                     mega_pack_cache=cache)
    sa, sb = a.init_state(1), b.init_state(1)
    for tok in (3, 77):
        la, sa = a.decode([tok], sa)
        lb, sb = b.decode([tok], sb)
        assert torch.equal(la, lb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_mesh_cuts_its_shard_packs_from_the_cached_pack(tmp_path, monkeypatch):
    cfg, params = _tree("7.0", seed=5)
    cache = str(tmp_path / "mega.npz")
    mesh = make_mesh(1, 2, devices=["cpu"] * 2)
    a = ServingModel((cfg, params), precision="w8a8", mesh=mesh, megakernel=True, device="cpu",
                     mega_pack_cache=cache)
    monkeypatch.setattr(TM, "build_mega_pack", lambda *a, **k: pytest.fail("built again"))
    b = ServingModel((cfg, params), precision="w8a8", mesh=mesh, megakernel=True, device="cpu",
                     mega_pack_cache=cache)
    assert len(b._mega_tp) == 2
    sa, sb = a.init_state(1), b.init_state(1)
    for tok in (3, 77):
        la, sa = a.decode([tok], sa)
        lb, sb = b.decode([tok], sb)
        assert torch.equal(la, lb)


def test_foreign_or_mismatched_cache_refused(tmp_path):
    """A file without the port's layout name (written here as the JAX
    package writes its packs: ``arr::`` arrays and a meta of the pack's
    scalars only), a pack of another precision and one of another version
    all raise instead of being misread."""
    import json

    cfg, params = _tree("7.0")
    pack = TM.build_mega_pack(params, cfg)
    foreign = tmp_path / "foreign.npz"
    arrays = {"arr::" + k: v.float().numpy() for k, v in pack.items()
              if isinstance(v, torch.Tensor)}
    meta = {k: v for k, v in pack.items() if not isinstance(v, torch.Tensor)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(foreign, **arrays)
    with pytest.raises(ValueError, match="layout"):
        TM.load_mega_pack(foreign)
    with pytest.raises(ValueError, match="layout"):
        ServingModel((cfg, params), precision="w8a8", megakernel=True, device="cpu",
                     mega_pack_cache=str(foreign))
    cached = str(tmp_path / "w8a8.npz")
    TM.save_mega_pack(cached, pack)
    with pytest.raises(ValueError, match="form i8"):
        ServingModel((cfg, params), precision="bf16", megakernel=True, device="cpu",
                     mega_pack_cache=cached)
    cfg6, params6 = _tree("6.0")
    with pytest.raises(ValueError, match="version 7"):
        ServingModel((cfg6, params6), precision="w8a8", megakernel=True, device="cpu",
                     mega_pack_cache=cached)
    deeper = synth_config("7.0", 3, 128, 256, 32)
    with pytest.raises(ValueError, match="n_layer 2"):
        TSV._host_pack(synth_params(deeper, seed=1, lora_dim=32), deeper, False, True, cached)


def test_cache_is_ignored_without_megakernel(tmp_path):
    cfg, params = _tree("7.0")
    cache = tmp_path / "unused.npz"
    ServingModel((cfg, params), precision="w8a8", device="cpu", mega_pack_cache=str(cache))
    assert not cache.exists()
